"""vit-s16 — ViT image classifier for attention-path attributions.

The paper evaluates IG on InceptionV3/ImageNet; ``paper_cnn`` reproduces that
setup on a convnet. This config is the *attention* counterpart: a ViT-S/16
(ImageNet-scale defaults) whose patch-level attributions exercise the flash
attention op (``kernels/flash_attention``) on the explain hot path.
``reduced_vit()`` is the CPU-smoke variant (32x32 images, 4x4 patches -> 64
patch tokens, 10 classes) trained on the same synthetic task as the
benchmark CNN.

Duck-typing: ``VitConfig`` exposes the subset of ``ArchConfig`` fields that
``models/attention.py`` consumes (d_model, num_heads, num_kv_heads,
resolved_head_dim, attn_impl, attn block sizes), so the attention dispatch
and the flash kernels serve both model families unchanged.

A copy of ``repro.configs.vit``; ``attn_block_q``/``attn_block_k`` are TPU
tile sizes, which the CUDA flash kernels accept and do not use.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Literal


@dataclass(frozen=True)
class VitConfig:
    name: str = "vit-s16"
    family: str = "vision"
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    num_classes: int = 1000
    num_layers: int = 12
    d_model: int = 384
    num_heads: int = 6
    d_ff: int = 1536
    norm_eps: float = 1e-6
    # attention implementation (see configs/base.py ArchConfig)
    attn_impl: Literal["auto", "flash"] = "auto"
    attn_block_q: int = 128
    attn_block_k: int = 128
    param_dtype: str = "float32"
    compute_dtype: str = "float32"

    @property
    def num_kv_heads(self) -> int:  # ViT is MHA: no GQA grouping
        return self.num_heads

    @property
    def resolved_head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size**2 * self.channels

    # unused by ViT but read by shared attention/layer helpers
    sliding_window: int = 0


CONFIG = VitConfig()


def reduced_vit(cfg: VitConfig = CONFIG) -> VitConfig:
    """CPU-smoke variant: 8x8 grid of 4x4 patches = 64 patch tokens."""
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        image_size=32,
        patch_size=4,
        num_classes=10,
        num_layers=2,
        d_model=64,
        num_heads=4,
        d_ff=128,
    )
