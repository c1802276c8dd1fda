"""Layer assembly of ``repro.models.blocks``: the pre-norm (mixer, ffn) layer.

Only the ``("attn", "dense")`` layer is ported — the one llama-style LMs
stack. Other mixers (local, mamba) and FFNs (moe), cross-attention and the
prefill/decode paths raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models import attention as attn
from repro_torch.models.layers import mlp, mlp_def, rmsnorm, rmsnorm_def, rope


def _check(spec: LayerSpec) -> None:
    if (spec.mixer, spec.ffn) != ("attn", "dense"):
        raise NotImplementedError(
            f"layer ({spec.mixer}, {spec.ffn}) is not ported yet; only (attn, dense) is")


def layer_def(cfg: ArchConfig, spec: LayerSpec) -> dict:
    _check(spec)
    return {
        "norm1": rmsnorm_def(cfg.d_model),
        "mixer": attn.attn_def(cfg),
        "norm2": rmsnorm_def(cfg.d_model),
        "ffn": mlp_def(cfg.d_model, cfg.d_ff),
    }


def apply_layer(
    cfg: ArchConfig,
    spec: LayerSpec,
    p: dict,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    causal: bool = True,
    kv_len: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full-sequence layer: x + attn(norm1(x)), then + mlp(norm2(·)).
    ``repro`` also returns a MoE auxiliary loss, which is 0 for this layer."""
    _check(spec)
    dt = x.dtype
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    q, k, v = attn.qkv(p["mixer"], h, dt)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = attn.dispatch_attention(cfg, q, k, v, mixer=spec.mixer, causal=causal, kv_len=kv_len)
    x = x + attn.out_proj(p["mixer"], o, dt)
    return x + mlp(p["ffn"], rmsnorm(p["norm2"], x, cfg.norm_eps))
