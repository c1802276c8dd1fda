"""Architecture configuration of the LMs: ``repro.configs.base`` in the port.

``LayerSpec``, ``ArchConfig`` and ``reduced`` are copies of ``repro``'s, field
for field, so ``dataclasses.asdict`` of a config is the same in both
packages. The dry-run's ``ShapeConfig`` cells are not copied: they describe
XLA lowerings, which have no PyTorch meaning. ``attn_block_q``/
``attn_block_k`` are TPU tile sizes, which the CUDA flash kernels accept and
do not use.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Literal, Optional, Sequence

Mixer = Literal["attn", "local", "mamba", "none"]
Ffn = Literal["dense", "moe", "none"]


@dataclass(frozen=True)
class LayerSpec:
    """One layer inside the repeating layer pattern."""

    mixer: Mixer = "attn"
    ffn: Ffn = "dense"


@dataclass(frozen=True)
class ArchConfig:
    # -- identity ----------------------------------------------------------
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm", "vision"]
    source: str = ""  # provenance note: [source; verified-tier]

    # -- transformer backbone ---------------------------------------------
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0  # 0 -> d_model // num_heads
    d_ff: int = 0
    vocab_size: int = 0
    act: str = "silu"  # swiglu gating act
    norm_eps: float = 1e-6
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False

    # -- layer pattern (repeats to num_layers) ------------------------------
    pattern: Sequence[LayerSpec] = (LayerSpec(),)
    sliding_window: int = 0  # for mixer == "local"

    # -- MoE ----------------------------------------------------------------
    num_experts: int = 0
    experts_per_tok: int = 0
    moe_d_ff: int = 0  # per-expert hidden dim (0 -> d_ff)
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2
    moe_dispatch_blocks: int = 32

    # -- SSM (Mamba-2 SSD) ---------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # -- encoder / decoder ---------------------------------------------------
    encoder_layers: int = 0  # >0 => encoder-decoder (cross-attn in decoder)
    encoder_seq: int = 0  # fixed encoder length

    # -- modality frontend ---------------------------------------------------
    frontend: Optional[Literal["audio", "vision"]] = None
    frontend_tokens: int = 0  # patch/frame embeddings prepended to sequence
    frontend_dim: int = 0  # raw embedding dim before projection (0 -> d_model)

    # -- attention implementation --------------------------------------------
    # "auto": the plain full attention. "flash": the flash op (the CUDA
    # kernels on the card, their plain versions on the CPU).
    attn_impl: Literal["auto", "flash"] = "auto"
    attn_block_q: int = 128
    attn_block_k: int = 128

    # -- numerics -------------------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # ------------------------------------------------------------------ utils
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def layer_specs(self) -> tuple[LayerSpec, ...]:
        """Pattern repeated/truncated to exactly ``num_layers`` entries."""
        pat = tuple(self.pattern)
        reps = -(-self.num_layers // len(pat))
        return (pat * reps)[: self.num_layers]

    @property
    def num_periods(self) -> int:
        """Full pattern repetitions (stacked); remainder layers are not."""
        return self.num_layers // len(self.pattern)

    @property
    def remainder_specs(self) -> tuple[LayerSpec, ...]:
        """Trailing layers beyond the stacked periods (e.g. gemma3: 62 = 10*6+2)."""
        return tuple(self.pattern)[: self.num_layers % len(self.pattern)]

    def param_count(self) -> int:
        """Analytic parameter count."""
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.frontend:
            total += (self.frontend_dim or d) * d
        specs = list(self.layer_specs)
        if self.is_encdec:
            specs += [LayerSpec("attn", "dense")] * self.encoder_layers
        for s in specs:
            total += 2 * d  # norms
            if s.mixer in ("attn", "local"):
                total += d * hd * (n_q + 2 * n_kv) + n_q * hd * d
            elif s.mixer == "mamba":
                di, ns = self.d_inner, self.ssm_state
                total += d * (2 * di + 2 * self.ssm_groups * ns + self.ssm_heads)
                total += di * self.ssm_conv + di * d + self.ssm_heads * 2
            if s.ffn == "dense" and self.d_ff:
                total += 3 * d * self.d_ff
            elif s.ffn == "moe":
                eff = self.moe_d_ff or self.d_ff
                total += self.num_experts * 3 * d * eff + d * self.num_experts
        if self.is_encdec:  # cross-attention in every decoder layer
            total += self.num_layers * (d * hd * (n_q + 2 * n_kv) + n_q * hd * d)
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.num_experts:
            return self.param_count()
        eff = self.moe_d_ff or self.d_ff
        inactive = sum((self.num_experts - self.experts_per_tok) * 3 * self.d_model * eff
                       for s in self.layer_specs if s.ffn == "moe")
        return self.param_count() - inactive


def reduced(cfg: ArchConfig, *, seq: int = 64) -> ArchConfig:
    """Tiny same-family variant for CPU tests (``repro``'s rule)."""
    pat = tuple(cfg.pattern)
    changes = dict(
        name=cfg.name + "-reduced",
        num_layers=2 * len(pat),
        d_model=64,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=512,
        sliding_window=min(cfg.sliding_window, seq // 2) if cfg.sliding_window else 0,
    )
    if cfg.num_experts:
        changes.update(num_experts=8, experts_per_tok=min(cfg.experts_per_tok, 2), moe_d_ff=32)
    if cfg.ssm_state:
        changes.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    if cfg.encoder_layers:
        changes.update(encoder_layers=2, encoder_seq=24)
    if cfg.frontend:
        changes.update(frontend_tokens=8, frontend_dim=32)
    return dataclasses.replace(cfg, **changes)
