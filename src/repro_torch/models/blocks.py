"""Layer assembly of ``repro.models.blocks``: the pre-norm (mixer, ffn) layer.

Only the ``("attn", "dense")`` layer is ported — the one llama-style LMs
stack — over a full sequence (``apply_layer``), over a prompt that fills
the decode cache (``apply_layer_prefill``) and for one token against it
(``apply_layer_decode``); ``layer_cache`` makes the layer's empty cache.
Other mixers (local, mamba) and FFNs (moe) and cross-attention raise
``NotImplementedError``.
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


def _attn_in(cfg: ArchConfig, p: dict, x: torch.Tensor, positions: torch.Tensor):
    """norm1, the projections and RoPE: q, k, v of the layer's input."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    q, k, v = attn.qkv(p["mixer"], h, x.dtype)
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


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
    q, k, v = _attn_in(cfg, p, x, positions)
    o = attn.dispatch_attention(cfg, q, k, v, mixer=spec.mixer, causal=causal, kv_len=kv_len)
    x = x + attn.out_proj(p["mixer"], o, x.dtype)
    return x + mlp(p["ffn"], rmsnorm(p["norm2"], x, cfg.norm_eps))


def layer_cache(cfg: ArchConfig, spec: LayerSpec, batch: int, max_len: int, dtype,
                device="cuda") -> dict:
    """The layer's empty decode cache: k and v, (B, max_len, NKV, D) zeros."""
    _check(spec)
    shape = (batch, max_len, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def apply_layer_prefill(
    cfg: ArchConfig,
    spec: LayerSpec,
    p: dict,
    x: torch.Tensor,
    cache: dict,
    *,
    positions: torch.Tensor,
) -> tuple[torch.Tensor, dict]:
    """The causal layer over the prompt; its k and v are written into the
    first S slots of ``cache`` in place. Returns (x, cache)."""
    _check(spec)
    q, k, v = _attn_in(cfg, p, x, positions)
    o = attn.dispatch_attention(cfg, q, k, v, mixer=spec.mixer, causal=True)
    S = k.shape[1]
    cache["k"][:, :S] = k
    cache["v"][:, :S] = v
    x = x + attn.out_proj(p["mixer"], o, x.dtype)
    return x + mlp(p["ffn"], rmsnorm(p["norm2"], x, cfg.norm_eps)), cache


def apply_layer_decode(
    cfg: ArchConfig,
    spec: LayerSpec,
    p: dict,
    x: torch.Tensor,  # (B, 1, d)
    cache: dict,
    pos: int,  # the incoming token's position
) -> tuple[torch.Tensor, dict]:
    """One token: its k and v are written into slot ``pos`` of ``cache`` in
    place (no copy of the cache), then it attends to slots 0..pos."""
    _check(spec)
    positions = torch.full((x.shape[0], 1), pos, device=x.device)
    q, k, v = _attn_in(cfg, p, x, positions)
    cache["k"][:, pos] = k[:, 0]
    cache["v"][:, pos] = v[:, 0]
    o = attn.decode_attention(q, cache["k"], cache["v"], pos + 1)
    x = x + attn.out_proj(p["mixer"], o, x.dtype)
    return x + mlp(p["ffn"], rmsnorm(p["norm2"], x, cfg.norm_eps)), cache
