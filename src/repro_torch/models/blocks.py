"""Layer assembly of ``repro.models.blocks``: the pre-norm (mixer, ffn) layer.

The ``("attn", "dense")`` layer of the llama-style LMs and gemma3's
``("local", "dense")`` sliding-window layer are ported, over a full
sequence (``apply_layer``), over a prompt that fills the decode cache
(``apply_layer_prefill``) and for one token against it
(``apply_layer_decode``); ``layer_cache`` makes the layer's empty cache: a
full-attention layer holds ``max_len`` slots, a local layer a ring of
min(w, ``max_len``) slots where position p lies at slot p mod w, and
``decode_snapshot`` saves the slots a retried decode must find again. Other
mixers (mamba), FFNs (moe) and cross-attention raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models import attention as attn
from repro_torch.models.layers import mlp, mlp_def, rmsnorm, rmsnorm_def, rope


def _check(spec: LayerSpec) -> None:
    if spec.mixer not in ("attn", "local") or spec.ffn != "dense":
        raise NotImplementedError(f"layer ({spec.mixer}, {spec.ffn}) is not ported yet; only "
                                  "(attn, dense) and (local, dense) are")


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
    """The layer's empty decode cache: k and v, (B, slots, NKV, D) zeros, with
    ``max_len`` slots, or for a local layer the ring's min(w, max_len)."""
    _check(spec)
    slots = min(cfg.sliding_window or max_len, max_len) if spec.mixer == "local" else max_len
    shape = (batch, slots, cfg.num_kv_heads, cfg.resolved_head_dim)
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
    """The causal layer over the prompt; its k and v are written into
    ``cache`` in place: the first S slots, or for a local layer whose ring
    of w slots the prompt fills, the last w positions at slot = pos mod w
    (``repro``'s roll by S mod w). Returns (x, cache)."""
    _check(spec)
    q, k, v = _attn_in(cfg, p, x, positions)
    o = attn.dispatch_attention(cfg, q, k, v, mixer=spec.mixer, causal=True)
    S, w = k.shape[1], cache["k"].shape[1]
    if spec.mixer == "local" and S >= w:
        shift = S % w  # position S − w, the oldest kept, belongs at slot (S − w) mod w
        cache["k"].copy_(torch.roll(k[:, S - w:], shift, dims=1))
        cache["v"].copy_(torch.roll(v[:, S - w:], shift, dims=1))
    else:
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
    x = x + attn.out_proj(p["mixer"], o, x.dtype)
    return x + mlp(p["ffn"], rmsnorm(p["norm2"], x, cfg.norm_eps)), cache


def _slot(spec: LayerSpec, cache: dict, pos):
    """Where position ``pos`` (an int, or a tensor of them) lives in the
    layer's cache: slot pos, or in a local layer's ring slot pos mod w."""
    return pos % cache["k"].shape[1] if spec.mixer == "local" else pos


def decode_snapshot(spec: LayerSpec, cache: dict, pos: int, n: int) -> Callable[[], None]:
    """Save what ``n`` decode steps from ``pos`` overwrite in ``cache`` that
    those steps still read, and return the callable that writes it back. In
    a local layer's ring that is slots (pos + j) mod w for j < n, which hold
    the keys of positions pos + j − w; a full-attention layer's slots from
    ``pos`` on are masked until written, so it saves nothing."""
    if spec.mixer != "local":
        return lambda: None
    w = cache["k"].shape[1]
    slots = _slot(spec, cache, torch.arange(pos, pos + min(n, w), device=cache["k"].device))
    saved = [(t, t.index_select(1, slots)) for t in (cache["k"], cache["v"])]

    def restore():
        for t, vals in saved:
            t.index_copy_(1, slots, vals)

    return restore


def apply_layer_decode(
    cfg: ArchConfig,
    spec: LayerSpec,
    p: dict,
    x: torch.Tensor,  # (B, 1, d)
    cache: dict,
    pos: int,  # the incoming token's position
) -> tuple[torch.Tensor, dict]:
    """One token: its k and v are written into slot ``pos`` of ``cache`` in
    place (no copy of the cache), then it attends to slots 0..pos; a local
    layer writes slot pos mod w of its ring and attends to the ring."""
    _check(spec)
    positions = torch.full((x.shape[0], 1), pos, device=x.device)
    q, k, v = _attn_in(cfg, p, x, positions)
    slot = _slot(spec, cache, pos)
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    o = attn.decode_attention(q, cache["k"], cache["v"], pos + 1, ring=spec.mixer == "local")
    x = x + attn.out_proj(p["mixer"], o, x.dtype)
    return x + mlp(p["ffn"], rmsnorm(p["norm2"], x, cfg.norm_eps)), cache
