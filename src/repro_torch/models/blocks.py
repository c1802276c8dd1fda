"""Layer assembly of ``repro.models.blocks``: the pre-norm (mixer, ffn) layer.

Mixers: full attention (``attn``), gemma3's sliding-window attention
(``local``) and the Mamba-2 SSD mixer (``mamba``, ``models.ssm``). FFNs: the
dense SwiGLU (``dense``), the mixture of experts (``moe``, ``models.moe``)
and none (mamba2's layers). Each layer runs over a full sequence
(``apply_layer``), over a prompt that fills the decode cache
(``apply_layer_prefill``) and for one token against it
(``apply_layer_decode``); ``layer_cache`` makes the layer's empty cache: a
full-attention layer holds ``max_len`` slots, a local layer a ring of
min(w, ``max_len``) slots where position p lies at slot p mod w, a mamba
layer its f32 state and its conv's last W − 1 inputs; ``decode_snapshot``
saves what a retried decode must find again. ``repro``'s MoE auxiliary
loss is not returned (it only feeds the training loss, not ported yet). A
layer without a mixer raises ``NotImplementedError``; cross-attention (the
encoder-decoder) is not ported.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models import attention as attn, moe as moe_mod, ssm
from repro_torch.models.layers import mlp, mlp_def, rmsnorm, rmsnorm_def, rope


def _check(spec: LayerSpec) -> None:
    if spec.mixer not in ("attn", "local", "mamba") or spec.ffn not in ("dense", "moe", "none"):
        raise NotImplementedError(f"layer ({spec.mixer}, {spec.ffn}) is not ported; the mixers are "
                                  "attn, local and mamba, the FFNs dense, moe and none")


def layer_def(cfg: ArchConfig, spec: LayerSpec) -> dict:
    _check(spec)
    d = {"norm1": rmsnorm_def(cfg.d_model),
         "mixer": ssm.ssm_def(cfg) if spec.mixer == "mamba" else attn.attn_def(cfg)}
    if spec.ffn != "none":
        d["norm2"] = rmsnorm_def(cfg.d_model)
        d["ffn"] = moe_mod.moe_def(cfg) if spec.ffn == "moe" else mlp_def(cfg.d_model, cfg.d_ff)
    return d


def _ffn(cfg: ArchConfig, spec: LayerSpec, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x + ffn(norm2(x)) for a dense or MoE FFN; x for none."""
    if spec.ffn == "none":
        return x
    h = rmsnorm(p["norm2"], x, cfg.norm_eps)
    return x + (moe_mod.moe(p["ffn"], h, cfg)[0] if spec.ffn == "moe" else mlp(p["ffn"], h))


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
    """Full-sequence layer: x + mixer(norm1(x)), then + ffn(norm2(·)).
    ``kv_len`` reaches attention only (an SSM is causal). ``repro`` also
    returns the MoE auxiliary loss, which is not returned here."""
    _check(spec)
    if spec.mixer == "mamba":
        x = x + ssm.ssm_forward(p["mixer"], rmsnorm(p["norm1"], x, cfg.norm_eps), cfg, cfg.norm_eps)
    else:
        q, k, v = _attn_in(cfg, p, x, positions)
        o = attn.dispatch_attention(cfg, q, k, v, mixer=spec.mixer, causal=causal, kv_len=kv_len)
        x = x + attn.out_proj(p["mixer"], o, x.dtype)
    return _ffn(cfg, spec, p, x)


def layer_cache(cfg: ArchConfig, spec: LayerSpec, batch: int, max_len: int, dtype,
                device="cuda") -> dict:
    """The layer's empty decode cache: k and v, (B, slots, NKV, D) zeros, with
    ``max_len`` slots, or for a local layer the ring's min(w, max_len); for
    a mamba layer ``ssm.ssm_init_cache``'s state and conv tail."""
    _check(spec)
    if spec.mixer == "mamba":
        return ssm.ssm_init_cache(cfg, batch, dtype, device)
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
    (``repro``'s roll by S mod w); a mamba layer writes its last state and
    conv tail. Returns (x, cache)."""
    _check(spec)
    if spec.mixer == "mamba":
        y, st = ssm.ssm_forward_with_state(p["mixer"], rmsnorm(p["norm1"], x, cfg.norm_eps), cfg,
                                           cfg.norm_eps)
        for key in ("state", "conv"):
            cache[key].copy_(st[key])
        return _ffn(cfg, spec, p, x + y), cache
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
    return _ffn(cfg, spec, p, x), cache


def _slot(spec: LayerSpec, cache: dict, pos):
    """Where position ``pos`` (an int, or a tensor of them) lives in the
    layer's cache: slot pos, or in a local layer's ring slot pos mod w."""
    return pos % cache["k"].shape[1] if spec.mixer == "local" else pos


def decode_snapshot(spec: LayerSpec, cache: dict, pos: int, n: int) -> Callable[[], None]:
    """Save what ``n`` decode steps from ``pos`` overwrite in ``cache`` that
    those steps still read, and return the callable that writes it back. In
    a local layer's ring that is slots (pos + j) mod w for j < n, which hold
    the keys of positions pos + j − w; a mamba layer's state and conv tail,
    which every step overwrites, whole (1.5 MB of f32 state a row on
    mamba2); a full-attention layer's slots from ``pos`` on are masked
    until written, so it saves nothing."""
    if spec.mixer == "mamba":
        saved = [(t, t.clone()) for t in (cache["state"], cache["conv"])]

        def restore():
            for t, vals in saved:
                t.copy_(vals)

        return restore
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
    layer writes slot pos mod w of its ring and attends to the ring; a
    mamba layer advances its state and conv tail in place."""
    _check(spec)
    if spec.mixer == "mamba":
        y, cache = ssm.ssm_decode_step(p["mixer"], rmsnorm(p["norm1"], x, cfg.norm_eps), cache, cfg,
                                       cfg.norm_eps)
        return _ffn(cfg, spec, p, x + y), cache
    positions = torch.full((x.shape[0], 1), pos, device=x.device)
    q, k, v = _attn_in(cfg, p, x, positions)
    slot = _slot(spec, cache, pos)
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    o = attn.decode_attention(q, cache["k"], cache["v"], pos + 1, ring=spec.mixer == "local")
    x = x + attn.out_proj(p["mixer"], o, x.dtype)
    return _ffn(cfg, spec, p, x), cache
