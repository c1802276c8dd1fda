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
saves what a retried decode must find again. A decoder layer of an
encoder-decoder (whisper) adds cross-attention between the mixer and the
FFN: ``norm_x``, then ``cross``'s query over the encoder output's keys and
values, non-causal and plain PyTorch (``repro`` computes it outside any
Pallas kernel); its cache holds those keys and values as ``xk``/``xv``,
written by the prefill and read by every decode step.
``apply_layer_with_aux`` also returns ``repro``'s MoE auxiliary loss, which
feeds the training loss only; ``apply_layer`` drops it. A layer without a
mixer raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models import attention as attn, moe as moe_mod, ssm
from repro_torch.models.layers import mlp, mlp_def, rmsnorm, rmsnorm_def, rope
from repro_torch.sharding.context import block, gathered, on_shards, per_head, seq_sharded


def _check(spec: LayerSpec) -> None:
    if spec.mixer not in ("attn", "local", "mamba") or spec.ffn not in ("dense", "moe", "none"):
        raise NotImplementedError(f"layer ({spec.mixer}, {spec.ffn}) is not ported; the mixers are "
                                  "attn, local and mamba, the FFNs dense, moe and none")


def layer_def(cfg: ArchConfig, spec: LayerSpec, *, cross: bool = False) -> dict:
    _check(spec)
    d = {"norm1": rmsnorm_def(cfg.d_model),
         "mixer": ssm.ssm_def(cfg) if spec.mixer == "mamba" else attn.attn_def(cfg)}
    if cross:
        d["norm_x"] = rmsnorm_def(cfg.d_model)
        d["cross"] = attn.attn_def(cfg, cross=True)
    if spec.ffn != "none":
        d["norm2"] = rmsnorm_def(cfg.d_model)
        d["ffn"] = moe_mod.moe_def(cfg) if spec.ffn == "moe" else mlp_def(cfg.d_model, cfg.d_ff)
    return d


def _ffn_aux(cfg: ArchConfig, spec: LayerSpec, p: dict, x: torch.Tensor
             ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(x + ffn(norm2(x)) for a dense or MoE FFN, x for none; the MoE's f32
    auxiliary loss, None for the others)."""
    if spec.ffn == "none":
        return x, None
    h = rmsnorm(p["norm2"], x, cfg.norm_eps)
    if spec.ffn == "moe":
        y, aux = moe_mod.moe(p["ffn"], h, cfg)
        return x + y, aux
    return x + mlp(p["ffn"], h), None


def _ffn(cfg: ArchConfig, spec: LayerSpec, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x + ffn(norm2(x)) for a dense or MoE FFN; x for none."""
    return _ffn_aux(cfg, spec, p, x)[0]


def _cross_kv(p: dict, enc_out: Optional[torch.Tensor], dtype):
    """The cross-attention's keys and values (B, S_enc, NKV, D) of the
    encoder output; None without one (the explain path over the token
    stream) or without a cross-attention."""
    if enc_out is None or "cross" not in p:
        return None
    return tuple(attn._project(enc_out, p["cross"][n].to(dtype)) for n in ("wk", "wv"))


def _cross(cfg: ArchConfig, p: dict, x: torch.Tensor, kv) -> torch.Tensor:
    """x + cross-attention of norm_x(x) over the encoder's (k, v), every key
    (``repro``'s ``full_attention(causal=False)``); x when ``kv`` is None."""
    if kv is None:
        return x
    h = rmsnorm(p["norm_x"], x, cfg.norm_eps)
    q = attn._project(h, p["cross"]["wq"].to(x.dtype))
    o = attn.full_attention(q, *kv, causal=False)
    return x + attn.out_proj(p["cross"], o, x.dtype)


def _attn_in(cfg: ArchConfig, p: dict, x: torch.Tensor, positions: torch.Tensor):
    """norm1, the projections and RoPE: q, k, v of the layer's input."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    q, k, v = attn.qkv(p["mixer"], h, x.dtype)
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta), v


def apply_layer_with_aux(
    cfg: ArchConfig,
    spec: LayerSpec,
    p: dict,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    causal: bool = True,
    enc_out: Optional[torch.Tensor] = None,
    kv_len: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Full-sequence layer: x + mixer(norm1(x)), then with ``enc_out`` and
    a cross-attention + cross(norm_x(·)), then + ffn(norm2(·)). ``kv_len``
    reaches the self-attention only (an SSM is causal). Returns (x, the MoE
    layer's f32 auxiliary loss, or None for a layer without one), as
    ``repro``'s ``apply_layer`` returns (x, aux)."""
    _check(spec)
    p = gathered(p)
    if spec.mixer == "mamba":
        x = x + ssm.ssm_forward(p["mixer"], rmsnorm(p["norm1"], x, cfg.norm_eps), cfg, cfg.norm_eps)
    else:
        q, k, v = _attn_in(cfg, p, x, positions)
        o = attn.dispatch_attention(cfg, q, k, v, mixer=spec.mixer, causal=causal, kv_len=kv_len)
        x = x + attn.out_proj(p["mixer"], o, x.dtype)
    return _ffn_aux(cfg, spec, p, _cross(cfg, p, x, _cross_kv(p, enc_out, x.dtype)))


def apply_layer(cfg: ArchConfig, spec: LayerSpec, p: dict, x: torch.Tensor, **kw) -> torch.Tensor:
    """``apply_layer_with_aux`` without the auxiliary loss: the explain and
    serve paths' layer."""
    return apply_layer_with_aux(cfg, spec, p, x, **kw)[0]


def layer_cache(cfg: ArchConfig, spec: LayerSpec, batch: int, max_len: int, dtype,
                device="cuda", *, kv_slots: int = 0) -> dict:
    """The layer's empty decode cache: k and v, (B, slots, KH, D) zeros, with
    ``max_len`` slots, or for a local layer the ring's min(w, max_len); KH is
    ``repro``'s TP-expanded head count max(NKV, ``kv_slots``) (each KV head
    repeated KH/NKV times, so a tensor-parallel shard holds the heads its
    query heads read), NKV when ``kv_slots`` is 0. For a mamba layer
    ``ssm.ssm_init_cache``'s state and conv tail. A decoder layer of an
    encoder-decoder adds ``xk``/``xv``, (B, encoder_seq, NKV, D), for its
    cross-attention."""
    _check(spec)
    if spec.mixer == "mamba":
        cache = ssm.ssm_init_cache(cfg, batch, dtype, device)
    else:
        slots = min(cfg.sliding_window or max_len, max_len) if spec.mixer == "local" else max_len
        kh = max(cfg.num_kv_heads, kv_slots or cfg.num_kv_heads)
        shape = (batch, slots, kh, cfg.resolved_head_dim)
        cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device)}
    if cfg.is_encdec:
        shape = (batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.resolved_head_dim)
        cache["xk"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["xv"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def apply_layer_prefill(
    cfg: ArchConfig,
    spec: LayerSpec,
    p: dict,
    x: torch.Tensor,
    cache: dict,
    *,
    positions: torch.Tensor,
    enc_out: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, dict]:
    """The causal layer over the prompt; its k and v are written into
    ``cache`` in place: the first S slots, or for a local layer whose ring
    of w slots the prompt fills, the last w positions at slot = pos mod w
    (``repro``'s roll by S mod w); a mamba layer writes its last state and
    conv tail; a cross-attention writes the keys and values of ``enc_out``
    into ``xk``/``xv``. Returns (x, cache)."""
    _check(spec)
    p = gathered(p)
    if spec.mixer == "mamba":
        y, st = ssm.ssm_forward_with_state(p["mixer"], rmsnorm(p["norm1"], x, cfg.norm_eps), cfg,
                                           cfg.norm_eps)
        for key in ("state", "conv"):
            cache[key].copy_(st[key])
        x = x + y
    else:
        q, k, v = _attn_in(cfg, p, x, positions)
        o = attn.dispatch_attention(cfg, q, k, v, mixer=spec.mixer, causal=True)
        k, v = _to_slots(k, cache), _to_slots(v, cache)
        S, w = k.shape[1], cache["k"].shape[1]
        if spec.mixer == "local" and S >= w:
            shift = S % w  # position S − w, the oldest kept, belongs at slot (S − w) mod w
            for c, t in ((cache["k"], k), (cache["v"], v)):  # rolled on each rank's rows and heads
                c.copy_(on_shards(lambda t: torch.roll(t, shift, dims=1), t[:, S - w:]))
        else:
            cache["k"][:, :S] = k
            cache["v"][:, :S] = v
        x = x + attn.out_proj(p["mixer"], o, x.dtype)
    kv = _cross_kv(p, enc_out, x.dtype)
    if kv is not None:
        cache["xk"].copy_(kv[0])
        cache["xv"].copy_(kv[1])
    return _ffn(cfg, spec, p, _cross(cfg, p, x, kv)), cache


def _to_slots(t: torch.Tensor, cache: dict) -> torch.Tensor:
    """Keys or values (B, S, NKV, D) repeated to the cache's head count (a
    ``kv_slots`` cache holds each KV head KH/NKV times; ``repro``'s
    ``expand_kv``)."""
    slots = cache["k"].shape[2]
    return t if t.shape[2] == slots else attn.expand_kv(t, slots)


def _write_seq_sharded(c: torch.Tensor, slot: int, new: torch.Tensor) -> None:
    """``c[:, slot] = new`` on a cache (B, S, KH, D) whose sequence is
    sharded (the long-context cells): the rank holding the slot writes its
    local shard in place, and no rank gathers the cache. ``new`` (B, KH, D)
    has the cache's head layout (``qkv`` pins both by the KV heads)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, pl = c.device_mesh, tuple(c.placements)
    s0, sl = block(c.shape, mesh, pl, 1)
    if s0 <= slot < s0 + sl:
        npl = tuple(Replicate() if p == Shard(1) else Shard(p.dim - (p.dim > 1)) if p.is_shard() else p for p in pl)
        c.to_local()[:, slot - s0] = new.redistribute(mesh, npl).to_local()


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
    until written, so it saves nothing. A cross-attention's ``xk``/``xv``
    are written by the prefill only, never by a decode step, so nothing of
    them is saved."""
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
    mamba layer advances its state and conv tail in place; a
    cross-attention reads the prefill's ``xk``/``xv``."""
    _check(spec)
    p = gathered(p)
    if spec.mixer == "mamba":
        y, cache = ssm.ssm_decode_step(p["mixer"], rmsnorm(p["norm1"], x, cfg.norm_eps), cache, cfg,
                                       cfg.norm_eps)
        x = x + y
    else:
        positions = torch.full((x.shape[0], 1), pos, device=x.device)
        q, k, v = _attn_in(cfg, p, x, positions)
        slot = _slot(spec, cache, pos)
        if seq_sharded(cache["k"]):
            for c, t in ((cache["k"], k), (cache["v"], v)):
                _write_seq_sharded(c, slot, _to_slots(t, cache)[:, 0])
            o = attn.decode_attention_seq_sharded(q, cache["k"], cache["v"], pos + 1, ring=spec.mixer == "local")
        else:
            cache["k"][:, slot] = _to_slots(k, cache)[:, 0]
            cache["v"][:, slot] = _to_slots(v, cache)[:, 0]
            o = per_head(lambda q, k, v: attn.decode_attention(q, k, v, pos + 1, ring=spec.mixer == "local"),
                         q, cache["k"], cache["v"])
        x = x + attn.out_proj(p["mixer"], o, x.dtype)
    kv = (cache["xk"], cache["xv"]) if "xk" in cache else None
    return _ffn(cfg, spec, p, _cross(cfg, p, x, kv)), cache
