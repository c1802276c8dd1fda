"""GQA attention of ``repro.models.attention``: projections, full, blocked,
sliding-window, decode, dispatch.

Layouts: q (B, S, NQ, D), k/v (B, S, NKV, D), grouped as NQ = NKV · G;
projection weights as in ``repro`` (``wq`` (d, NQ, D), ``wo`` (NQ, D, d)).

``dispatch_attention`` sends a local layer of a sliding-window config to
``local_attention`` whatever ``attn_impl`` says (``repro``'s order), then
``attn_impl="flash"`` to the port's flash op (the CUDA kernels on the card,
their plain versions on the CPU), an unmasked sequence longer than
``BLOCK_THRESHOLD`` to ``blocked_attention`` (the online-softmax Q-block ×
K-block loop, never the (S, S) scores) and every other call to
``full_attention``. ``local_attention`` masks the full scores up to 2w
tokens and above that attends each w-block to itself and the block before
it. ``decode_attention`` takes one query token against the static decode
cache, or with ``ring`` against a local layer's ring of w slots (slot =
position mod w). ``repro`` computes all but the flash op outside any
Pallas kernel, so they are plain PyTorch here, on the card too.
``repro``'s costing-mode branch (which unrolls scans for XLA's cost
analysis) has no counterpart: the port's loops are Python loops, which the
dry run counts op by op. ``qkv`` pins the heads to the tensor-parallel
axis (``sharding.context.constrain``; a no-op off the dry run's meshes).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import ParamDef
from repro_torch.sharding.context import block, combine, constrain, from_local, per_head

NEG_INF = -1e30
BLOCK_THRESHOLD = 4096  # longer unmasked sequences take blocked_attention, as in repro


def attn_def(cfg, *, cross: bool = False) -> dict:
    """``repro``'s ``attn_def``: the projections at fan-in scale (``wq``'s
    fan-in is d·H, ``repro``'s rule). A decoder layer's cross-attention
    (``cross``) has the same shapes: its k and v project the encoder's
    output."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": ParamDef((d, cfg.num_heads, hd), axes=("embed", "heads", "head_dim")),
        "wk": ParamDef((d, cfg.num_kv_heads, hd), axes=("embed", "kv_heads", "head_dim")),
        "wv": ParamDef((d, cfg.num_kv_heads, hd), axes=("embed", "kv_heads", "head_dim")),
        "wo": ParamDef((cfg.num_heads, hd, d), axes=("heads", "head_dim", "embed")),
    }


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) · (d, H, D) -> (B, S, H, D), one matrix product. Its
    flat (H·D) output is pinned whole heads to a rank before it is split
    (``constrain`` by the head count; DTensor cannot unflatten a head
    divided across ranks, where XLA's reshape relayouts)."""
    d, H, D = w.shape
    y = constrain(x @ w.reshape(d, H * D), "batch", "seq", "model", sizes=(*x.shape[:-1], H))
    return y.unflatten(-1, (H, D))


def _tensor_parallel(w: torch.Tensor) -> bool:
    """Whether ``w`` is a DTensor split on the mesh's "model" dim."""
    return hasattr(w, "placements") and any(
        p.is_shard() for n, p in zip(w.device_mesh.mesh_dim_names, w.placements) if n == "model")


def qkv(p: dict, x: torch.Tensor, dtype) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B, S, NQ, D), k and v (B, S, NKV, D) in ``dtype``, heads pinned
    to the tensor-parallel axis (KV heads replicated when indivisible)."""
    split = [_tensor_parallel(p[n]) for n in ("wq", "wk", "wv")]
    # where some projections are split on the tensor-parallel axis and some
    # whole, each split one's input gradient (pending a sum) is reduced on its
    # own: DTensor's versions add a pending and a whole gradient differently
    ins = [constrain(x, "batch", "seq", None) if s and not all(split) else x for s in split]
    q, k, v = (_project(h, p[n].to(dtype)) for h, n in zip(ins, ("wq", "wk", "wv")))
    q = constrain(q, "batch", "seq", "model", None)
    k = constrain(k, "batch", "seq", "model", None)
    v = constrain(v, "batch", "seq", "model", None)
    return q, k, v


def out_proj(p: dict, o: torch.Tensor, dtype) -> torch.Tensor:
    """(B, S, NQ, D) -> (B, S, d)."""
    H, D, d = p["wo"].shape
    return constrain(o.flatten(-2) @ p["wo"].to(dtype).reshape(H * D, d), "batch", "seq", None)


def expand_kv(k: torch.Tensor, target_heads: int) -> torch.Tensor:
    """Repeat KV heads (B, S, NKV, D) up to ``target_heads``, each kv head
    h // G serving query heads h."""
    if k.shape[2] >= target_heads:
        return k
    return torch.repeat_interleave(k, target_heads // k.shape[2], dim=2)


def full_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
    window: int = 0,
    kv_len: Optional[torch.Tensor] = None,  # (B,) valid K lengths (ragged batch)
) -> torch.Tensor:
    """Reference attention; materializes the (Sq, Sk) scores in f32 and
    softmaxes them, probabilities cast to q.dtype. Query i sits at
    position ``q_offset + i``; with ``window`` a key more than ``window − 1``
    positions behind its query is masked. Rows with no valid key softmax
    over the NEG_INF floor (uniform), as in ``repro``."""
    Sq, NQ, D = q.shape[1], q.shape[2], q.shape[3]
    Sk = k.shape[1]
    ke, ve = expand_kv(k, NQ), expand_kv(v, NQ)
    s = torch.einsum("bqhd,bkhd->bhqk", q * (D**-0.5), ke).float()
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window:
        mask &= qpos[:, None] - kpos[None, :] < window
    mask = mask[None, None]
    if kv_len is not None:  # per-row ragged mask: (B, 1, Sq, Sk)
        mask = mask & (kpos[None, :] < kv_len.reshape(-1, 1))[:, None, None, :]
    a = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", a, ve)


def blocked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    block_q: int = 1024,
    block_k: int = 1024,
) -> torch.Tensor:
    """Flash-style attention in plain PyTorch: a loop over Q blocks and, in
    each, over K blocks with a running (max, sum, acc) in f32; peak memory
    O(block_q · block_k) a head. Causal K blocks wholly past a Q block are
    skipped: ``repro``'s scan adds exactly 0 for them (p = 0, correction
    1), so the values are the same."""
    B, Sq, NQ, D = q.shape
    Sk = k.shape[1]
    bq, bk = min(block_q, Sq), min(block_k, Sk)
    if Sq % bq or Sk % bk:
        raise ValueError(f"blocked_attention needs whole blocks: Sq={Sq} by {bq}, Sk={Sk} by {bk}")
    ke, ve = expand_kv(k, NQ), expand_kv(v, NQ)
    out = torch.empty_like(q)
    for q0 in range(0, Sq, bq):
        qs = q[:, q0:q0 + bq] * (D**-0.5)
        m = torch.full((B, NQ, bq), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, NQ, bq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, NQ, bq, D), dtype=torch.float32, device=q.device)
        for k0 in range(0, Sk, bk):
            if causal and k0 > q0 + bq - 1:
                break
            s = torch.einsum("bqhd,bkhd->bhqk", qs, ke[:, k0:k0 + bk]).float()
            if causal:
                qpos = q0 + torch.arange(bq, device=q.device)
                kpos = k0 + torch.arange(bk, device=q.device)
                s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(q.dtype), ve[:, k0:k0 + bk]).float()
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, q0:q0 + bq] = o.transpose(1, 2).to(q.dtype)
    return out


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, window: int
                    ) -> torch.Tensor:
    """Causal sliding-window attention. Up to 2w tokens it is
    ``full_attention`` with the window mask. Above, each w-block of queries
    attends to the 2w keys of the block before it and its own, under a band
    mask (causal and within the window; the first block's zero "previous"
    block is masked by key position ≥ 0): O(S · 2w) scores, never (S, S).
    Raises ``ValueError`` above 2w tokens unless S is a multiple of w
    (``repro`` asserts it; nothing is padded)."""
    B, S, NQ, D = q.shape
    w = window
    if S <= 2 * w:
        return full_attention(q, k, v, causal=True, window=w)
    if S % w:
        raise ValueError(f"local_attention over {S} > 2w tokens needs S a multiple of the "
                         f"window w={w}")
    nb = S // w

    def ext(x):  # (B, S, H, D) -> (B, nb, 2w, NQ, D): [previous block | own block]
        xb = expand_kv(x, NQ).reshape(B, nb, w, NQ, D)
        return torch.cat([torch.cat([torch.zeros_like(xb[:, :1]), xb[:, :-1]], 1), xb], 2)

    ke, ve = ext(k), ext(v)
    s = torch.einsum("bnqhd,bnkhd->bnhqk", q.reshape(B, nb, w, NQ, D) * (D**-0.5), ke).float()
    qpos = torch.arange(w, device=q.device)[:, None]
    kpos = torch.arange(2 * w, device=q.device)[None, :] - w  # relative to the block's start
    band = (qpos >= kpos) & (qpos - kpos < w)
    first = torch.arange(nb, device=q.device) == 0
    mask = band[None] & ~(first[:, None, None] & (kpos < 0)[None])  # (nb, w, 2w)
    a = torch.softmax(torch.where(mask[None, :, None], s, NEG_INF), dim=-1).to(q.dtype)
    return torch.einsum("bnhqk,bnkhd->bnqhd", a, ve).reshape(B, S, NQ, D)


def decode_attention(
    q: torch.Tensor,  # (B, 1, NQ, D)
    k_cache: torch.Tensor,  # (B, Smax, NKV, D)
    v_cache: torch.Tensor,
    cache_len,  # int or () tensor: the valid length (the new token's position + 1)
    *,
    window: int = 0,
    ring: bool = False,
) -> torch.Tensor:
    """One query token against the static cache: keys at ``idx >=
    cache_len`` (and, with ``window``, at ``idx < cache_len − window``) are
    masked. With ``ring`` the cache is a local layer's ring (slot = position
    mod Smax): every slot below min(cache_len, Smax) is valid, the whole
    ring once it has wrapped. The query heads are grouped over the cache's
    KV heads, so the cache is read as it lies, never repeated to NQ heads;
    each score is the same dot product as ``repro``'s expanded einsum."""
    B, Smax, NKV, D = k_cache.shape
    NQ = q.shape[2]
    qg = (q * (D**-0.5)).reshape(B, NKV, NQ // NKV, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache).float()
    idx = torch.arange(Smax, device=q.device)
    if ring:
        valid = idx < min(int(cache_len), Smax)
    else:
        valid = idx < cache_len
        if window:
            valid &= idx >= cache_len - window
    a = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1).to(q.dtype)
    return torch.einsum("bhgk,bkhd->bhgd", a, v_cache).reshape(B, 1, NQ, D)


def decode_attention_seq_sharded(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, cache_len, *,
                                 ring: bool = False) -> torch.Tensor:
    """``decode_attention`` on the long-context cells' DTensors, whose cache
    is sharded on its sequence: each rank scores its own slots with its own
    query heads (the KV head of each, as ``per_head`` takes it), and the
    softmax's maximum (an all-gather), its sum and the weighted values (all-
    reduces, f32) are combined over the sequence's mesh dims: split-K
    decoding, the same function in another summation order. The result has
    q's head layout, whole over the sequence's mesh dims."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, (B, Smax, NKV, D), NQ = q.device_mesh, k_cache.shape, q.shape[2]
    qpl = tuple(Replicate() if p.is_partial() else p for p in q.placements)
    ql, kl, vl = q.redistribute(mesh, qpl).to_local(), k_cache.to_local(), v_cache.to_local()
    h0, n = block(q.shape, mesh, qpl, 2)
    if kl.shape[2] == NKV and n != NQ:  # query heads split, KV heads whole: each query head's KV head
        heads = torch.arange(h0, h0 + n, device=kl.device) // (NQ // NKV)
        kl, vl = kl.index_select(2, heads), vl.index_select(2, heads)
    s0, sl = block(k_cache.shape, mesh, tuple(k_cache.placements), 1)
    nkv = kl.shape[2]
    qg = (ql * (D**-0.5)).reshape(ql.shape[0], nkv, n // nkv, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, kl).float()
    idx = s0 + torch.arange(sl, device=q.device)
    valid = idx < (min(int(cache_len), Smax) if ring else cache_len)
    s = torch.where(valid, s, NEG_INF)
    over = tuple(i for i, p in enumerate(k_cache.placements) if p == Shard(1))  # the sequence's mesh dims
    m = combine(s.amax(-1), mesh, over, "max")
    e = torch.exp(s - m[..., None])
    den = combine(e.sum(-1), mesh, over)
    num = combine(torch.einsum("bhgk,bkhd->bhgd", e, vl.float()), mesh, over)
    o = (num / den[..., None]).to(q.dtype).reshape(ql.shape[0], 1, n, D)
    return from_local(o, mesh, qpl, (B, 1, NQ, D))


def dispatch_attention(
    cfg,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mixer: str,
    causal: bool,
    kv_len: Optional[torch.Tensor] = None,  # (B,) ragged valid K lengths
) -> torch.Tensor:
    """The attention algorithm for a layer: ``local_attention`` for a local
    layer of a sliding-window config (``attn_impl`` and ``kv_len`` aside, as
    in ``repro``: right padding is exact for the real rows under the causal
    mask), the flash op when ``cfg.attn_impl == "flash"``,
    ``blocked_attention`` above ``BLOCK_THRESHOLD`` tokens with no
    ``kv_len``, else ``full_attention``; on the dry run's DTensors each
    rank attends with its own rows and heads (``sharding.context.per_head``)."""
    if mixer == "local" and getattr(cfg, "sliding_window", 0):
        fn = lambda q, k, v: local_attention(q, k, v, window=cfg.sliding_window)
    elif getattr(cfg, "attn_impl", "auto") == "flash":
        fn = lambda q, k, v: flash_attention(q, k, v, causal=causal, lengths=kv_len,
                                             block_q=cfg.attn_block_q, block_k=cfg.attn_block_k)
    elif q.shape[1] > BLOCK_THRESHOLD and kv_len is None:
        fn = lambda q, k, v: blocked_attention(q, k, v, causal=causal)
    else:
        fn = lambda q, k, v: full_attention(q, k, v, causal=causal, kv_len=kv_len)
    return per_head(fn, q, k, v)
