"""Core layers of ``repro.models.layers``: RMSNorm, RoPE, the SwiGLU MLP,
the token embeddings, the stub frontend's projection and the chunked
softmax cross-entropy of the training loss.

Parameters keep ``repro``'s layouts (``mlp`` weights (d, f) and (f, d) for
``x @ w``, ``embedding`` (V, d), ``unembed`` (d, V), ``frontend_proj``
(frontend_dim, d)). As in ``repro``, the MLP hidden and the loss's logits
stay on the tensor-parallel axis (``sharding.context.constrain``, which the
dry run's sharded cells act on and which leaves a plain tensor as it is).
On those cells' DTensors the embedding lookup and the loss run on each
rank's vocab rows, with their sums over the vocab shards all-reduced
(``_VocabLookup``, ``_VocabXent``), as ``repro``'s partitioner computes
them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import ParamDef
from repro_torch.sharding.context import block, combine, constrain, from_local, gathered, partial, replicate


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis with f32 statistics, cast back to x.dtype.
    A (B, S, d) result is pinned as the residual stream is: its gradient's
    pending sum over the tensor-parallel ranks is then reduced here, not
    wherever DTensor's version would leave it."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    y = (y * p["scale"].float()).to(x.dtype)
    return constrain(y, "batch", "seq", None) if y.ndim == 3 else y


def rmsnorm_def(d: int) -> dict:
    return {"scale": ParamDef((d,), "ones", axes=(None,))}


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, halves rotated (``repro``'s layout). x: (..., S, H,
    D); positions: (..., S). Angles in f32; the rotation is taken in f32
    and cast back to x.dtype, as ``repro``'s type promotion does."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = (positions.float()[..., :, None] * freq)[..., :, None, :]  # over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def mlp_def(d: int, f: int) -> dict:
    return {"wi_gate": ParamDef((d, f), axes=("embed", "mlp")), "wi_up": ParamDef((d, f), axes=("embed", "mlp")),
            "wo": ParamDef((f, d), axes=("mlp", "embed"))}


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x W_gate) ∘ x W_up) W_o."""
    dt = x.dtype
    h = F.silu(x @ p["wi_gate"].to(dt)) * (x @ p["wi_up"].to(dt))
    h = constrain(h, "batch", "seq", "model")  # keep hidden TP-sharded
    return constrain(h @ p["wo"].to(dt), "batch", "seq", None)  # the partial sums over the hidden, reduced


def embed_def(cfg) -> dict:
    """The token embedding (V, d), unit normal, unless tied the unembedding
    (d, V), and with a stub frontend its projection (frontend_dim, d), both
    at fan-in scale."""
    d = {"embedding": ParamDef((cfg.vocab_size, cfg.d_model), "embed", axes=("vocab", "embed"))}
    if not cfg.tie_embeddings:
        d["unembed"] = ParamDef((cfg.d_model, cfg.vocab_size), axes=("embed", "vocab"))
    if cfg.frontend:
        d["frontend_proj"] = ParamDef((cfg.frontend_dim or cfg.d_model, cfg.d_model), axes=("frontend", "embed"))
    return d


def _vocab_dims(x) -> tuple:
    """The mesh dims that shard ``x``'s last dim (the vocab)."""
    return tuple(i for i, p in enumerate(x.placements) if p.is_shard() and p.dim == x.ndim - 1)


class _VocabLookup(torch.autograd.Function):
    """``table[ids]`` on the dry run's meshes: each rank looks its ids up in
    its own rows of the vocab-sharded ``table`` (zeros for the others' ids);
    the result is pending the sum over the vocab shards. The backward adds
    each id's gradient into its row of the rank's shard, pending the sum
    over the ids' shards."""

    @staticmethod
    def forward(ctx, table, ids):
        mesh, tpl, ipl = table.device_mesh, tuple(table.placements), tuple(ids.placements)
        v0, vl = block(table.shape, mesh, tpl, 0)
        il = ids.to_local()
        mine = (il >= v0) & (il < v0 + vl)
        rows = torch.where(mine, il - v0, 0)
        e = torch.where(mine[..., None], table.to_local()[rows], 0)
        ctx.save_for_backward(rows, mine)
        ctx.meta = (mesh, partial(ipl, tpl), tuple(table.shape), vl, partial(tpl, ipl))
        return from_local(e, mesh, partial(ipl, tpl), (*ids.shape, table.shape[1]))

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import Replicate

        rows, mine = ctx.saved_tensors
        mesh, opl, shape, vl, gpl = ctx.meta
        g = grad.redistribute(mesh, tuple(Replicate() if p.is_partial() else p for p in opl)).to_local()
        g = torch.where(mine[..., None], g, 0).reshape(-1, shape[1])
        gt = torch.zeros((vl, shape[1]), dtype=g.dtype, device=g.device).index_add_(0, rows.reshape(-1), g)
        return from_local(gt, mesh, gpl, shape), None


def embed(p: dict, tokens: torch.Tensor, cfg, dtype: torch.dtype) -> torch.Tensor:
    """Token ids (…) -> embeddings (…, d) in ``dtype``; gemma scales by √d.
    On the dry run's meshes the lookup is vocab-parallel (``_VocabLookup``)
    and its sum over the vocab shards is all-reduced."""
    from torch.distributed.tensor import DTensor

    table = p["embedding"]
    if isinstance(table, DTensor):  # (B, S) ids
        ids = constrain(tokens.long(), "batch", "seq")
        e = constrain(_VocabLookup.apply(gathered(table), ids), "batch", "seq", None).to(dtype)
    else:
        e = table[tokens.long()].to(dtype)
    if cfg.name.startswith("gemma"):
        e = e * torch.tensor(cfg.d_model**0.5, dtype=dtype)
    return e


def project_frontend(p: dict, feats: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Stub frontend features (…, frontend_dim) — audio frames or vision
    patches — -> embeddings (…, d) in ``dtype``."""
    return feats.to(dtype) @ gathered(p["frontend_proj"]).to(dtype)


def unembed(p: dict, h: torch.Tensor, cfg) -> torch.Tensor:
    """(…, d) -> (…, V) logits in h.dtype, through the tied embedding or
    the unembedding."""
    if cfg.tie_embeddings:
        return h @ gathered(p["embedding"]).to(h.dtype).T
    return h @ gathered(p["unembed"]).to(h.dtype)


class _VocabXent(torch.autograd.Function):
    """The summed cross-entropy of logits (N, V) f32 against labels (N,),
    ``repro``'s logsumexp less the gold logit, and its gradient, softmax
    less the one-hot. On the dry run's meshes (logits sharded on the vocab)
    each rank takes the maximum and the sum of exponentials over its vocab
    rows and the gold logit where it holds it; the maximum is gathered over
    the vocab shards, the sums and the gold logits all-reduced, and the
    rows' sum all-reduced over the token shards. Plain tensors run the same
    arithmetic with no collective."""

    @staticmethod
    def forward(ctx, logits, labels):
        from torch.distributed.tensor import DTensor, Replicate

        if isinstance(logits, DTensor):
            mesh, pl = logits.device_mesh, tuple(logits.placements)
            rows = tuple(p if p.is_shard() and p.dim == 0 else Replicate() for p in pl)  # the token shards
            ll, lab = logits.to_local(), labels.redistribute(mesh, rows).to_local()
            v0, vl = block(logits.shape, mesh, pl, 1)
            over = _vocab_dims(logits)
        else:
            mesh, pl, rows, ll, lab, v0, vl, over = None, None, None, logits, labels, 0, logits.shape[1], ()
        m = combine(ll.amax(-1), mesh, over, "max")
        mine = (lab >= v0) & (lab < v0 + vl)
        col = torch.where(mine, lab - v0, 0)
        gold = torch.where(mine, ll.gather(1, col[:, None])[:, 0], 0)
        sums = combine(torch.stack([torch.exp(ll - m[:, None]).sum(-1), gold]), mesh, over)
        lse = m + torch.log(sums[0])
        total = (lse - sums[1]).sum()
        ctx.save_for_backward(ll, lse, col, mine)
        ctx.meta = (mesh, pl, tuple(logits.shape))
        if mesh is None:
            return total
        whole = (Replicate(),) * mesh.ndim
        return from_local(total, mesh, partial(whole, rows), ()).redistribute(mesh, whole)

    @staticmethod
    def backward(ctx, grad):
        ll, lse, col, mine = ctx.saved_tensors
        mesh, pl, shape = ctx.meta
        g = grad if mesh is None else replicate(grad).to_local()
        d = torch.exp(ll - lse[:, None])
        d.scatter_(1, col[:, None], d.gather(1, col[:, None]) - mine[:, None].to(d.dtype))
        d = d * g
        return (d if mesh is None else from_local(d, mesh, pl, shape)), None


def vocab_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The f32 () sum over rows of logits (N, V) f32 of the cross-entropy
    against labels (N,), vocab-parallel on the dry run's DTensors
    (``_VocabXent``); ``F.cross_entropy(..., reduction="sum")`` within
    rounding."""
    return _VocabXent.apply(logits, labels)


def softmax_xent_chunked(p_embed: dict, h: torch.Tensor, labels: torch.Tensor, cfg,
                         chunk: int = 512) -> torch.Tensor:
    """Mean next-token cross-entropy of hidden states h (B, S, d) against
    ``labels`` (B, S) without the whole (B, S, V) logits: chunks of
    ``chunk`` positions, then the remainder, as in ``repro``, each chunk's
    f32 logits recomputed in the backward (``torch.utils.checkpoint``), so
    none outlives its chunk. Returns the f32 () mean over B·S. A chunk's
    sum is ``vocab_xent``'s, ``repro``'s logsumexp less the gold logit,
    vocab-parallel on the dry run's sharded cells."""
    B, S, _ = h.shape
    chunk = min(chunk, S)
    n = S // chunk

    def part(hc: torch.Tensor, lc: torch.Tensor) -> torch.Tensor:
        logits = unembed(p_embed, hc, cfg).float()  # (B, c, V)
        logits = constrain(logits, "batch", None, "model")  # vocab stays TP
        return vocab_xent(logits.flatten(0, 1), lc.flatten().long())

    bounds = [(i * chunk, (i + 1) * chunk) for i in range(n)] + ([(n * chunk, S)] if S % chunk else [])
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for a, b in bounds:
        total = total + checkpoint(part, h[:, a:b], labels[:, a:b], use_reentrant=False)
    return total / (B * S)
