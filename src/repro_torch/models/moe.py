"""Mixture-of-Experts FFN of ``repro.models.moe``: top-k token-choice
routing, stable-sort capacity dispatch into (E, C, d), batched expert SwiGLU
and the gated combine, with the Switch load-balance loss.

The routing is ``repro``'s step for step: the router in f32, softmax,
top-k renormalised by max(Σ, 1e-9), a stable sort of the (token, choice)
slots by expert, each slot's rank within its expert, and ``keep = rank <
C`` for the capacity C of the call's B·S tokens (``capacity``): padding
positions and batchmates compete for the same slots, as in ``repro``.

``repro`` scatters the kept tokens into the (E, C, d) buffer and adds the
experts' outputs back with ``.at[].add``; on the card those are float
atomics, whose order changes from run to run. Here both directions are
gathers: the buffer's slot (e, c) reads the token of sorted slot
starts[e] + c, a token's k choices read their slots back, and each
backward gathers the cotangents the same way and sums a token's k of them
in a fixed order (``_gather_rows``). Two calls on the same inputs give the
same bits, forward and gradient. The expert products are ``torch.bmm`` over
the expert axis, with ``repro``'s casts to the compute dtype. As in
``repro``, the buffer and the experts' outputs are pinned to the
expert-parallel axis (``sharding.context.constrain``; a no-op off the dry
run's meshes).

On the dry run's meshes (DTensors) the routing stays one sort of all T
tokens of the call, ``repro``'s function: the (T, k) picks are gathered
whole on every rank (the picks' all-gather) and every rank runs the same
integer path on them (``_plan``), so the ranks agree exactly and no
sharding strategy of DTensor's is asked for. The dispatch (``_Dispatch``)
gathers the call's tokens whole (the tokens' all-gather) and fills only
the rank's own experts' rows of the (E, C, d) buffer; the combine
(``_Combine``) reads the rank's own tokens' choices from its own experts'
rows, and the parts over the expert-parallel axis are all-reduced. Their
backwards are gathers again, with the matching reductions.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import ParamDef
from repro_torch.sharding.context import block, constrain, from_local, layout, on_shards, partial, replicate


def moe_def(cfg: ArchConfig) -> dict:
    d, f, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.num_experts
    return {
        "router": ParamDef((d, e), scale=0.02, axes=("embed", None)),
        "wi_gate": ParamDef((e, d, f), axes=("experts", "embed", "mlp")),
        "wi_up": ParamDef((e, d, f), axes=("experts", "embed", "mlp")),
        "wo": ParamDef((e, f, d), axes=("experts", "mlp", "embed")),
    }


def capacity(tokens: int, cfg: ArchConfig) -> int:
    """Slots per expert for a call of ``tokens`` tokens: ``tokens``·k·factor/E,
    rounded up to a multiple of 8, at least 8."""
    c = int(tokens * cfg.experts_per_tok * cfg.capacity_factor / cfg.num_experts)
    return max(8, -(-c // 8) * 8)


class Routing(NamedTuple):
    """One call's routing of T tokens to E experts of C slots each."""

    probs: torch.Tensor  # (T, E) f32 router probabilities
    gate: torch.Tensor  # (T, k) f32 renormalised top-k weights
    eid: torch.Tensor  # (T, k) the chosen experts
    keep: torch.Tensor  # (T, k) bool: the choice got a slot
    slot: torch.Tensor  # (T, k) its flat slot e·C + rank (0 where dropped)
    slot_token: torch.Tensor  # (E·C,) the token in each slot (0 where empty)
    slot_choice: torch.Tensor  # (E·C,) its flat choice t·k + j (0 where empty)
    filled: torch.Tensor  # (E·C,) bool: the slot holds a token
    counts: torch.Tensor  # (E,) choices of each expert, kept or not
    C: int


def _plan(eid: torch.Tensor, E: int, C: int) -> tuple:
    """The integer path of ``route`` on plain (T, k) picks: (keep, slot,
    slot_token, slot_choice, filled, counts)."""
    T, k = eid.shape
    flat_e = eid.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    experts = torch.arange(E, device=eid.device)
    starts = torch.searchsorted(se, experts)  # first sorted slot of each expert
    counts = torch.searchsorted(se, experts, right=True) - starts
    rank_sorted = torch.arange(T * k, device=eid.device) - starts[se]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)  # by flat choice
    keep = (rank < C).view(T, k)
    slot = torch.where(keep, eid * C + rank.view(T, k), 0)

    c = torch.arange(C, device=eid.device)
    filled = (c[None] < counts[:, None]).reshape(-1)
    src = torch.clamp((starts[:, None] + c[None]).reshape(-1), max=T * k - 1)
    slot_choice = torch.where(filled, order[src], 0)
    return keep, slot, slot_choice // k, slot_choice, filled, counts


def route(router: torch.Tensor, xt: torch.Tensor, cfg: ArchConfig) -> Routing:
    """``repro``'s routing of tokens ``xt`` (T, d) through ``router`` (d, E).
    On DTensors the picks are made whole first, and the integer fields come
    back as replicated DTensors."""
    from torch.distributed.tensor import DTensor

    T = xt.shape[0]
    E, k = cfg.num_experts, cfg.experts_per_tok
    C = capacity(T, cfg)
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    gate, eid = on_shards(lambda t: torch.topk(t, k, dim=-1), probs)  # each rank's own tokens
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    if not isinstance(eid, DTensor):
        return Routing(probs, gate, eid, *_plan(eid, E, C), C)
    whole = replicate(eid)  # the picks' all-gather: every rank sorts all T·k of them
    plan = _plan(whole.to_local(), E, C)
    return Routing(probs, gate, eid, *(from_local(t, whole.device_mesh, whole.placements, t.shape) for t in plan), C)


class _GatherRows(torch.autograd.Function):
    """out[i] = src[idx[i]] where ``valid[i]``, else 0. The backward is a
    gather too: grad_src[r] = Σ_j grad[back[r, j]] over the ``back_valid``
    entries, summed over j in a fixed order, so it uses no atomics."""

    @staticmethod
    def forward(ctx, src, idx, valid, back, back_valid):
        ctx.save_for_backward(back, back_valid)
        return torch.where(valid[:, None], src[idx], 0)

    @staticmethod
    def backward(ctx, grad):
        back, back_valid = ctx.saved_tensors
        g = torch.where(back_valid[..., None], grad[back], 0)
        return g.sum(1), None, None, None, None


def _gather_rows(src, idx, valid, back, back_valid):
    return _GatherRows.apply(src, idx, valid, back, back_valid)


def _tokens_layout(xt) -> tuple:
    """The layout of the (T, d) tokens' dispatch and combine: ``xt``'s
    shards of the tokens, whole on every other mesh dim."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(p if p == Shard(0) else Replicate() for p in xt.placements)


class _Dispatch(torch.autograd.Function):
    """The (E, C, d) buffer on the dry run's meshes, laid out as ``layout``
    gives ("model", None, None): the call's tokens are gathered whole and
    each rank fills its own experts' rows, ``_GatherRows``'s forward on its
    slice. The backward is ``_GatherRows``'s on the rank's own tokens,
    whose parts over the expert shards are all-reduced back to ``xt``'s
    layout."""

    @staticmethod
    def forward(ctx, xt, slot_token, filled, slot, keep, E, C):
        mesh, (T, d), xpl = xt.device_mesh, xt.shape, _tokens_layout(xt)
        pl = layout(mesh, (E, C, d), "model", None, None)
        e0, el = block((E, C, d), mesh, pl, 0)
        xr = replicate(xt).to_local()  # the tokens' all-gather
        st, fl = (t.to_local().view(E, C)[e0:e0 + el].reshape(-1) for t in (slot_token, filled))
        buf = torch.where(fl[:, None], xr[st], 0).view(el, C, d)
        ctx.save_for_backward(slot.to_local(), keep.to_local())
        ctx.meta = (mesh, xpl, pl, e0 * C, el * C, (T, d))
        return from_local(buf, mesh, pl, (E, C, d))

    @staticmethod
    def backward(ctx, grad):
        slot, keep = ctx.saved_tensors
        mesh, xpl, pl, r0, rl, shape = ctx.meta
        g = grad.redistribute(mesh, pl).to_local().reshape(rl, -1)
        t0, tl = block(shape, mesh, xpl, 0)
        sl, kp = slot[t0:t0 + tl], keep[t0:t0 + tl]
        mine = kp & (sl >= r0) & (sl < r0 + rl)
        gx = torch.where(mine[..., None], g[torch.where(mine, sl - r0, 0)], 0).sum(1)
        gx = from_local(gx, mesh, partial(xpl, pl), shape).redistribute(mesh, xpl)
        return gx, None, None, None, None, None, None


class _Combine(torch.autograd.Function):
    """y (T, d) on the dry run's meshes, in ``xpl`` (``xt``'s layout): each
    rank reads its own tokens' kept choices from its own experts' rows of
    ``out`` (E, C, d) and sums them by their gates, as the one-device path
    does; the parts over the expert shards are all-reduced. The backward
    gives the gates' gradient the same way, and ``out``'s by
    ``_GatherRows``'s gather of each filled slot's one choice, all-reduced
    over the token shards."""

    @staticmethod
    def forward(ctx, out, gate, slot, keep, slot_choice, filled, xpl):
        mesh, (E, C, d), (T, k) = out.device_mesh, out.shape, gate.shape
        pl = tuple(out.placements)
        e0, el = block(out.shape, mesh, pl, 0)
        t0, tl = block((T, d), mesh, xpl, 0)
        ol = out.to_local().reshape(el * C, d)
        gl = gate.redistribute(mesh, xpl).to_local()
        sl, kp = slot.to_local()[t0:t0 + tl], keep.to_local()[t0:t0 + tl]
        mine = kp & (sl >= e0 * C) & (sl < (e0 + el) * C)
        gathered = torch.where(mine[..., None], ol[torch.where(mine, sl - e0 * C, 0)], 0)
        y = (gathered * gl.to(ol.dtype)[..., None]).sum(1)
        ctx.save_for_backward(gathered, gl, slot_choice.to_local(), filled.to_local())
        ctx.meta = (mesh, xpl, pl, e0 * C, el * C, t0, tl, tuple(gate.placements), (E, C, d), (T, k))
        return from_local(y, mesh, partial(xpl, pl), (T, d)).redistribute(mesh, xpl)

    @staticmethod
    def backward(ctx, grad):
        gathered, gl, slot_choice, filled = ctx.saved_tensors
        mesh, xpl, pl, r0, rl, t0, tl, gpl, oshape, gshape = ctx.meta
        gy = grad.redistribute(mesh, xpl).to_local()
        g_gate = (gy[:, None] * gathered).sum(-1).float()
        g_gate = from_local(g_gate, mesh, partial(xpl, pl), gshape).redistribute(mesh, gpl)
        sc, fl = slot_choice[r0:r0 + rl], filled[r0:r0 + rl]
        t, j = sc // gshape[1], sc % gshape[1]
        mine = fl & (t >= t0) & (t < t0 + tl)
        ti = torch.where(mine, t - t0, 0)
        g_out = torch.where(mine[:, None], gy[ti] * gl[ti, j].to(gy.dtype)[:, None], 0)
        g_out = from_local(g_out.view(-1, *oshape[1:]), mesh, partial(pl, xpl), oshape)
        return g_out.redistribute(mesh, pl), g_gate, None, None, None, None, None


def moe(p: dict, x: torch.Tensor, cfg: ArchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d) in x.dtype, the f32 aux loss)."""
    from torch.distributed.tensor import DTensor

    B, S, d = x.shape
    T, E, k = B * S, cfg.num_experts, cfg.experts_per_tok
    dt = x.dtype
    xt = x.reshape(T, d)
    r = route(p["router"], xt, cfg)
    sharded = isinstance(xt, DTensor)

    # load-balance aux loss (Switch-style); on a mesh the tokens' sum is all-reduced
    mean_probs = replicate(r.probs.sum(0)) / T if sharded else r.probs.mean(0)
    aux = cfg.router_aux_weight * E * torch.sum(mean_probs * (r.counts.float() / (T * k)))

    # dispatch: slot (e, c) holds its token; a token's k slots carry its gradient back
    if sharded:
        buf = _Dispatch.apply(xt, r.slot_token, r.filled, r.slot, r.keep, E, r.C)
    else:
        buf = _gather_rows(xt, r.slot_token, r.filled, r.slot, r.keep).view(E, r.C, d)
    buf = constrain(buf, "model", None, None)  # EP: experts stay sharded
    g = torch.bmm(buf, p["wi_gate"].to(dt))
    u = torch.bmm(buf, p["wi_up"].to(dt))
    out = constrain(torch.bmm(F.silu(g) * u, p["wo"].to(dt)), "model", None, None)

    # combine: each choice reads its slot back; each slot's one choice carries it
    if sharded:
        y = _Combine.apply(out, r.gate, r.slot, r.keep, r.slot_choice, r.filled, _tokens_layout(xt))
    else:
        gathered = _gather_rows(out.view(E * r.C, d), r.slot.reshape(-1), r.keep.reshape(-1),
                                r.slot_choice[:, None], r.filled[:, None]).view(T, k, d)
        y = (gathered * r.gate.to(dt)[..., None]).sum(1)
    return constrain(y.view(B, S, d), "batch", "seq", None), aux
