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
the expert axis, with ``repro``'s casts to the compute dtype. ``repro``
pins the buffer to its expert-parallel mesh axis; on one card that has no
meaning and is dropped.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import ParamDef


def moe_def(cfg: ArchConfig) -> dict:
    d, f, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.num_experts
    return {
        "router": ParamDef((d, e), scale=0.02),
        "wi_gate": ParamDef((e, d, f)),
        "wi_up": ParamDef((e, d, f)),
        "wo": ParamDef((e, f, d)),
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


def route(router: torch.Tensor, xt: torch.Tensor, cfg: ArchConfig) -> Routing:
    """``repro``'s routing of tokens ``xt`` (T, d) through ``router`` (d, E)."""
    T = xt.shape[0]
    E, k = cfg.num_experts, cfg.experts_per_tok
    C = capacity(T, cfg)
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    gate, eid = torch.topk(probs, k, dim=-1)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    flat_e = eid.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    experts = torch.arange(E, device=xt.device)
    starts = torch.searchsorted(se, experts)  # first sorted slot of each expert
    counts = torch.searchsorted(se, experts, right=True) - starts
    rank_sorted = torch.arange(T * k, device=xt.device) - starts[se]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)  # by flat choice
    keep = (rank < C).view(T, k)
    slot = torch.where(keep, eid * C + rank.view(T, k), 0)

    c = torch.arange(C, device=xt.device)
    filled = (c[None] < counts[:, None]).reshape(-1)
    src = torch.clamp((starts[:, None] + c[None]).reshape(-1), max=T * k - 1)
    slot_choice = torch.where(filled, order[src], 0)
    return Routing(probs, gate, eid, keep, slot, slot_choice // k, slot_choice, filled, counts, C)


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


def moe(p: dict, x: torch.Tensor, cfg: ArchConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y (B, S, d) in x.dtype, the f32 aux loss)."""
    B, S, d = x.shape
    T, E, k = B * S, cfg.num_experts, cfg.experts_per_tok
    dt = x.dtype
    xt = x.reshape(T, d)
    r = route(p["router"], xt, cfg)

    # load-balance aux loss (Switch-style)
    aux = cfg.router_aux_weight * E * torch.sum(r.probs.mean(0) * (r.counts.float() / (T * k)))

    # dispatch: slot (e, c) holds its token; a token's k slots carry its gradient back
    buf = _gather_rows(xt, r.slot_token, r.filled, r.slot, r.keep).view(E, r.C, d)
    g = torch.bmm(buf, p["wi_gate"].to(dt))
    u = torch.bmm(buf, p["wi_up"].to(dt))
    out = torch.bmm(F.silu(g) * u, p["wo"].to(dt)).view(E * r.C, d)

    # combine: each choice reads its slot back; each slot's one choice carries it
    gathered = _gather_rows(out, r.slot.reshape(-1), r.keep.reshape(-1),
                            r.slot_choice[:, None], r.filled[:, None]).view(T, k, d)
    y = (gathered * r.gate.to(dt)[..., None]).sum(1)
    return y.view(B, S, d), aux
