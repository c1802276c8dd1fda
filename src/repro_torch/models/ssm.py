"""Mamba-2 (SSD, state-space duality) mixer of ``repro.models.ssm``: the
chunked full-sequence path, the prefill that also returns the decode cache
(the last chunk's state and the conv's input tail), and the one-token
recurrence.

``repro``'s dtypes are kept: the projections and the causal conv run in the
compute dtype; the decay ``cum``, the intra-chunk weights ``L``, x·dt, B, C
and the state in f32; ``_gated_norm`` upcasts.

Differences in form, none in the function:
  * ``L = exp(cum_l − cum_s)`` is masked *before* the exponential
    (−inf above the diagonal). ``repro`` takes ``where(causal, exp(L), 0)``,
    whose forward is the same bit for bit, but whose gradient is NaN once a
    chunk reaches about 110 tokens: above the diagonal ``exp`` overflows to
    inf and the discarded zero cotangent times inf is NaN. Here the
    gradient stays finite at every chunk (ROADMAP.md queue 3).
  * The five input projections are one product (their weights side by
    side), and the depthwise conv runs once over the channels x|B|C, whose
    per-channel arithmetic is ``repro``'s three convs'.
  * ``repro``'s four-operand einsums are written as matrix products in a
    fixed order (C·Bᵀ over the state, times L, times x·dt), so nothing
    larger than one (chunks, B, H, l, s) tensor is formed; C·Bᵀ is taken
    once per group and broadcast over the group's heads.
  * The inter-chunk recurrence s_k = s_{k−1}·d_k + c_k is a doubling
    (Hillis–Steele) scan of ceil(log2 nc) tensor steps in place of
    ``lax.associative_scan``: the same recurrence, summed in another order;
    with one chunk no state enters, and its term is not formed.
As in ``repro``, the heads of x are pinned to the tensor-parallel axis
(``sharding.context.constrain``; a no-op off the dry run's meshes). On
those meshes the pieces of the fused projection and conv weights are made
whole before they are joined, and the decode step's conv tail is read
whole, so no join asks DTensor to pick a layout; the causal conv, the
chunked scan (``_scan_on_shards``) and the decode recurrence (``_recur``)
run on each rank's own batch rows and heads (``sharding.context.on_shards``,
no collective): torch 2.11's DTensor pads on one-dimensional meshes only,
has no strategy for softplus, and cannot flatten a sharded batch and a
sharded head axis into the one batch axis of a product.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import ParamDef
from repro_torch.sharding.context import block, constrain, from_local, on_shards, partial, replicate


def ssm_def(cfg: ArchConfig) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    G, N, H, W = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    return {
        "in_z": ParamDef((d, di), axes=("embed", "inner")),
        "in_x": ParamDef((d, di), axes=("embed", "inner")),
        "in_B": ParamDef((d, G * N), axes=("embed", None)),
        "in_C": ParamDef((d, G * N), axes=("embed", None)),
        "in_dt": ParamDef((d, H), axes=("embed", "ssm_heads")),
        "conv_x": ParamDef((W, di), scale=0.5, axes=(None, "inner")),
        "conv_B": ParamDef((W, G * N), scale=0.5, axes=(None, None)),
        "conv_C": ParamDef((W, G * N), scale=0.5, axes=(None, None)),
        "A_log": ParamDef((H,), "zeros", axes=("ssm_heads",)),
        "D": ParamDef((H,), "ones", axes=("ssm_heads",)),
        "dt_bias": ParamDef((H,), "zeros", axes=("ssm_heads",)),
        "norm": ParamDef((di,), "ones", axes=("inner",)),
        "out": ParamDef((di, d), axes=("inner", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence (B, S, C) by shifted adds; on
    a DTensor, on each rank's own batch rows (DTensor's padding of torch
    2.11 runs on one-dimensional meshes only)."""

    def conv(x, w):
        W, S = w.shape[0], x.shape[1]
        out = x * w[-1]
        for i in range(1, W):
            out = out + F.pad(x, (0, 0, i, 0))[:, :S] * w[W - 1 - i]
        return out

    return on_shards(conv, x, w)


def _gated_norm(scale: torch.Tensor, y: torch.Tensor, z: torch.Tensor, eps: float) -> torch.Tensor:
    g32 = (y * F.silu(z)).float()
    if isinstance(g32, DTensor):  # the sum over the heads' shards reduced where it is made
        var = constrain(g32.square().sum(-1, keepdim=True), "batch", "seq", None) / g32.shape[-1]
    else:
        var = g32.square().mean(-1, keepdim=True)
    return (g32 * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def _proj_inputs(p: dict, u: torch.Tensor):
    """z, the conv's input x|B|C and dt: the five projections as one product
    (their weights side by side)."""
    w = torch.cat([replicate(p[k]) for k in ("in_z", "in_x", "in_B", "in_C", "in_dt")], dim=1).to(u.dtype)
    di = p["in_z"].shape[1]
    z, xbc, dt = (u @ w).split([di, w.shape[1] - di - p["in_dt"].shape[1], p["in_dt"].shape[1]], dim=-1)
    return z, xbc, dt


def _conv_weight(p: dict, dtype) -> torch.Tensor:
    """The depthwise conv's weights over the channels x|B|C, (W, channels)."""
    return torch.cat([replicate(p[k]) for k in ("conv_x", "conv_B", "conv_C")], dim=-1).to(dtype)


def chunk_len(S: int, chunk: int) -> int:
    """The largest chunk ≤ ``chunk`` that divides S (SSD is exact for any
    chunking; a prime S gets 1)."""
    cl = min(chunk, S)
    while S % cl:
        cl -= 1
    return cl


def _prefix_scan(decay: torch.Tensor, contrib: torch.Tensor) -> torch.Tensor:
    """s_k = s_{k−1}·decay_k + contrib_k over axis 0 with s_{−1} = 0, for
    every k: decay (nc, …), contrib (nc, …, P, N)."""
    nc, shift = decay.shape[0], 1
    while shift < nc:
        contrib = torch.cat([contrib[:shift], contrib[:-shift] * decay[shift:, ..., None, None]
                             + contrib[shift:]])
        decay = torch.cat([decay[:shift], decay[:-shift] * decay[shift:]])
        shift *= 2
    return contrib


def _scan(xh: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, A_log: torch.Tensor,
          dt_bias: torch.Tensor, G: int, cl: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked SSD of plain tensors, its sizes read off them: x (B, S,
    H, P), the projected dt (B, S, H), B and C (B, S, G·N), A_log and
    dt_bias (H,) -> (y (B, S, H, P) in x's dtype, the state after the last
    chunk (B, H, P, N) f32)."""
    Bb, S, H, P = xh.shape
    N, rep, nc = Bm.shape[-1] // G, H // G, S // cl
    A = -torch.exp(A_log.float())  # (H,)
    dt = F.softplus(dt.float() + dt_bias.float())  # (B, S, H)

    # chunked, heads ahead of positions: (nc, B, H, cl, ...) and, per group, (nc, B, G, cl, N)
    xc = xh.reshape(Bb, nc, cl, H, P).permute(1, 0, 3, 2, 4)
    dtc = dt.reshape(Bb, nc, cl, H).permute(1, 0, 3, 2)
    Bc, Cc = (t.reshape(Bb, nc, cl, G, N).permute(1, 0, 3, 2, 4).float() for t in (Bm, Cm))
    dA = dtc * A[:, None]  # (nc, B, H, cl) f32
    cum = torch.cumsum(dA, dim=-1)  # within-chunk cumulative decay
    xdt = xc.float() * (dA / A[:, None])[..., None]  # x·dt (dA = dt·A), (nc, B, H, cl, P)

    def heads(t):  # (nc, B, H, …) -> (nc, B, G, rep, …)
        return t.reshape(nc, Bb, G, rep, *t.shape[3:])

    # intra-chunk (diagonal) term: (C·Bᵀ ∘ L) x·dt, L[l, s] = exp(cum_l − cum_s) for s ≤ l
    idx = torch.arange(cl, device=xh.device)
    causal = idx[:, None] >= idx[None, :]
    L = torch.exp((cum[..., :, None] - cum[..., None, :]).masked_fill(~causal, float("-inf")))
    CB = Cc @ Bc.transpose(-1, -2)  # (nc, B, G, l, s), shared by the group's heads
    y = ((heads(L) * CB[:, :, :, None]) @ heads(xdt)).reshape(nc, Bb, H, cl, P)

    # each chunk's own state contribution and its total decay
    in_decay = torch.exp(cum[..., -1:] - cum)  # (nc, B, H, cl)
    new_contrib = (heads(xdt * in_decay[..., None]).transpose(-1, -2) @ Bc[:, :, :, None]
                   ).reshape(nc, Bb, H, P, N)
    chunk_decay = torch.exp(cum[..., -1])  # (nc, B, H)

    states = _prefix_scan(chunk_decay, new_contrib)  # the state after each chunk
    if nc > 1:  # the state entering each chunk; none enters the first
        states_in = torch.cat([torch.zeros_like(states[:1]), states[:-1]])
        y = y + ((Cc[:, :, :, None] @ heads(states_in).transpose(-1, -2)).reshape(nc, Bb, H, cl, P)
                 * torch.exp(cum)[..., None])
    return y.to(xh.dtype).permute(1, 0, 3, 2, 4).reshape(Bb, S, H, P), states[-1]


def _scan_on_shards(xh, dt, Bm, Cm, A_log, dt_bias, G: int, cl: int):
    """``_scan`` on the dry run's DTensors: the SSD is independent across
    batch rows and heads, so each rank scans its own rows and heads (x laid
    out as the policy pins it; dt, A_log and dt_bias on x's heads; B and C
    whole on the heads' mesh dims, sliced to the rank's groups) and no
    collective runs. The gradients of inputs whole where x is sharded are
    pending their sum there (``to_local``'s ``grad_placements``)."""
    from torch.distributed.tensor import Shard

    mesh, xpl = xh.device_mesh, tuple(xh.placements)
    if Shard(1) in xpl:
        raise NotImplementedError("the SSD scan over a sharded sequence")
    dt = constrain(dt, "batch", "seq", "model", sizes=xh.shape[:3])
    Bm, Cm = (constrain(t, "batch", "seq", None) for t in (Bm, Cm))
    A_log, dt_bias = (constrain(t, "model", sizes=xh.shape[2:3]) for t in (A_log, dt_bias))
    xl = xh.to_local()
    dtl, Bl, Cl, Al, bl = (t.to_local(grad_placements=partial(tuple(t.placements), xpl))
                           for t in (dt, Bm, Cm, A_log, dt_bias))
    H, Hl = xh.shape[2], xl.shape[2]
    if Hl != H:  # the groups of the rank's heads
        h0, _ = block(xh.shape, mesh, xpl, 2)
        rep, N = H // G, Bm.shape[-1] // G
        g0, G = h0 // rep, max(Hl // rep, 1)
        Bl, Cl = (t[..., g0 * N:(g0 + G) * N] for t in (Bl, Cl))
    y, last = _scan(xl, dtl, Bl, Cl, Al, bl, G, cl)
    Bb, S, H, P = xh.shape
    spl = tuple(Shard({0: 0, 2: 1}[p.dim]) if p.is_shard() else p for p in xpl)  # (B, H, P, N)
    return from_local(y, mesh, xpl, xh.shape), from_local(last, mesh, spl, (Bb, H, P, last.shape[-1]))


def _ssd(p: dict, u: torch.Tensor, cfg: ArchConfig, eps: float, return_state: bool):
    Bb, S, _ = u.shape
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups

    z, raw_xbc, dt = _proj_inputs(p, u)
    cdt = raw_xbc.dtype
    di = cfg.d_inner
    x, Bm, Cm = F.silu(_causal_conv(raw_xbc, _conv_weight(p, cdt))).split([di, G * N, G * N], dim=-1)

    xh = constrain(x.reshape(Bb, S, H, P), "batch", "seq", "model", None)
    scan = _scan_on_shards if isinstance(xh, DTensor) else _scan
    y, last = scan(xh, dt, Bm, Cm, p["A_log"], p["dt_bias"], G, chunk_len(S, cfg.ssm_chunk))

    y = y + xh * p["D"].to(cdt)[None, None, :, None]
    y = _gated_norm(p["norm"], y.reshape(Bb, S, H * P), z, eps)
    out = constrain(y @ p["out"].to(y.dtype), "batch", "seq", None)  # the partial sums over heads, reduced
    if not return_state:
        return out
    W = cfg.ssm_conv
    tail = raw_xbc[:, max(S - (W - 1), 0):]
    if S < W - 1:  # left-pad with zeros to W − 1 entries
        tail = F.pad(tail, (0, 0, W - 1 - S, 0))
    return out, {"state": last, "conv": tail}


def ssm_forward(p: dict, u: torch.Tensor, cfg: ArchConfig, eps: float = 1e-6) -> torch.Tensor:
    """Full-sequence SSD. u: (B, S, d_model) -> (B, S, d_model)."""
    return _ssd(p, u, cfg, eps, return_state=False)


def ssm_forward_with_state(p: dict, u: torch.Tensor, cfg: ArchConfig, eps: float = 1e-6
                           ) -> tuple[torch.Tensor, dict]:
    """Prefill: the full-sequence SSD and the decode cache it leaves, the
    last state (B, H, P, N) f32 and the last W − 1 conv inputs (B, W − 1,
    d_inner + 2·G·N) in the compute dtype."""
    return _ssd(p, u, cfg, eps, return_state=True)


# ------------------------------------------------------------------- decode


def ssm_init_cache(cfg: ArchConfig, batch: int, dtype, device="cuda") -> dict:
    H, P, N, G, W = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups, cfg.ssm_conv
    ch = cfg.d_inner + 2 * G * N
    return {
        "state": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, W - 1, ch), dtype=dtype, device=device),  # last W−1 conv inputs
    }


def _recur(state: torch.Tensor, xh, Bh, Ch, dt, A_log, dt_bias, D) -> torch.Tensor:
    """One token's recurrence per (row, head) on plain tensors: ``state``
    (B, H, P, N) f32 advanced in place; returns y (B, H, P) f32."""
    xh, Bh, Ch = xh.float(), Bh.float(), Ch.float()
    A = -torch.exp(A_log.float())
    dtv = F.softplus(dt.float() + dt_bias.float())  # (B, H)
    decay = torch.exp(dtv * A)
    new = state * decay[..., None, None] + (xh * dtv[..., None])[..., None] * Bh[:, :, None]
    y = (new @ Ch[..., None])[..., 0]  # (B, H, P)
    state.copy_(new)
    return y + xh * D.float()[None, :, None]


def ssm_decode_step(p: dict, u: torch.Tensor, cache: dict, cfg: ArchConfig, eps: float = 1e-6
                    ) -> tuple[torch.Tensor, dict]:
    """u: (B, 1, d_model) -> (out, cache): the one-token recurrence. The new
    state and conv tail are written into ``cache``'s tensors in place."""
    Bb = u.shape[0]
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    di, rep = cfg.d_inner, H // G
    z, xbc, dt = _proj_inputs(p, u)
    hist = torch.cat([constrain(cache["conv"], "batch", None, None), xbc], dim=1)  # (B, W, ch)
    conv_out = F.silu((hist * _conv_weight(p, xbc.dtype)).sum(1))
    x, Bm, Cm = conv_out[:, :di], conv_out[:, di:di + G * N], conv_out[:, di + G * N:]

    # per (row, head): on the dry run's meshes each rank advances its own rows and heads
    heads = lambda t: constrain(t, "batch", "model", None)
    xh = heads(x.reshape(Bb, H, P))
    Bh, Ch = (heads(t.reshape(Bb, G, N).repeat_interleave(rep, dim=1)) for t in (Bm, Cm))
    dt0 = constrain(dt[:, 0], "batch", "model")
    per_head = (constrain(p[k], "model") for k in ("A_log", "dt_bias", "D"))
    y = on_shards(_recur, cache["state"], xh, Bh, Ch, dt0, *per_head)
    y = _gated_norm(p["norm"], y.reshape(Bb, 1, H * P).to(u.dtype), z, eps)
    out = constrain(y @ p["out"].to(y.dtype), "batch", "seq", None)  # the partial sums over heads, reduced
    cache["conv"].copy_(hist[:, 1:])
    return out, cache
