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
``repro`` pins the heads to its mesh axis; on one card that has no meaning
and is dropped.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import ParamDef


def ssm_def(cfg: ArchConfig) -> dict:
    d, di = cfg.d_model, cfg.d_inner
    G, N, H, W = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    return {
        "in_z": ParamDef((d, di)),
        "in_x": ParamDef((d, di)),
        "in_B": ParamDef((d, G * N)),
        "in_C": ParamDef((d, G * N)),
        "in_dt": ParamDef((d, H)),
        "conv_x": ParamDef((W, di), scale=0.5),
        "conv_B": ParamDef((W, G * N), scale=0.5),
        "conv_C": ParamDef((W, G * N), scale=0.5),
        "A_log": ParamDef((H,), "zeros"),
        "D": ParamDef((H,), "ones"),
        "dt_bias": ParamDef((H,), "zeros"),
        "norm": ParamDef((di,), "ones"),
        "out": ParamDef((di, d)),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence (B, S, C) by shifted adds."""
    W, S = w.shape[0], x.shape[1]
    out = x * w[-1]
    for i in range(1, W):
        out = out + F.pad(x, (0, 0, i, 0))[:, :S] * w[W - 1 - i]
    return out


def _gated_norm(scale: torch.Tensor, y: torch.Tensor, z: torch.Tensor, eps: float) -> torch.Tensor:
    g32 = (y * F.silu(z)).float()
    var = g32.square().mean(-1, keepdim=True)
    return (g32 * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def _proj_inputs(p: dict, u: torch.Tensor):
    """z, the conv's input x|B|C and dt: the five projections as one product
    (their weights side by side)."""
    w = torch.cat([p[k] for k in ("in_z", "in_x", "in_B", "in_C", "in_dt")], dim=1).to(u.dtype)
    di = p["in_z"].shape[1]
    z, xbc, dt = (u @ w).split([di, w.shape[1] - di - p["in_dt"].shape[1], p["in_dt"].shape[1]], dim=-1)
    return z, xbc, dt


def _conv_weight(p: dict, dtype) -> torch.Tensor:
    """The depthwise conv's weights over the channels x|B|C, (W, channels)."""
    return torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=-1).to(dtype)


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


def _ssd(p: dict, u: torch.Tensor, cfg: ArchConfig, eps: float, return_state: bool):
    Bb, S, _ = u.shape
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    rep = H // G
    cl = chunk_len(S, cfg.ssm_chunk)
    nc = S // cl

    z, raw_xbc, dt = _proj_inputs(p, u)
    cdt = raw_xbc.dtype
    di = cfg.d_inner
    x, Bm, Cm = F.silu(_causal_conv(raw_xbc, _conv_weight(p, cdt))).split([di, G * N, G * N], dim=-1)

    xh = x.reshape(Bb, S, H, P)
    A = -torch.exp(p["A_log"].float())  # (H,)
    dt = F.softplus(dt.float() + p["dt_bias"].float())  # (B, S, H)

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
    idx = torch.arange(cl, device=u.device)
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

    y = y.to(cdt).permute(1, 0, 3, 2, 4).reshape(Bb, S, H, P)
    y = y + xh * p["D"].to(cdt)[None, None, :, None]
    y = _gated_norm(p["norm"], y.reshape(Bb, S, H * P), z, eps)
    out = y @ p["out"].to(y.dtype)
    if not return_state:
        return out
    W = cfg.ssm_conv
    tail = raw_xbc[:, max(S - (W - 1), 0):]
    if S < W - 1:  # left-pad with zeros to W − 1 entries
        tail = F.pad(tail, (0, 0, W - 1 - S, 0))
    return out, {"state": states[-1], "conv": tail}


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


def ssm_decode_step(p: dict, u: torch.Tensor, cache: dict, cfg: ArchConfig, eps: float = 1e-6
                    ) -> tuple[torch.Tensor, dict]:
    """u: (B, 1, d_model) -> (out, cache): the one-token recurrence. The new
    state and conv tail are written into ``cache``'s tensors in place."""
    Bb = u.shape[0]
    H, P, N, G = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups
    di, rep = cfg.d_inner, H // G
    z, xbc, dt = _proj_inputs(p, u)
    hist = torch.cat([cache["conv"], xbc], dim=1)  # (B, W, ch)
    conv_out = F.silu((hist * _conv_weight(p, xbc.dtype)).sum(1))
    x, Bm, Cm = conv_out[:, :di], conv_out[:, di:di + G * N], conv_out[:, di + G * N:]

    xh = x.reshape(Bb, H, P).float()
    Bh = Bm.reshape(Bb, G, N).repeat_interleave(rep, dim=1).float()
    Ch = Cm.reshape(Bb, G, N).repeat_interleave(rep, dim=1).float()
    A = -torch.exp(p["A_log"].float())
    dtv = F.softplus(dt[:, 0].float() + p["dt_bias"].float())  # (B, H)

    decay = torch.exp(dtv * A)
    state = cache["state"] * decay[..., None, None] + (xh * dtv[..., None])[..., None] * Bh[:, :, None]
    y = (state @ Ch[..., None])[..., 0]  # (B, H, P)
    y = y + xh * p["D"].float()[None, :, None]
    y = _gated_norm(p["norm"], y.reshape(Bb, 1, H * P).to(u.dtype), z, eps)
    out = y @ p["out"].to(y.dtype)
    cache["state"].copy_(state)
    cache["conv"].copy_(hist[:, 1:])
    return out, cache
