"""Core layers of ``repro.models.layers``: RMSNorm and the SwiGLU MLP.

Parameters keep ``repro``'s layouts (``mlp`` weights (d, f) and (f, d) for
``x @ w``). ``repro`` pins the MLP hidden to its tensor-parallel axis with
``sharding.context.constrain``; on one card that has no meaning and is
dropped. ``rope``, the embeddings and the chunked loss are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis with f32 statistics, cast back to x.dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (y * p["scale"].float()).to(x.dtype)


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x W_gate) ∘ x W_up) W_o."""
    dt = x.dtype
    h = F.silu(x @ p["wi_gate"].to(dt)) * (x @ p["wi_up"].to(dt))
    return h @ p["wo"].to(dt)
