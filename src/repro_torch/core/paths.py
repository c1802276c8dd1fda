"""Straight-line IG path (Eq. 1): x(α) = x' + α (x - x')."""
from __future__ import annotations

from typing import Optional

import torch


def mask_to_baseline(
    x: torch.Tensor, baseline: torch.Tensor, mask: Optional[torch.Tensor]
) -> torch.Tensor:
    """Pin masked-out positions exactly to the baseline (identity w/o mask).

    mask: (B, *L) with L a prefix of x's feature dims; 1/True = real.
    """
    if mask is None:
        return x
    m = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim()))
    return torch.where(m.bool(), x, baseline)


def interpolate(
    x: torch.Tensor,
    baseline: torch.Tensor,
    alphas: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Batch of interpolants along the straight-line path.

    x, baseline: (B, *F);  alphas: (K,) or (B, K)  ->  (B, K, *F), computed
    at input precision. mask: optional (B, *L) real-position mask (L a
    prefix of F) — masked positions stay exactly at the baseline.
    """
    x = mask_to_baseline(x, baseline, mask)
    nf = x.dim() - 1
    if alphas.dim() == 1:
        a = alphas.reshape((1, -1) + (1,) * nf)
    else:
        a = alphas.reshape(alphas.shape + (1,) * nf)
    xe, be = x[:, None], baseline[:, None]
    return (be + a.to(x.dtype) * (xe - be)).to(x.dtype)


def interp_add(
    x: torch.Tensor,
    baseline: torch.Tensor,
    alphas: torch.Tensor,
    carry: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Interpolants plus an additive f32 carry — the fused-stage-2 unit.

    x, baseline: (B, *F); alphas: (K,) or (B, K); carry: (B, *F) f32
    (broadcast over the step axis) or (B, K, *F) f32 (per step). Returns
    (B, K, *F) in ``x.dtype``.

    Dtype contract: the interpolants come from ``interpolate`` at INPUT
    precision, so at ``carry == 0`` the output equals the unfused path's
    interpolants even under bf16; the carry add is lifted to f32, so the
    carry's gradient (the accumulator increment) reduces over the step axis
    in f32 whatever the model dtype.
    """
    xi = interpolate(x, baseline, alphas, mask=mask).float()
    if carry.dim() == x.dim():  # (B, *F): broadcast over the step axis
        carry = carry[:, None]
    return (xi + carry).to(x.dtype)


def at_alpha(x: torch.Tensor, baseline: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Single path point; alpha: () or (B,)."""
    a = alpha.reshape((-1,) + (1,) * (x.dim() - 1)) if alpha.dim() else alpha
    return (baseline + a.to(x.dtype) * (x - baseline)).to(x.dtype)
