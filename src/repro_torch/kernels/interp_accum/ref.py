"""Plain PyTorch versions of the fused interp-into-backward kernels."""
from __future__ import annotations

import torch


def interp_add_ref(
    x: torch.Tensor, baseline: torch.Tensor, alphas: torch.Tensor, carry: torch.Tensor
) -> torch.Tensor:
    """x, baseline: (B, F); alphas: (B, K); carry: (B, F) or (B, K, F) f32.

    out[b, k, f] = baseline[b, f] + alphas[b, k]·(x − baseline)[b, f]
                   + carry[b, (k,) f]

    Interpolation at INPUT precision, then the carry add in f32.
    """
    a = alphas.to(x.dtype)[:, :, None]
    xi = (baseline[:, None, :] + a * (x - baseline)[:, None, :]).float()
    u = carry[:, None, :] if carry.dim() == 2 else carry
    return (xi + u).to(x.dtype)


def accum_cot_ref(grads: torch.Tensor) -> torch.Tensor:
    """grads (B, K, F) -> (B, F) f32 = Σ_k grads[:, k] (f32 reduction)."""
    return grads.float().sum(1)
