"""Plain PyTorch version of the interpolation kernel."""
from __future__ import annotations

import torch


def interpolate_ref(x: torch.Tensor, baseline: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
    """x, baseline: (B, F);  alphas: (B, K)  ->  (B, K, F), computed in f32.

    out[b, k, f] = baseline[b, f] + alphas[b, k] * (x[b, f] - baseline[b, f])
    """
    a = alphas[..., None].float()
    xe = x[:, None].float()
    be = baseline[:, None].float()
    return (be + a * (xe - be)).to(x.dtype)
