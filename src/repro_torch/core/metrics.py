"""Attribution quality metrics.

convergence_delta — the paper's δ (Eq. 3, completeness gap): the *only*
metric the paper tunes against; iso-convergence = equal δ.
"""
from __future__ import annotations

import torch


def convergence_delta(
    attributions: torch.Tensor, f_x: torch.Tensor, f_baseline: torch.Tensor
) -> torch.Tensor:
    """δ = |Σ_i φ_i − (f(x) − f(x'))|  per example (Eq. 3)."""
    B = attributions.shape[0]
    return (attributions.reshape(B, -1).sum(-1) - (f_x - f_baseline)).abs()


def completeness_satisfied(delta: torch.Tensor, tol: float) -> torch.Tensor:
    return delta <= tol
