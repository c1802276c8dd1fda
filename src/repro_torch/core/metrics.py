"""Attribution quality metrics.

convergence_delta — the paper's δ (Eq. 3, completeness gap): the *only*
metric the paper tunes against; iso-convergence = equal δ.

insertion/deletion AUC — beyond-paper sanity metric for heatmap quality
(higher insertion AUC / lower deletion AUC = better ordering of features).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.probes import ScalarFn


def convergence_delta(
    attributions: torch.Tensor, f_x: torch.Tensor, f_baseline: torch.Tensor
) -> torch.Tensor:
    """δ = |Σ_i φ_i − (f(x) − f(x'))|  per example (Eq. 3)."""
    B = attributions.shape[0]
    return (attributions.reshape(B, -1).sum(-1) - (f_x - f_baseline)).abs()


def completeness_satisfied(delta: torch.Tensor, tol: float) -> torch.Tensor:
    return delta <= tol


@torch.no_grad()
def insertion_deletion_auc(
    f: ScalarFn,
    x: torch.Tensor,
    baseline: torch.Tensor,
    attributions: torch.Tensor,
    target: Optional[torch.Tensor],
    steps: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Insert (resp. delete) features in decreasing-attribution order and
    trace f; returns (insertion_auc, deletion_auc), each (B,).

    Features are ranked with a stable sort (ties keep index order, as
    ``jnp.argsort``); each curve has steps+1 points and its area is the
    trapezoid rule in ``jnp.trapezoid``'s order of operations, over [0, 1].
    """
    B = x.shape[0]
    flat_x, flat_b = x.reshape(B, -1), baseline.reshape(B, -1)
    order = torch.argsort(-attributions.reshape(B, -1), dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)  # rank of each feature
    n = flat_x.shape[-1]

    def curve(insert: bool) -> torch.Tensor:
        vals = []
        for i in range(steps + 1):
            on = rank < (i / steps) * n  # top-k features "on"
            xs = torch.where(on, flat_x, flat_b) if insert else torch.where(on, flat_b, flat_x)
            vals.append(f(xs.reshape(x.shape), target))
        y = torch.stack(vals).transpose(0, 1)  # (B, steps+1)
        return 0.5 * (y[..., 1:] + y[..., :-1]).sum(-1) / steps

    return curve(True), curve(False)
