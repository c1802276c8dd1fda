"""Stage 1 of NUIG: probe the model along the path (paper §III Algorithm).

``n_int + 1`` forward-only passes at interval boundaries measure the change
in target probability per interval — the information-content metric. Probes
are batched across (examples × boundaries) into one forward.

``run_probe`` is the registry-facing entry point: every schedule family in
``repro_torch.core.schedule.SCHEDULES`` names one of the probe kinds here.
``mask`` pins padded positions to the baseline. The secant-refine probe
(``repro.core.probes.refined_boundaries``) is not ported yet.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.paths import interpolate, mask_to_baseline
from repro_torch.core.schedule import Probe

# f: (xs (N, *F), targets (N,)) -> (N,) scalar model output (prob / log-prob).
ScalarFn = Callable[[torch.Tensor, Optional[torch.Tensor]], torch.Tensor]


def repeat_tree(target: Optional[torch.Tensor], k: int) -> Optional[torch.Tensor]:
    """Repeat each row k× along axis 0: (B, ...) -> (B*k, ...); None stays None."""
    return None if target is None else target.repeat_interleave(k, dim=0)


@torch.no_grad()
def boundary_values(
    f: ScalarFn,
    x: torch.Tensor,
    baseline: torch.Tensor,
    target: Optional[torch.Tensor],
    n_int: int,
    *,
    mask: Optional[torch.Tensor] = None,
    known_fx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """f at the n_int+1 uniform interval boundaries. Returns (B, n_int+1).

    ``known_fx`` is the probe-reuse contract: the α=1 boundary IS ``f(x)``,
    so a caller that already holds it passes the (B,) value, only the n_int
    boundaries below 1 are evaluated, and the value is spliced into the
    last slot.
    """
    B = x.shape[0]
    x = mask_to_baseline(x, baseline, mask)
    n = n_int + 1 if known_fx is None else n_int  # boundaries to evaluate
    alphas = torch.arange(n, device=x.device) / n_int
    xi = interpolate(x, baseline, alphas)  # (B, n, *F)
    vals = f(xi.reshape((B * n,) + x.shape[1:]), repeat_tree(target, n)).reshape(B, n)
    if known_fx is None:
        return vals
    return torch.cat([vals, known_fx.to(vals.dtype)[:, None]], dim=1)


def probe_cost(kind: str, *, n_int: int = 4, known_fx: bool = False) -> int:
    """Forward passes a probe kind spends per example (0 gradient steps).

    ``known_fx`` is the probe-reuse contract: the α=1 forward is donated, so
    probing pays one fewer forward per example.
    """
    if kind == "none":
        return 0
    if kind == "boundary":
        return n_int if known_fx else n_int + 1
    raise ValueError(f"unknown probe kind {kind!r}")


def run_probe(
    kind: str,
    f: ScalarFn,
    x: torch.Tensor,
    baseline: torch.Tensor,
    target: Optional[torch.Tensor],
    *,
    n_int: int = 4,
    mask: Optional[torch.Tensor] = None,
    known_fx: Optional[torch.Tensor] = None,
) -> Optional[Probe]:
    """Run the stage-1 probe a schedule family declares ("none" | "boundary").
    ``known_fx`` (B,) donates the α=1 endpoint value (see ``boundary_values``)."""
    if kind == "none":
        return None
    if kind == "boundary":
        vals = boundary_values(f, x, baseline, target, n_int, mask=mask, known_fx=known_fx)
        bounds = (torch.arange(n_int + 1, device=vals.device) / n_int).expand(vals.shape)
        return Probe(bounds.float(), vals)
    raise ValueError(f"unknown probe kind {kind!r}")
