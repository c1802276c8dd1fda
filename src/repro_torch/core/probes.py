"""Stage 1 of NUIG: probe the model along the path (paper §III Algorithm).

``n_int + 1`` forward-only passes at interval boundaries measure the change
in target probability per interval — the information-content metric. Probes
are batched across (examples × boundaries) into one forward.

``run_probe`` is the registry-facing entry point: every schedule family in
``repro_torch.core.schedule.SCHEDULES`` names one of the probe kinds here.
``target`` may be a dict of per-example tensors (``map_tree``), repeated
along axis 0 to match the folded (batch × probe) axis. ``mask`` pins
padded positions to the baseline. Kinds: "none" (the
uniform family), "boundary" (the ``n_int + 1`` uniform boundaries) and
"refine" (``refined_boundaries``: the boundaries, then ``rounds`` secant
bisections of the largest-|Δf| interval).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.core.paths import interpolate, mask_to_baseline
from repro_torch.core.schedule import Probe

# f: (xs (N, *F), targets) -> (N,) scalar model output (prob / log-prob).
# ``targets`` is None, an (N,) tensor of ids, or a dict of (N, ...) tensors
# (bucketed serving's {"target": ids, "pos": positions}).
ScalarFn = Callable[[torch.Tensor, Any], torch.Tensor]


def map_tree(fn: Callable, target: Any, *rest: Any) -> Any:
    """``fn`` leafwise over a target — None, a tensor, or a dict of tensors
    (``repro``'s pytree targets); ``rest`` are targets of the same form.

        >>> map_tree(lambda t: t + 1, {"pos": torch.tensor([1])})
        {'pos': tensor([2])}
    """
    if target is None:
        return None
    if isinstance(target, dict):
        return {k: fn(v, *(r[k] for r in rest)) for k, v in target.items()}
    return fn(target, *rest)


def repeat_tree(target: Any, k: int) -> Any:
    """Repeat each row k× along axis 0: (B, ...) -> (B*k, ...), leafwise."""
    return map_tree(lambda t: t.repeat_interleave(k, dim=0), target)


def cat_tree(a: Any, b: Any) -> Any:
    """Concatenate two targets of one form along axis 0, leafwise."""
    return map_tree(lambda x, y: torch.cat([x, y], dim=0), a, b)


@torch.no_grad()
def boundary_values(
    f: ScalarFn,
    x: torch.Tensor,
    baseline: torch.Tensor,
    target: Any,
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


@torch.no_grad()
def refined_boundaries(
    f: ScalarFn,
    x: torch.Tensor,
    baseline: torch.Tensor,
    target: Any,
    n0: int,
    rounds: int,
    *,
    mask: Optional[torch.Tensor] = None,
    known_fx: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Beyond-paper secant-refine: bisect the largest-|Δf| interval, one
    batched probe per round (fixed shapes: capacity n0+1+rounds).

    Returns (boundaries (B, K), values (B, K)) sorted by boundary; padding
    duplicates the rightmost boundary (zero-width intervals, zero Δf).
    ``known_fx`` seeds the α=1 boundary value (see ``boundary_values``);
    bisection never revisits the endpoints, so the splice is exact. Ties
    pick the first interval (``torch.argmax``, as ``jnp.argmax``) and the
    re-sort is stable.
    """
    B = x.shape[0]
    x = mask_to_baseline(x, baseline, mask)
    vals0 = boundary_values(f, x, baseline, target, n0, known_fx=known_fx)
    b0 = (torch.arange(n0 + 1, device=x.device) / n0).expand(B, -1)
    b = torch.cat([b0, torch.ones((B, rounds), device=x.device)], dim=1)
    v = torch.cat([vals0, vals0[:, -1:].expand(-1, rounds)], dim=1)
    slot = b.shape[1] - 1  # a padding slot (the rightmost duplicate) takes the new point
    for _ in range(rounds):
        d = torch.diff(v, dim=1).abs() * (torch.diff(b, dim=1) > 1e-9)
        i = torch.argmax(d, dim=1, keepdim=True)  # (B, 1) interval to bisect
        mid = 0.5 * (torch.gather(b, 1, i) + torch.gather(b, 1, i + 1))[:, 0]
        xm = baseline + mid.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype) * (x - baseline)
        b = b.clone()
        v = v.clone()
        b[:, slot] = mid
        v[:, slot] = f(xm, target).to(v.dtype)
        order = torch.argsort(b, dim=1, stable=True)
        b, v = torch.gather(b, 1, order), torch.gather(v, 1, order)
    return b, v


def probe_cost(kind: str, *, n_int: int = 4, rounds: int = 4, known_fx: bool = False) -> int:
    """Forward passes a probe kind spends per example (0 gradient steps).

    ``known_fx`` is the probe-reuse contract: the α=1 forward is donated, so
    probing pays one fewer forward per example.
    """
    if kind == "none":
        return 0
    if kind == "boundary":
        base = n_int + 1
    elif kind == "refine":
        base = n_int + 1 + rounds
    else:
        raise ValueError(f"unknown probe kind {kind!r}")
    return base - 1 if known_fx else base


def run_probe(
    kind: str,
    f: ScalarFn,
    x: torch.Tensor,
    baseline: torch.Tensor,
    target: Any,
    *,
    n_int: int = 4,
    rounds: int = 4,
    mask: Optional[torch.Tensor] = None,
    known_fx: Optional[torch.Tensor] = None,
) -> Optional[Probe]:
    """Run the stage-1 probe a schedule family declares ("none" | "boundary"
    | "refine"). ``known_fx`` (B,) donates the α=1 endpoint value (see
    ``boundary_values``); ``rounds`` is the refine probe's bisections."""
    if kind == "none":
        return None
    if kind == "boundary":
        vals = boundary_values(f, x, baseline, target, n_int, mask=mask, known_fx=known_fx)
        bounds = (torch.arange(n_int + 1, device=vals.device) / n_int).expand(vals.shape)
        return Probe(bounds.float(), vals)
    if kind == "refine":
        return Probe(*refined_boundaries(f, x, baseline, target, n_int, rounds, mask=mask,
                                         known_fx=known_fx))
    raise ValueError(f"unknown probe kind {kind!r}")
