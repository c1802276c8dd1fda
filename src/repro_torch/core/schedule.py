"""Interpolation schedules — the paper's contribution lives here.

A *schedule* is a pair ``(alphas[m], weights[m])`` approximating
``∫_0^1 g(α) dα ≈ Σ_k w_k g(α_k)``; the same stage 2 serves any allocation.

Ported here: ``uniform`` (baseline IG) and ``paper`` (faithful NUIG: n_int
equal intervals, integer step counts ∝ sqrt(|Δf|) by largest remainder,
uniform in each interval), the nested refinement of the adaptive ladder,
and the ``SCHEDULES`` registry. ``repro.core.schedule``'s ``warp``,
``gauss`` and ``from_boundaries`` (the ``refine`` family) are not ported
yet. Functions are batched over examples where noted.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch


class Schedule(NamedTuple):
    alphas: torch.Tensor  # (m,) or (B, m) — path positions in [0, 1]
    weights: torch.Tensor  # same shape — Riemann/quadrature weights, sum == 1


# ----------------------------------------------------------------- uniform


def uniform(m: int, rule: str = "midpoint", *, device="cuda") -> Schedule:
    """Baseline IG discretization (paper Eq. 2 uses the 'right'/'left' form).

    Args:
        m: node count; rule: "midpoint" | "left" | "right" | "trapezoid".

    Returns a ``Schedule`` with Σw == 1 for every rule and m:

        >>> s = uniform(4, device="cpu")
        >>> [round(float(a), 3) for a in s.alphas]
        [0.125, 0.375, 0.625, 0.875]
        >>> float(s.weights.sum())
        1.0
    """
    k = torch.arange(m, device=device)
    if rule == "midpoint":
        a = (k + 0.5) / m
        w = torch.full((m,), 1.0 / m, device=device)
    elif rule == "left":
        a = k / m
        w = torch.full((m,), 1.0 / m, device=device)
    elif rule == "right":
        a = (k + 1) / m
        w = torch.full((m,), 1.0 / m, device=device)
    elif rule == "trapezoid":
        if m == 1:
            # one node integrating [0, 1] carries the full measure; the
            # midpoint is its unbiased position
            a = torch.tensor([0.5], device=device)
            w = torch.tensor([1.0], device=device)
        else:
            a = k / (m - 1)
            w = torch.full((m,), 1.0 / (m - 1), device=device)
            w[0] *= 0.5
            w[-1] *= 0.5
    else:
        raise ValueError(f"unknown rule {rule!r}")
    return Schedule(a.float(), w.float())


# ------------------------------------------------- paper step allocation


def normalized_deltas(boundary_vals: torch.Tensor, power: float = 0.5) -> torch.Tensor:
    """|Δf| per interval -> importance density, normalized to sum 1.

    boundary_vals: (..., n_int+1) stage-1 probe outputs f(x(α_i)).
    ``power=0.5`` is the paper's sqrt attenuation (§III Algorithm).
    """
    d = torch.diff(boundary_vals, dim=-1).abs() ** power  # (..., n_int)
    # flat-region fallback: if all deltas vanish, fall back to uniform
    s = d.sum(-1, keepdim=True)
    n = d.shape[-1]
    return torch.where(s > 1e-12, d / s.clamp_min(1e-12), torch.full_like(d, 1.0 / n))


def allocate_steps(importance: torch.Tensor, m: int, min_steps: int = 1) -> torch.Tensor:
    """Integer largest-remainder allocation of m steps ∝ importance.

    importance: (..., n_int) normalized;  returns int32 (..., n_int), sum == m.
    ``min_steps`` guards the paper's n_int>8 pathology (starved intervals).
    Tied remainders go to the lower interval index (a stable sort), as in
    ``repro.core.schedule.allocate_steps``.
    """
    n = importance.shape[-1]
    if m < n * min_steps:
        raise ValueError(f"m={m} cannot give {n} intervals {min_steps} step(s) each")
    budget = m - n * min_steps
    q = importance * budget
    base = torch.floor(q).to(torch.int32)
    rem = q - base
    short = budget - base.sum(-1, keepdim=True)  # how many +1s to hand out
    # rank remainders descending; slots with rank < short get +1
    order = torch.argsort(-rem, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    bonus = (rank < short).to(torch.int32)
    return base + bonus + min_steps


def from_allocation(
    alloc: torch.Tensor, m: int, lo: float = 0.0, hi: float = 1.0, rule: str = "midpoint"
) -> Schedule:
    """Uniform-in-interval schedule from integer per-interval step counts.

    alloc: (..., n_int) int summing to m. Step k is mapped to its interval by
    a searchsorted-style comparison, so every shape is static.
    """
    n = alloc.shape[-1]
    alloc = alloc.long()
    csum = torch.cumsum(alloc, dim=-1)  # (..., n)
    k = torch.arange(m, device=alloc.device)  # (m,)
    # interval of step k: first i with csum[i] > k
    iv = (k[..., None, :] >= csum[..., :, None]).sum(-2)  # (..., m)
    starts = csum - alloc  # first step index of each interval
    take = lambda t: torch.gather(t, -1, iv)
    m_i = take(alloc)  # steps in k's interval
    r = k - take(starts)  # rank of k within its interval
    width = (hi - lo) / n
    off = {"midpoint": 0.5, "left": 0.0, "right": 1.0}[rule]
    a = lo + (iv + (r + off) / m_i) * width
    w = width / m_i
    return Schedule(a.float(), w.float())


def paper(
    boundary_vals: torch.Tensor,
    m: int,
    *,
    power: float = 0.5,
    min_steps: int = 1,
    rule: str = "midpoint",
) -> Schedule:
    """Faithful NUIG schedule from stage-1 probe values (paper §III)."""
    imp = normalized_deltas(boundary_vals, power)
    alloc = allocate_steps(imp, m, min_steps)
    return from_allocation(alloc, m, rule=rule)


# ------------------------------------------- nested refinement (adaptive)


_BETA = (math.sqrt(5.0 / 3.0) - 1.0) / 2.0


def refine_nested(sched: Schedule) -> Schedule:
    """Double a schedule's node count while keeping every old node — the
    escalation step of the adaptive ladder.

    Each node owns a *cell*: sort nodes by α and partition [0, 1] by the
    cumulative weights. Split every cell and drop one child node in the half
    the old node does not occupy (reflected through the cell centre; for
    near-centred parents, adjacent cells pair up and the children sit β·w
    either side, β = (√(5/3) − 1)/2, which matches the pair's first two
    moments). Old weights halve EXACTLY (power-of-two scaling), which is
    what makes a resumed accumulator bit-identical to a fresh run over the
    refined schedule.

    Storage order is load-bearing: ``[old nodes (original order), child
    nodes (parent order)]``, NOT sorted, so a chunked pass over the refined
    schedule visits exactly the prefix an earlier rung already accumulated.

        >>> s = uniform(4, device="cpu")
        >>> r = refine_nested(s)
        >>> tuple(r.alphas.shape), bool((r.alphas[:4] == s.alphas).all())
        ((8,), True)
        >>> bool((r.weights[:4] == 0.5 * s.weights).all())
        True
    """
    a, w = sched.alphas, sched.weights
    order = torch.argsort(a, dim=-1, stable=True)
    inv = torch.argsort(order, dim=-1, stable=True)
    a_s, w_s = torch.gather(a, -1, order), torch.gather(w, -1, order)
    # cell edges summed in f64 and rounded once: the same on every device
    # (torch.cumsum is a sequential f64 sum on the CPU and a parallel scan on
    # CUDA in f32). ``repro`` sums in f32 in an order its JAX version picks,
    # so a child can land elsewhere where |off| ties 0.25·w within an ulp
    right = torch.cumsum(w_s.double(), dim=-1).float()
    left = right - w_s
    center = left + 0.5 * w_s
    beta = torch.tensor(_BETA, dtype=torch.float32, device=a.device)
    off = a_s - center
    near = off.abs() < 0.25 * w_s
    parity = (torch.arange(a.shape[-1], device=a.device) % 2) == 0
    pair_child = torch.where(parity, center - beta * w_s, center + beta * w_s)
    child_s = torch.where(near, pair_child, 2.0 * center - a_s)
    child = torch.gather(child_s, -1, inv)  # parent-aligned storage order
    a2 = torch.cat([a, child], dim=-1)
    w2 = torch.cat([0.5 * w, 0.5 * w], dim=-1)
    return Schedule(a2.float(), w2.float())


def m_ladder(m: int, m_max: int) -> tuple[int, ...]:
    """Escalation rungs m, 2m, 4m, ... up to (at most) m_max.

        >>> m_ladder(16, 64)
        (16, 32, 64)
        >>> m_ladder(8, 100)  # never overshoots m_max
        (8, 16, 32, 64)
    """
    if not (m >= 1 and m_max >= m):
        raise ValueError(f"need 1 <= m <= m_max, got m={m}, m_max={m_max}")
    out = [m]
    while out[-1] * 2 <= m_max:
        out.append(out[-1] * 2)
    return tuple(out)


# ------------------------------------------------------------------ registry


class Probe(NamedTuple):
    """Stage-1 output, schedule-family agnostic.

    bounds: (..., K) sorted probe positions in [0, 1];
    vals:   (..., K) f at those positions.
    """

    bounds: torch.Tensor
    vals: torch.Tensor


@dataclass(frozen=True)
class ScheduleFamily:
    """One schedule family = a probe spec + a uniform-signature builder.

    ``probe`` names the stage-1 pass the caller must run ("none" |
    "boundary" — see ``repro_torch.core.probes.run_probe``); ``build`` maps
    its result to a Schedule on ``device``. ``refine`` is the family's
    nested-refinement step for the adaptive ladder.
    """

    name: str
    probe: str  # "none" | "boundary"
    build: Callable[..., Schedule]
    refine: Callable[[Schedule], Schedule] = refine_nested


def _build_uniform(
    probe: Optional[Probe], m: int, *, power: float, min_steps: int, rule: str, device
) -> Schedule:
    return uniform(m, rule, device=device)


def _build_paper(
    probe: Optional[Probe], m: int, *, power: float, min_steps: int, rule: str, device
) -> Schedule:
    return paper(probe.vals, m, power=power, min_steps=min_steps, rule=rule)


SCHEDULES: dict[str, ScheduleFamily] = {
    "uniform": ScheduleFamily("uniform", "none", _build_uniform),
    "paper": ScheduleFamily("paper", "boundary", _build_paper),
}


def family(name: str) -> ScheduleFamily:
    """Look up a registered ``ScheduleFamily`` by name.

        >>> sorted(SCHEDULES)
        ['paper', 'uniform']
        >>> family("paper").probe
        'boundary'
    """
    if name not in SCHEDULES:
        raise ValueError(f"unknown schedule {name!r}; known: {sorted(SCHEDULES)}")
    return SCHEDULES[name]
