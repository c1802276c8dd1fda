"""High-level Explainer API — the paper's algorithm as a one-call feature.

    explainer = Explainer(f, method="ig", schedule="paper", n_int=4, m=64)
    result = explainer.attribute(x, baseline, target)

``f(xs, targets) -> (N,)`` is any differentiable scalar model output
(classifier probability, LM next-token log-prob, ...), on ``device``.

Two registries compose here: ``schedule`` — a
``repro_torch.core.schedule.SCHEDULES`` family name (where the quadrature
nodes go) — and ``method`` — a ``repro_torch.core.methods.METHODS`` name
(what accumulates at those nodes).

Stage 2 runs through the port's kernel ops unless a hook is set: on CUDA
tensors they launch the Triton kernels, on CPU tensors they take the plain
versions. Entry points run on ``device="cuda"`` unless the caller passes
another device.

A quick end-to-end example (the quadratic has a linear path integrand, so
the midpoint rule is exact and the completeness gap δ is ~0):

    >>> import torch
    >>> f = lambda xs, targets: (xs ** 2).sum(-1)
    >>> ex = Explainer(f, schedule="uniform", m=8, device="cpu")
    >>> res = ex.attribute(torch.ones(2, 3), torch.zeros(2, 3), None)
    >>> tuple(res.attributions.shape)
    (2, 3)
    >>> bool(res.delta.max() < 1e-4)  # Σφ == f(x) − f(x′) = 3.0
    True
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Union

import numpy as np
import torch

from repro_torch.core import ig, methods as methods_mod, probes
from repro_torch.core import schedule as schedules
from repro_torch.core.ig import IGResult, IGState
from repro_torch.core.methods import MethodSpec
from repro_torch.core.probes import ScalarFn
from repro_torch.core.schedule import Schedule
from repro_torch.kernels.ig_accum.ops import ig_accum
from repro_torch.kernels.interp_accum.ops import interp_accum
from repro_torch.kernels.interpolate.ops import interpolate

# accumulator class -> its kernel op (the stage-2 default when accum_fn is unset)
_ACCUM_KERNELS = {"riemann": ig_accum}


@dataclass
class Explainer:
    """One model function + one (method, schedule) configuration.

    Args:
        f: ``f(xs, targets) -> (N,)`` differentiable scalar model output.
        method: attribution method name in ``methods.METHODS`` (or a spec).
        schedule: schedule family name in ``schedule.SCHEDULES``.
        m: total interpolation steps (the stage-2 budget).
        n_int: stage-1 probe intervals (paper sweeps 2..8).
        chunk: stage-2 step chunk size (0 = all ``m`` at once).
        fused: interpolation composed into the differentiated function, the
            chunk's weighted gradient sum taken as one carry gradient.
        interp_fn / interp_add_fn / accum_fn: stage-2 hooks; the kernel ops
            of ``repro_torch.kernels`` by default.
        device: where inputs are placed and the explanation runs.

    Example (paper schedule on a tiny quadratic):

        >>> import torch
        >>> f = lambda xs, t: (xs ** 2).sum(-1)
        >>> ex = Explainer(f, method="ig", schedule="paper", m=16, n_int=4, device="cpu")
        >>> res = ex.attribute(2.0 * torch.ones(1, 4), torch.zeros(1, 4), None)
        >>> bool(abs(res.attributions.sum() - res.f_x[0]) < 1e-3)
        True
    """

    f: ScalarFn
    method: Union[str, MethodSpec] = "ig"
    schedule: str = "paper"
    m: int = 64
    n_int: int = 4
    power: float = 0.5  # sqrt attenuation (paper); 1.0 = linear
    min_steps: int = 1
    rule: str = "midpoint"
    chunk: int = 0
    fused: bool = False
    interp_fn: Callable = interpolate
    interp_add_fn: Callable = interp_accum
    accum_fn: Optional[Callable] = None  # None: the method class's kernel op
    device: Union[str, torch.device] = "cuda"

    @property
    def spec(self) -> MethodSpec:
        """The resolved ``MethodSpec`` for ``self.method``."""
        return methods_mod.get(self.method)

    def _place(self, *ts):
        return tuple(None if t is None else torch.as_tensor(t, device=self.device) for t in ts)

    # -- fixed-m attribution ----------------------------------------------

    def build_schedule(
        self,
        x: torch.Tensor,
        baseline: torch.Tensor,
        target: Optional[torch.Tensor],
        mask: Optional[torch.Tensor] = None,
        f_x: Optional[torch.Tensor] = None,
    ) -> Schedule:
        """Stage 1 (probe) + step allocation, dispatched via the registry.
        Probe cost: n_int+1 forwards, minus one when ``f_x`` donates the α=1
        endpoint."""
        x, baseline, target, mask, f_x = self._place(x, baseline, target, mask, f_x)
        fam = schedules.family(self.schedule)
        probe = probes.run_probe(
            fam.probe, self.f, x, baseline, target, n_int=self.n_int, mask=mask, known_fx=f_x
        )
        return fam.build(
            probe, self.m, power=self.power, min_steps=self.min_steps, rule=self.rule,
            device=x.device,
        )

    def attribute(
        self,
        x: torch.Tensor,
        baseline: torch.Tensor,
        target: Optional[torch.Tensor],
        mask: Optional[torch.Tensor] = None,
        f_x: Optional[torch.Tensor] = None,
    ) -> IGResult:
        """Fixed-m attribution: stage-1 probe + stage-2 accumulation.

        Args:
            x: (B, *F) inputs; baseline: (B, *F) path start x′.
            target: (B,) ids passed through to ``f`` (``None`` if ``f``
                ignores it).
            mask: optional (B, *L) real-position mask — masked positions
                interpolate to the baseline and attribute exactly 0.
            f_x: optional (B,) known endpoint values f(x) (probe reuse).

        Returns:
            ``IGResult(attributions (B, *F), f_x, f_baseline, delta)``.
        """
        x, baseline, target, mask, f_x = self._place(x, baseline, target, mask, f_x)
        sched = self.build_schedule(x, baseline, target, mask, f_x=f_x)
        return ig.attribute(
            self.f, x, baseline, sched, target, method=self.spec, mask=mask,
            chunk=self.chunk, f_x=f_x, **self.ig_kwargs(),
        )

    # -- adaptive iso-convergence -----------------------------------------

    @property
    def adaptive_chunk(self) -> int:
        """Stage-2 chunk of the resumable path. ``chunk=0`` becomes the base
        rung size ``m`` so every rung's chunk boundaries align with a fixed
        run over the final refined schedule (bit-identity needs the same
        chunking on both sides)."""
        c = self.chunk if self.chunk else self.m
        if self.m % c:
            raise ValueError(f"chunk {c} must divide m {self.m}")
        return c

    def ig_kwargs(self) -> dict:
        """The stage-2 options of ``ig.attribute`` this explainer runs with."""
        return {
            "fused": self.fused,
            "interp_fn": self.interp_fn,
            "interp_add_fn": self.interp_add_fn,
            "accum_fn": self.accum_fn or _ACCUM_KERNELS[self.spec.accum],
        }

    def start(
        self,
        x: torch.Tensor,
        baseline: torch.Tensor,
        target: Optional[torch.Tensor],
        mask: Optional[torch.Tensor] = None,
        f_x: Optional[torch.Tensor] = None,
    ) -> tuple[IGResult, IGState, Schedule]:
        """Rung 0 of the adaptive ladder: probe, build the base schedule,
        accumulate its m nodes, and return the resumable state plus the
        schedule (needed to refine later)."""
        x, baseline, target, mask, f_x = self._place(x, baseline, target, mask, f_x)
        sched = self.build_schedule(x, baseline, target, mask, f_x=f_x)
        res, state = ig.attribute(
            self.f, x, baseline, sched, target, method=self.spec, mask=mask,
            chunk=self.adaptive_chunk, return_state=True, f_x=f_x, **self.ig_kwargs(),
        )
        return res, state, sched

    def resume(
        self,
        x: torch.Tensor,
        baseline: torch.Tensor,
        target: Optional[torch.Tensor],
        new_nodes: Schedule,
        state: IGState,
        mask: Optional[torch.Tensor] = None,
    ) -> tuple[IGResult, IGState]:
        """One ladder hop: accumulate the refined schedule's NEW nodes on top
        of ``state``. ``state_scale=0.5`` re-expresses the old accumulator in
        the refined rung's exactly-halved weights."""
        x, baseline, target, mask = self._place(x, baseline, target, mask)
        return ig.attribute(
            self.f, x, baseline, new_nodes, target, method=self.spec, mask=mask,
            chunk=self.adaptive_chunk, state=state, state_scale=0.5, return_state=True,
            **self.ig_kwargs(),
        )

    def attribute_adaptive(
        self,
        x: torch.Tensor,
        baseline: torch.Tensor,
        target: Optional[torch.Tensor],
        *,
        tol: float = 1e-2,
        m_max: int = 0,
        mask: Optional[torch.Tensor] = None,
    ) -> tuple[IGResult, dict]:
        """δ-feedback early-exit attribution up the m-ladder.

        Runs the base rung (``self.m`` nodes), then repeatedly refines the
        schedule (nested doubling — no prior gradient is discarded) and
        resumes accumulation for the rows whose completeness gap still
        exceeds ``tol · |f(x) − f(x′)|``, until all converge or the ladder
        tops out at ``m_max`` (default ``8·m``). Converged rows exit with the
        rung they converged at; later hops run on the surviving rows only.

        Returns ``(IGResult, info)``: per-example final attributions/δ, and
        ``info`` with per-row ``m_used``/``hops``/``delta``/``threshold``/
        ``converged`` plus aggregate ``total_steps`` (Σ m_used),
        ``probe_forwards``, the ``ladder``, the ``chunk`` and ``n_samples``
        (1: path ensembles are not ported yet).
        """
        x, baseline, target, mask = self._place(x, baseline, target, mask)
        fam = schedules.family(self.schedule)
        ladder = schedules.m_ladder(self.m, m_max if m_max else 8 * self.m)
        B = x.shape[0]
        res, state, sched = self.start(x, baseline, target, mask)

        delta = res.delta.cpu().numpy().copy()
        f_x, f_b = res.f_x.cpu().numpy(), res.f_baseline.cpu().numpy()
        threshold = tol * np.abs(f_x - f_b)
        out_attr = res.attributions.clone()
        m_used = np.full((B,), ladder[0], np.int64)
        hops = np.zeros((B,), np.int64)
        total_steps = B * ladder[0]

        act = np.flatnonzero(delta > threshold)
        # per-example schedules for the survivors (uniform builds a shared
        # (m,) schedule — broadcast so rows can be gathered independently)
        rows = torch.as_tensor(act, device=x.device)
        a_act = sched.alphas.expand(B, -1)[rows]
        w_act = sched.weights.expand(B, -1)[rows]
        acc_act = state.acc[rows]

        for rung in ladder[1:]:
            if act.size == 0:
                break
            n_new = rung // 2
            refined = fam.refine(Schedule(a_act, w_act))
            new_nodes = Schedule(refined.alphas[:, n_new:], refined.weights[:, n_new:])
            res2, st2 = self.resume(
                x[rows], baseline[rows], None if target is None else target[rows], new_nodes,
                IGState(acc_act, res.f_x[rows], res.f_baseline[rows]),
                None if mask is None else mask[rows],
            )
            total_steps += act.size * n_new
            d2 = res2.delta.cpu().numpy()
            out_attr[rows] = res2.attributions
            delta[act] = d2
            m_used[act] = rung
            hops[act] += 1
            keep = d2 > threshold[act]
            act = act[keep]
            rows = torch.as_tensor(act, device=x.device)
            kept = torch.as_tensor(np.flatnonzero(keep), device=x.device)
            a_act, w_act, acc_act = refined.alphas[kept], refined.weights[kept], st2.acc[kept]

        final = IGResult(
            out_attr, res.f_x, res.f_baseline, torch.as_tensor(delta, device=x.device)
        )
        info = {
            "m_used": m_used,
            "hops": hops,
            "delta": delta,
            "threshold": threshold,
            "converged": delta <= threshold,
            "total_steps": int(total_steps),
            "probe_forwards": B * probes.probe_cost(fam.probe, n_int=self.n_int),
            "ladder": ladder,
            "chunk": self.adaptive_chunk,
            "n_samples": 1,
        }
        return final, info
