"""High-level Explainer API — the paper's algorithm as a one-call feature.

    explainer = Explainer(f, method="ig", schedule="paper", n_int=4, m=64)
    result = explainer.attribute(x, baseline, target)

``f(xs, targets) -> (N,)`` is any differentiable scalar model output
(classifier probability, LM next-token log-prob, ...), on ``device``.

Two registries compose here: ``schedule`` — a
``repro_torch.core.schedule.SCHEDULES`` family name (where the quadrature
nodes go: uniform / paper / warp / gauss / refine) — and ``method`` — a
``repro_torch.core.methods.METHODS`` name (what accumulates at those nodes:
ig / idgi / noise_tunnel / expected_grad). Every method rides every
schedule; the path ensembles (noise_tunnel, expected_grad) expand each
example to ``n_samples`` contiguous rows before stage 1 and reduce (mean
over samples) after stage 2, so stage 2 only ever sees per-row problems.
Their draw comes from ``torch.Generator(device).manual_seed(sample_seed)``
unless the caller hands in the standard normals (``draw=``).

Stage 2 runs through the port's kernel ops unless a hook is set: on CUDA
tensors they launch the Triton kernels, on CPU tensors they take the plain
versions. Entry points run on ``device="cuda"`` unless the caller passes
another device.

Under a device mesh (``mesh=``, ``mesh_rules=``), ``attribute_adaptive``'s
rung calls run data-parallel over the mesh's ranks (``sharding.dispatch``):
survivors are padded up to a multiple of the data-parallel extent so every
hop shards, the cache keys carry the mesh's (axis, size) pairs, and a call
whose batch does not divide dp runs on this rank alone and is counted in
``info["mesh_fallbacks"]``. ``repro``'s ``jitted``/``aot`` have no
counterpart: there is no XLA program to compile.

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

from dataclasses import dataclass, fields
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from repro_torch.core import ig, methods as methods_mod, probes
from repro_torch.core import schedule as schedules
from repro_torch.core.fingerprint import params_digest, reachable_tensors
from repro_torch.core.ig import IGResult, IGState
from repro_torch.core.methods import MethodSpec
from repro_torch.core.probes import ScalarFn, map_tree, repeat_tree
from repro_torch.core.schedule import Schedule
from repro_torch.kernels.ig_accum.ops import ig_accum, ig_accum_idgi
from repro_torch.kernels.interp_accum.ops import interp_accum
from repro_torch.kernels.interpolate.ops import interpolate

# accumulator class -> its kernel op (the stage-2 default when accum_fn is unset)
_ACCUM_KERNELS = {"riemann": ig_accum, "idgi": ig_accum_idgi}


@dataclass
class Explainer:
    """One model function + one (method, schedule) configuration.

    Args:
        f: ``f(xs, targets) -> (N,)`` differentiable scalar model output.
        method: attribution method name in ``methods.METHODS`` (or a spec).
        schedule: schedule family name in ``schedule.SCHEDULES``.
        m: total interpolation steps (the stage-2 budget).
        n_int: stage-1 probe intervals (paper sweeps 2..8).
        refine_rounds: bisections of the "refine" family's probe.
        chunk: stage-2 step chunk size (0 = all ``m`` at once).
        fused: interpolation composed into the differentiated function (the
            gradients taken w.r.t. an f32 carry; see ``ig.attribute``).
        interp_fn / interp_add_fn / accum_fn: stage-2 hooks; the kernel ops
            of ``repro_torch.kernels`` by default.
        n_samples / sigma: path-ensemble size and perturbation scale (0 =
            the method's registered default).
        sample_seed: seeds the ensemble's draw, so one configuration always
            draws the same paths (adaptive runs can be bit-compared with
            fixed runs).
        device: where inputs are placed and the explanation runs.
        mesh / mesh_rules: an optional ``DeviceMesh`` and the rules of its
            data axes: ``attribute_adaptive`` shards its rung calls' rows
            over the mesh's ranks, whose workers serve an ``Explainer`` of
            their own (``sharding.dispatch.worker_loop``).

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
    refine_rounds: int = 4
    power: float = 0.5  # sqrt attenuation (paper); 1.0 = linear
    min_steps: int = 1
    rule: str = "midpoint"
    chunk: int = 0
    fused: bool = False
    interp_fn: Callable = interpolate
    interp_add_fn: Callable = interp_accum
    accum_fn: Optional[Callable] = None  # None: the method class's kernel op
    n_samples: int = 0
    sigma: float = 0.0
    sample_seed: int = 0
    device: Union[str, torch.device] = "cuda"
    mesh: Any = None
    mesh_rules: Any = None

    @property
    def spec(self) -> MethodSpec:
        """The resolved ``MethodSpec`` for ``self.method``."""
        return methods_mod.get(self.method)

    @property
    def ensemble_size(self) -> int:
        """Sample rows per example (1 for non-ensemble methods)."""
        spec = self.spec
        if spec.expand is None:
            return 1
        return self.n_samples if self.n_samples else spec.n_samples

    @property
    def ensemble_sigma(self) -> float:
        """Path-ensemble perturbation scale (method default unless set)."""
        return self.sigma if self.sigma else self.spec.sigma_default

    def _place(self, *ts):
        return tuple(map_tree(lambda a: torch.as_tensor(a, device=self.device), t) for t in ts)

    # -- path-ensemble expansion ------------------------------------------

    def expand_inputs(
        self,
        x: torch.Tensor,
        baseline: torch.Tensor,
        target: Any,
        mask: Optional[torch.Tensor] = None,
        draw: Optional[torch.Tensor] = None,
    ):
        """(B, ...) -> (B·n, ...) sample rows (identity for n == 1), samples
        of example b contiguous at rows [b·n, (b+1)·n). Returns
        ``(x, baseline, target, mask, n)``.

        draw: optional (B·n, *F) standard normals for the expansion; by
        default drawn from ``torch.Generator(device).manual_seed(sample_seed)``.
        """
        x, baseline, target, mask, draw = self._place(x, baseline, target, mask, draw)
        spec, n = self.spec, self.ensemble_size
        if spec.expand is None or n == 1:
            return x, baseline, target, mask, 1
        if draw is None:
            draw = torch.Generator(device=x.device).manual_seed(self.sample_seed)
        x2, b2 = spec.expand(x, baseline, draw, n, self.ensemble_sigma)
        m2 = None if mask is None else mask.repeat_interleave(n, dim=0)
        return x2, b2, repeat_tree(target, n), m2, n

    @staticmethod
    def reduce_result(res: IGResult, n: int) -> IGResult:
        """Mean over each example's n contiguous sample rows; δ is recomputed
        on the reduced quantities (the expectation's completeness gap, not
        the mean of per-sample gaps)."""
        if n == 1:
            return res
        red = lambda a: a.reshape((-1, n) + tuple(a.shape[1:])).mean(1)
        attr, f_x, f_b = red(res.attributions), red(res.f_x), red(res.f_baseline)
        delta = (attr.reshape(attr.shape[0], -1).sum(-1) - (f_x - f_b)).abs()
        return IGResult(attr, f_x, f_b, delta)

    # -- fixed-m attribution ----------------------------------------------

    def build_schedule(
        self,
        x: torch.Tensor,
        baseline: torch.Tensor,
        target: Any,
        mask: Optional[torch.Tensor] = None,
        f_x: Optional[torch.Tensor] = None,
    ) -> Schedule:
        """Stage 1 (probe) + step allocation, dispatched via the registry.
        Probe cost: n_int+1 (+ refine_rounds) forwards, minus one when
        ``f_x`` donates the α=1 endpoint."""
        x, baseline, target, mask, f_x = self._place(x, baseline, target, mask, f_x)
        fam = schedules.family(self.schedule)
        probe = probes.run_probe(
            fam.probe, self.f, x, baseline, target, n_int=self.n_int,
            rounds=self.refine_rounds, mask=mask, known_fx=f_x,
        )
        return fam.build(
            probe, self.m, power=self.power, min_steps=self.min_steps, rule=self.rule,
            device=x.device,
        )

    def attribute(
        self,
        x: torch.Tensor,
        baseline: torch.Tensor,
        target: Any,
        mask: Optional[torch.Tensor] = None,
        f_x: Optional[torch.Tensor] = None,
        draw: Optional[torch.Tensor] = None,
    ) -> IGResult:
        """Fixed-m attribution: stage-1 probe + stage-2 accumulation.

        Args:
            x: (B, *F) inputs; baseline: (B, *F) path start x′.
            target: (B,) ids passed through to ``f`` (``None`` if ``f``
                ignores it).
            mask: optional (B, *L) real-position mask — masked positions
                interpolate to the baseline and attribute exactly 0.
            f_x: optional (B,) known endpoint values f(x) (probe reuse);
                dropped for path ensembles, whose rows perturb the endpoint.
            draw: optional ensemble draw (see ``expand_inputs``).

        Returns:
            ``IGResult(attributions (B, *F), f_x, f_baseline, delta)``, per
            example (ensembles reduced).
        """
        x, baseline, target, mask, n = self.expand_inputs(x, baseline, target, mask, draw)
        f_x = None if n != 1 else self._place(f_x)[0]
        sched = self.build_schedule(x, baseline, target, mask, f_x=f_x)
        res = ig.attribute(
            self.f, x, baseline, sched, target, method=self.spec, mask=mask,
            chunk=self.chunk, f_x=f_x, **self.ig_kwargs(),
        )
        return self.reduce_result(res, n)

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
            "accum_fn": self.accum_fn or _ACCUM_KERNELS.get(self.spec.accum),
        }

    def start(
        self,
        x: torch.Tensor,
        baseline: torch.Tensor,
        target: Any,
        mask: Optional[torch.Tensor] = None,
        f_x: Optional[torch.Tensor] = None,
    ) -> tuple[IGResult, IGState, Schedule]:
        """Rung 0 of the adaptive ladder: probe, build the base schedule,
        accumulate its m nodes, and return the resumable state plus the
        schedule (needed to refine later). Per row, never expanded: callers
        expand path ensembles first (``expand_inputs``)."""
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
        target: Any,
        new_nodes: Schedule,
        state: IGState,
        mask: Optional[torch.Tensor] = None,
    ) -> tuple[IGResult, IGState]:
        """One ladder hop: accumulate the refined schedule's NEW nodes on top
        of ``state``. ``state_scale=0.5`` re-expresses the old accumulator in
        the refined rung's exactly-halved weights. Per row (see ``start``)."""
        x, baseline, target, mask = self._place(x, baseline, target, mask)
        return ig.attribute(
            self.f, x, baseline, new_nodes, target, method=self.spec, mask=mask,
            chunk=self.adaptive_chunk, state=state, state_scale=0.5, return_state=True,
            **self.ig_kwargs(),
        )

    def _build(self, key: tuple) -> Callable:
        """The rung callable of an ``attribute_adaptive`` cache key: ``start``
        for a ``("start", ...)`` key, ``resume`` for a ``("hop", ...)`` one
        (what a mesh's worker rebuilds from the key)."""
        return self.start if key[0] == "start" else self.resume

    def _recipe(self) -> dict:
        """The fields a worker rank builds its own Explainer from: all but
        the model function, the device and the mesh; and the digest of the
        tensors ``f`` reaches, which the worker holds its own ``f``'s to."""
        recipe = {f.name: getattr(self, f.name) for f in fields(self)
                  if f.name not in ("f", "device", "mesh", "mesh_rules")}
        recipe["model_digest"] = params_digest(reachable_tensors(self.f))
        return recipe

    def attribute_adaptive(
        self,
        x: torch.Tensor,
        baseline: torch.Tensor,
        target: Any,
        *,
        tol: float = 1e-2,
        m_max: int = 0,
        mask: Optional[torch.Tensor] = None,
        draw: Optional[torch.Tensor] = None,
        cache: Optional[dict] = None,
    ) -> tuple[IGResult, dict]:
        """δ-feedback early-exit attribution up the m-ladder.

        Runs the base rung (``self.m`` nodes), then repeatedly refines the
        schedule (nested doubling — no prior gradient is discarded) and
        resumes accumulation for the rows whose completeness gap still
        exceeds ``tol · |f(x) − f(x′)|``, until all converge or the ladder
        tops out at ``m_max`` (default ``8·m``). Converged rows exit with the
        rung they converged at; later hops run on the surviving rows only,
        padded under a mesh up to a multiple of the data-parallel extent by
        repeating the last survivor.

        Path ensembles expand each example to ``ensemble_size`` sample rows
        first (``draw`` as in ``expand_inputs``); the ladder then runs per
        row (each sample converges on its own δ) and the final IGResult is
        reduced to per-example means. The ``info`` arrays stay per row.

        ``cache``: a dict of rung callables shared across calls (and across
        explainers, meshes included: its keys carry the configuration, the
        input signature and ``mesh_cache_key``); ``info["compiles"]`` counts
        the entries this call added.

        Returns ``(IGResult, info)``: per-example final attributions/δ, and
        ``info`` with per-row ``m_used``/``hops``/``delta``/``threshold``/
        ``converged`` plus aggregate ``total_steps`` (Σ m_used),
        ``probe_forwards``, ``compiles``, ``mesh_fallbacks``, the
        ``ladder``, the ``chunk`` and ``n_samples`` (the expansion factor).
        """
        from repro_torch.sharding import DEFAULT_RULES, dispatch, dp_size, explain_arg_shardings, mesh_cache_key

        x, baseline, target, mask, n_samples = self.expand_inputs(x, baseline, target, mask, draw)
        fam = schedules.family(self.schedule)
        ladder = schedules.m_ladder(self.m, m_max if m_max else 8 * self.m)
        cache = cache if cache is not None else {}
        rules = self.mesh_rules or DEFAULT_RULES
        dp = dp_size(self.mesh, rules)
        compiles = mesh_fallbacks = 0

        recipe = self._recipe() if dp > 1 else None

        def run(key, args):
            nonlocal compiles, mesh_fallbacks
            sharded = dp > 1 and explain_arg_shardings(self.mesh, args, rules) is not None
            if key not in cache:
                cache[key] = self._build(key)
                compiles += 1
                mesh_fallbacks += dp > 1 and not sharded
            if sharded:
                return dispatch.call("explainer", recipe, key, args, self.mesh, cache[key], rules)
            return cache[key](*args)

        # the keys carry the configuration and the input signature (dtype,
        # target structure, mesh axis sizes): a shared cache never hands back
        # a callable for another problem
        cfg_key = (self.spec.name, self.schedule, self.m, self.n_int, self.adaptive_chunk, self.fused,
                   str(x.dtype), _structure(target), mesh_cache_key(self.mesh))
        has_mask = mask is not None
        B = x.shape[0]
        res, state, sched = run(("start", cfg_key, tuple(x.shape), has_mask), (x, baseline, target, mask))

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
            n_act = act.size
            refined = fam.refine(Schedule(a_act, w_act))
            # mesh-divisible padding: the last survivor repeats into the pad
            # slots, whose results are dropped; sel indexes survivor-aligned
            # tensors, rows the whole batch (sel is arange(n_act) when dp is 1)
            sel_np = np.concatenate([np.arange(n_act), np.full((-n_act) % dp, n_act - 1, np.int64)])
            sel = torch.as_tensor(sel_np, device=x.device)
            rows = torch.as_tensor(act[sel_np], device=x.device)
            hop_args = (
                x[rows], baseline[rows], map_tree(lambda t: t[rows], target),
                Schedule(refined.alphas[sel, n_new:], refined.weights[sel, n_new:]),
                IGState(acc_act[sel], res.f_x[rows], res.f_baseline[rows]),
                None if mask is None else mask[rows],
            )
            res2, st2 = run(("hop", cfg_key, sel_np.size, n_new, tuple(x.shape[1:]), has_mask), hop_args)
            total_steps += n_act * n_new
            d2 = res2.delta[:n_act].cpu().numpy()
            out_attr[rows[:n_act]] = res2.attributions[:n_act]
            delta[act] = d2
            m_used[act] = rung
            hops[act] += 1
            keep = d2 > threshold[act]
            act = act[keep]
            kept = torch.as_tensor(np.flatnonzero(keep), device=x.device)
            a_act, w_act, acc_act = refined.alphas[kept], refined.weights[kept], st2.acc[kept]

        final = self.reduce_result(IGResult(
            out_attr, res.f_x, res.f_baseline, torch.as_tensor(delta, device=x.device)
        ), n_samples)
        info = {
            "m_used": m_used,
            "hops": hops,
            "delta": delta,
            "threshold": threshold,
            "converged": delta <= threshold,
            "total_steps": int(total_steps),
            "probe_forwards": B * probes.probe_cost(fam.probe, n_int=self.n_int,
                                                    rounds=self.refine_rounds),
            "compiles": compiles,
            "mesh_fallbacks": mesh_fallbacks,
            "ladder": ladder,
            "chunk": self.adaptive_chunk,
            "n_samples": n_samples,
        }
        return final, info


def _structure(tree: Any) -> Any:
    """A hashable outline of a target tree (its containers and keys; each
    tensor as ``"T"``), for the cache keys."""
    if isinstance(tree, dict):
        return tuple((k, _structure(v)) for k, v in sorted(tree.items()))
    if isinstance(tree, (tuple, list)):
        return tuple(_structure(v) for v in tree)
    return None if tree is None else "T"
