"""ExplainEngine — shape-bucketed NUIG serving: ``repro.serve.explain_engine`` in PyTorch.

Heterogeneous ``ExplainRequest``s are padded into shape buckets
(``serve.batching``: powers-of-two S, plus a batch-axis ladder, so (B, S) is
a small closed set). Padded positions are masked out of the stage-1 probe
and the stage-2 attribution and δ: they score exactly zero, and δ is over
real tokens only. Every schedule family and attribution method of
``core`` rides the same per-bucket unit; callables are cached per key
``(bucket, accumulator class, schedule, m, n_int, config, ...)``, so the
methods sharing an accumulator class share them. Path-ensemble methods
(noise_tunnel, expected_grad) are served by replicating each request
``n_samples``× at plan time, perturbing rows in embedding space at batch
construction and averaging each request's rows; the forward-only class
(occlusion, RISE, LIME) draws its masks at batch construction and runs the
chunked forward loop of ``core.perturb``.

Where ``repro`` AOT-compiles one XLA executable per key, the port builds
one Python callable per key over eager PyTorch: a miss is a build (counted
as ``compiles``), a hit reuses it. On CUDA tensors every stage-2 op, the
flash attention of an ``attn="flash"`` model and the LIME solve launch the
port's kernels; on CPU tensors they take their plain versions. ``fused``
selects the fused stage 2 (``ig.attribute``). The port's ``Explainer``
always takes the kernel ops, which dispatch by the tensors' device, so
``use_kernels`` (kept in the keys for parity with ``repro``) defaults to
True and is refused as False on the card, where no plain stage 2 serves.

**Adaptive iso-convergence** (``adaptive=True``): ``m`` becomes the base
rung of a pow-2 m-ladder. Each bucket runs rung 0 (probe + base schedule +
resumable accumulation); rows whose δ still exceeds ``tol · |f(x) − f(x′)|``
are re-batched together and escalated one rung at a time through "hop"
callables keyed on ``(bucket, n_new, chunk)`` — the new nodes of the
refined schedule only (``AdaptiveBucketRun``).

``serve.scheduler.MixedScheduler`` drives the same units as work items:
``_run_bucket``, ``_run_bucket_fwd`` and ``AdaptiveBucketRun`` (whose
``degrade`` abandons the ladder after a fault), counted on ``EngineStats``'
``degraded``, ``preempted`` and ``queue_depth``.

**Caches.** ``result_cache`` (``serve.result_cache``) replays a finished
attribution under its content key (``request_cache_key``: the context of
``_context_parts``, which hashes the bytes ``repro`` hashes, and the
request's own bytes); ``autotune`` loads per-bucket chunks tuned by
``serve.autotune``; every callable's argument shapes and dtypes are
recorded when it is built, so ``serve.warm_state`` can rebuild and replay
the key set in a new process. ``BucketStats.bytes_accessed`` and
``peak_bytes`` of the gradient class come from ``roofline.hotpath_cost``
on an LM.

**The mesh** (``mesh=``, a ``DeviceMesh`` with dims ``("data", "model")``):
every bucket is padded up to a multiple of the data-parallel extent
(``dp_size``) at plan time and at each hop, every cache key carries the
mesh's (axis, size) pairs (``mesh_cache_key``), and each stage-2 call runs
data-parallel through ``sharding.dispatch``: this process (rank 0) plans,
every rank computes its rows of the batch-leading arguments, rank 0 gathers
them. δ and IDGI's inner products reduce over feature axes only, so the
adaptive ladder takes the same decisions on any mesh. A bucket that reaches
a call without a dp-divisible batch is served on rank 0 alone, with a
warning, and counted in ``EngineStats.mesh_fallbacks``.
"""
from __future__ import annotations

import hashlib
import time
import warnings
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.core import methods as methods_mod, perturb
from repro_torch.core.api import Explainer
from repro_torch.core.baselines import pad_embedding
from repro_torch.core.fingerprint import model_fingerprint, params_digest, reachable_tensors
from repro_torch.core.ig import IGState
from repro_torch.core.probes import map_tree, probe_cost
from repro_torch.core.schedule import Schedule, family, m_ladder
from repro_torch.kernels.ig_accum.ops import accum_fn_for
from repro_torch.kernels.interp_accum.ops import interp_accum
from repro_torch.kernels.interpolate.ops import interpolate
from repro_torch.kernels.lstsq.ops import wls_solve
from repro_torch.models.common import tree_map
from repro_torch.models.registry import model_for
from repro_torch.roofline import hotpath_cost
from repro_torch.serve.autotune import AutotuneCache, HotpathConfig, bucket_key, device_kind
from repro_torch.serve.batching import (
    DEFAULT_BATCH_BUCKETS,
    DEFAULT_SEQ_BUCKETS,
    BucketBatch,
    pad_rows,
    plan_buckets,
)
from repro_torch.serve.result_cache import ResultCache
from repro_torch.serve.warm_state import arg_spec
from repro_torch.sharding import DEFAULT_RULES, MeshRules, dispatch, dp_size, explain_arg_shardings, mesh_cache_key

# draw(s_bucket, row indices, feature shape) -> (rows, *shape) standard normals
NormalDraw = Callable[[int, Sequence[int], tuple], Any]
# draw_masks(method, s_bucket, row indices, n_masks) -> perturb.PerturbMasks
MaskDraw = Callable[[str, int, Sequence[int], int], perturb.PerturbMasks]


@dataclass(frozen=True)
class ExplainRequest:
    tokens: np.ndarray  # (S,) int32 prompt — lengths may differ per request
    target: int  # token id whose next-token log-prob is attributed
    # feature-space request (patch models): (S, *F) float patch features;
    # ``tokens`` then only sets the length/bucket and ``target`` is the class
    features: Optional[np.ndarray] = None
    # known endpoint value f(x) (probe reuse): the engine then skips the α=1
    # probe forward and the endpoint forward; dropped for path ensembles and
    # the forward-only class. None = the engine computes f(x) itself.
    f_x: Optional[float] = None


@dataclass
class BucketStats:
    compiles: int = 0  # callables built at this shape
    calls: int = 0
    requests: int = 0
    compile_s: float = 0.0
    total_s: float = 0.0  # wall time of cached calls (excludes builds)
    # ``repro`` records XLA's cost_analysis bytes and peak bytes here; the
    # port counts them with ``roofline.hotpath_cost`` when a gradient-class
    # callable of an LM is built (0 for the forward-only class and the ViT)
    bytes_accessed: float = 0.0
    peak_bytes: float = 0.0

    @property
    def mean_latency_s(self) -> float:
        return self.total_s / self.calls if self.calls else 0.0


@dataclass
class AdaptiveStats:
    """Aggregate δ-feedback serving counters (per-request values ride on the
    result dicts: ``m_used``, ``delta``, ``hops``, ``converged``). For
    path-ensemble methods every counter is per served ROW (sample)."""

    requests: int = 0  # requests served adaptively
    converged: int = 0  # requests that reached δ ≤ tol·|f_x − f_b|
    early_exits: int = 0  # requests that converged below the ladder top
    hop_calls: int = 0  # escalation batches launched
    total_steps: int = 0  # Σ per-request m_used (iso-convergence metric)
    launched_steps: int = 0  # actual grad steps incl. batch-pad rows
    probe_forwards: int = 0  # stage-1 forwards (not gradient steps)
    m_used: dict = field(default_factory=dict)  # final rung -> request count

    @property
    def mean_m_used(self) -> float:
        return self.total_steps / self.requests if self.requests else 0.0


@dataclass
class EngineStats:
    """Cache counters, per-bucket latency, the scheduler's counters, the
    result cache's and the mesh's."""

    hits: int = 0  # callable-cache hits
    misses: int = 0  # callable-cache misses == builds
    buckets: dict = field(default_factory=dict)  # (B, S) -> BucketStats
    # hops do different work per call than plan buckets: their own table
    hop_buckets: dict = field(default_factory=dict)  # (B, S) -> BucketStats
    adaptive: AdaptiveStats = field(default_factory=AdaptiveStats)
    # serve.scheduler: requests served a fallback result after the fault
    # policy gave up; prefill or decode items dispatched while a hop or a
    # forward-only batch waited (preemption); the queue depth at the most
    # recent dispatch
    degraded: int = 0
    preempted: int = 0
    queue_depth: int = 0
    # the RESULT cache (serve.result_cache), mirrored from it: whole
    # attributions replayed, where hits/misses above count callables
    result_hits: int = 0
    result_misses: int = 0
    result_evictions: int = 0
    result_bytes: int = 0
    # callables built for a bucket whose batch does not divide dp, served on
    # rank 0 alone — plan-time padding makes this unreachable in serving
    mesh_fallbacks: int = 0

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    @property
    def result_hit_rate(self) -> float:
        n = self.result_hits + self.result_misses
        return self.result_hits / n if n else 0.0

    def bucket(self, shape: tuple[int, int]) -> BucketStats:
        return self.buckets.setdefault(shape, BucketStats())

    def hop_bucket(self, shape: tuple[int, int]) -> BucketStats:
        return self.hop_buckets.setdefault(shape, BucketStats())

    @property
    def compiles(self) -> int:
        return sum(b.compiles for d in (self.buckets, self.hop_buckets) for b in d.values())


class ExplainEngine:
    """Bucketed NUIG serving over one model + parameter tree.

    Args:
        cfg / params: an ``ArchConfig`` (or ``VitConfig``) and its parameter
            tree (``models.lm.init_params`` / ``params_from_numpy``), moved
            to ``device``.
        method / schedule: names in ``methods.METHODS`` / ``schedule.SCHEDULES``.
        m, n_int, chunk: the stage-2 budget, stage-1 intervals, step chunk.
        seq_buckets / batch_buckets: the (S, B) padding ladders.
        adaptive / tol / m_max: δ-feedback serving up the pow-2 m-ladder;
            ``hop_zero`` starts a bucket at its historical rung.
        n_samples / sigma / sample_seed: path ensembles; ``n_masks`` the
            forward-only mask budget.
        fused: the fused stage 2. use_kernels: True launches the port's
            kernels on the card; False is refused there (the plain versions
            run on the CPU only, where the ops take them either way).
        attn: "flash" serves the model with ``attn_impl="flash"``.
        autotune / autotune_dir: load the per-bucket chunks tuned for this
            device (``autotune_<device kind>.json`` in ``autotune_dir``).
        result_cache: an int byte budget (``True``: 256 MiB) or a shared
            ``ResultCache``; None serves every request afresh.
        device: where the parameters live and the explanations run.
        mesh / mesh_rules: a ``DeviceMesh`` (``launch.mesh.make_explain_mesh``)
            and the rules of its data axes; stage 2 runs data-parallel over
            the mesh's ranks (``sharding.dispatch``), whose workers run
            ``serve_worker``. None: this process alone.
        draw / draw_masks: the random draws (``NormalDraw``, ``MaskDraw``);
            by default a row's draw comes from a CPU ``torch.Generator``
            seeded with ``perturb.request_seed(sample_seed, S, row index)``,
            so replay is bit-identical and card and CPU draw alike. Parity
            tests hand ``repro``'s draws in here.

    Example (the reduced LM on the CPU, one mixed-length round):

        >>> import numpy as np, torch
        >>> from repro_torch.configs import ARCHS, reduced
        >>> from repro_torch.models.registry import Model
        >>> cfg = reduced(ARCHS["llama3-8b"])
        >>> params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
        >>> eng = ExplainEngine(cfg, params, m=4, n_int=2, seq_buckets=(8,), device="cpu")
        >>> reqs = [ExplainRequest(np.arange(1, 6, dtype=np.int32), target=7)]
        >>> out = eng.explain(reqs)
        >>> out[0]["token_scores"].shape, eng.stats.misses
        ((5,), 1)
        >>> _ = eng.explain(reqs)  # same bucket -> a cache hit
        >>> eng.stats.misses, eng.stats.hits
        (1, 1)
    """

    def __init__(
        self,
        cfg: Any,
        params: Any,
        *,
        method: str = "ig",
        schedule: str = "paper",
        m: int = 64,
        n_int: int = 4,
        chunk: int = 0,
        refine_rounds: int = 4,
        power: float = 0.5,
        pad_id: int = 0,
        seq_buckets: Sequence[int] = DEFAULT_SEQ_BUCKETS,
        batch_buckets: Optional[Sequence[int]] = DEFAULT_BATCH_BUCKETS,
        max_batch: int = 0,
        adaptive: bool = False,
        tol: float = 1e-2,
        m_max: int = 0,
        n_samples: int = 0,
        sigma: float = 0.0,
        n_masks: int = 0,
        sample_seed: int = 0,
        fused: bool = False,
        use_kernels: bool = True,
        attn: str = "auto",
        autotune: bool = False,
        autotune_dir: str = "results",
        result_cache: Union[None, int, ResultCache] = None,
        hop_zero: bool = False,
        hop_zero_q: float = 0.75,
        hop_zero_min: int = 8,
        draw: Optional[NormalDraw] = None,
        draw_masks: Optional[MaskDraw] = None,
        mesh: Any = None,
        mesh_rules: MeshRules = DEFAULT_RULES,
        device="cuda",
    ):
        if attn not in ("auto", "flash"):
            raise ValueError(f"attn must be 'auto' or 'flash', got {attn!r}")
        if attn == "flash" or getattr(cfg, "attn_impl", "auto") == "flash":
            self.attn = "flash"
            cfg = replace(cfg, attn_impl="flash")
        else:
            self.attn = "auto"
        self.cfg = cfg
        self.device = torch.device(device)
        if not use_kernels and self.device.type == "cuda":
            raise ValueError("use_kernels=False: the port serves no plain stage 2 on the card; "
                             "its kernel ops take their plain versions on the CPU only")
        self.params = tree_map(lambda _, t: t.to(self.device), params)
        self.method = method
        self.schedule = schedule
        self._spec = methods_mod.get(method)
        self.m = m
        self.n_int = n_int
        self.chunk = chunk
        self.pad_id = pad_id
        self.fused = fused
        self.use_kernels = use_kernels
        # per-(bucket, device kind) tuned chunks, loaded once; a missing
        # file is an empty cache (every bucket runs the engine-wide chunk)
        self._autotune_cache = (
            AutotuneCache.load(autotune_dir, device_kind(self.device)) if autotune else None
        )
        self.seq_buckets = tuple(seq_buckets)
        self.batch_buckets = tuple(batch_buckets) if batch_buckets else None
        self.max_batch = max_batch
        # the forward-only class has no gradient, so δ carries no
        # convergence meaning: the ladder is refused loudly
        if self._spec.forward_only and adaptive:
            raise ValueError(
                f"method {self._spec.name!r} is forward-only; the δ-adaptive "
                "m-ladder needs the gradient class (serve it fixed-budget)"
            )
        self.n_masks = n_masks if n_masks else (self._spec.n_masks or 64)
        self.adaptive = adaptive
        self.tol = tol
        self.m_max = m_max if m_max else (8 * m if adaptive else m)
        self.m_ladder = m_ladder(m, self.m_max)
        self.n_samples = (
            (n_samples if n_samples else self._spec.n_samples)
            if self._spec.expand is not None
            else 1
        )
        self.sigma = sigma if sigma else self._spec.sigma_default
        self.sample_seed = sample_seed
        self._draw = draw
        self._draw_masks = draw_masks
        self.model = model_for(cfg)
        self.stats = EngineStats()
        self._cache: dict[tuple, Callable] = {}  # key -> built callable
        # key -> its arguments' shapes and dtypes (``warm_state.arg_spec``),
        # what serve.warm_state replays the key set from
        self._arg_specs: dict[tuple, Any] = {}
        self.mesh = mesh
        self.mesh_rules = mesh_rules
        # every bucket batch is padded up to a multiple of this at plan time
        self.dp = dp_size(mesh, mesh_rules)
        # cache keys carry the mesh axis sizes: single-device and sharded
        # entries coexist
        self._mesh_key = mesh_cache_key(mesh)
        # what a worker rank builds its own engine from (sharding.dispatch):
        # every constructor argument that shapes a callable
        self._recipe = dict(cfg=cfg, method=method, schedule=schedule, m=m, n_int=n_int, chunk=chunk,
                            refine_rounds=refine_rounds, power=power, pad_id=pad_id, adaptive=adaptive,
                            tol=tol, m_max=m_max, n_samples=n_samples, sigma=sigma, n_masks=n_masks,
                            sample_seed=sample_seed, fused=fused, use_kernels=use_kernels, attn=attn)
        if self.dp > 1:  # a worker serves only with the weights this process holds
            self._recipe["params_digest"] = params_digest(self.params)
        self._model_fp: Optional[str] = None
        if isinstance(result_cache, ResultCache):
            self.result_cache: Optional[ResultCache] = result_cache
        elif result_cache:
            self.result_cache = ResultCache() if result_cache is True else ResultCache(int(result_cache))
        else:
            self.result_cache = None
        # hop-zero starting rung: the per-(S-bucket, method) m_used history
        self.hop_zero = hop_zero and adaptive
        self.hop_zero_q = hop_zero_q
        self.hop_zero_min = hop_zero_min
        self._delta_hist: dict[tuple[int, str], list[int]] = {}
        self._explainers_m: dict[int, Explainer] = {}
        # the per-row unit: expansion stripped (row_spec) — the engine
        # samples the ensemble itself at batch construction
        self._explainer = Explainer(
            self.model.target_logprob_at_fn(self.params),
            method=self._spec.row_spec(),
            schedule=schedule,
            m=m,
            n_int=n_int,
            chunk=chunk,
            refine_rounds=refine_rounds,
            power=power,
            fused=fused,
            device=self.device,
            **self._kernel_kwargs(HotpathConfig(chunk)),
        )

    # -- the callable cache ------------------------------------------------

    def _kernel_kwargs(self, cfg: HotpathConfig) -> dict:
        """The stage-2 kernel ops for one config: the interpolate +
        accumulate pair unfused, the interp-plus-carry op (whose backward is
        ``accum_cot``) and the class accumulator fused. The ops dispatch by
        the tensors' device; ``cfg``'s TPU
        block sizes are not taken. Forward-only methods inject the solve in
        ``_fwd_fn_at`` instead."""
        if self._spec.forward_only:
            return {}
        kw = {"accum_fn": accum_fn_for(self._spec.accum)}
        if self.fused:
            kw["interp_add_fn"] = interp_accum
        else:
            kw["interp_fn"] = interpolate
        return kw

    def _cfg_for(self, bucket: tuple[int, int]) -> HotpathConfig:
        """The bucket's tuned config, or the engine-wide chunk where no
        autotune entry exists."""
        if self._autotune_cache is not None:
            tuned = self._autotune_cache.config_for(
                bucket_key(bucket, self._spec.accum, self.schedule, self.m, self.n_int, self.fused,
                           attn=self.attn))
            if tuned is not None:
                return tuned
        return HotpathConfig(self.chunk)

    def _explainer_at(self, cfg: HotpathConfig) -> Explainer:
        """The per-row unit at one config (the kernel ops are the
        construction-time ones: they take no per-bucket tile sizes)."""
        return replace(self._explainer, chunk=cfg.chunk)

    def _attr_fn_at(self, cfg: HotpathConfig, *, with_fx: bool = False):
        """The fixed-m bucket unit at one config. ``with_fx`` is the
        probe-reuse variant whose trailing (B,) argument donates f(x)."""
        exp = self._explainer_at(cfg)

        if with_fx:

            def attr_fx_fn(embeds, baseline, aux, mask, f_x):
                return exp.attribute(embeds, baseline, aux, mask=mask, f_x=f_x)

            return attr_fx_fn

        def attr_fn(embeds, baseline, aux, mask):
            return exp.attribute(embeds, baseline, aux, mask=mask)

        return attr_fn

    def _key(self, bucket: tuple[int, int], *, with_fx: bool = False) -> tuple:
        """Keyed by accumulator CLASS, not method name: methods sharing an
        accumulator share the callables."""
        return (bucket, self._spec.accum, self.schedule, self.m, self.n_int,
                self._cfg_for(bucket), self.fused, self.use_kernels, self.attn, self._mesh_key, with_fx)

    def _build(self, key: tuple) -> Callable:
        """The callable of one cache key, built from the key alone (so a
        restored key set rebuilds in a new process):

          * ``(bucket, accum, schedule, m, n_int, config, fused, use_kernels,
            attn, mesh, with_fx)`` — the fixed-m unit at ``config``;
          * ``("start", bucket, accum, schedule, m0, n_int, chunk, ...)`` —
            adaptive rung 0 at rung m0;
          * ``("hop", (B', S), accum, n_new, chunk, ...)`` — one hop; it
            depends on the ladder only through its chunk, which the rung m
            sets when the engine chunk is 0;
          * ``("fwd", bucket, accum, n_masks, chunk, ...)`` — the
            forward-only unit.
        """
        kind = key[0]
        if kind == "start":
            return self._start_fn_for(key[4])
        if kind == "hop":
            return self._hop_fn_for(self.m if self.chunk else key[4])
        if kind == "fwd":
            return self._fwd_fn_at(self._cfg_for(key[1]))
        return self._attr_fn_at(key[5], with_fx=key[-1])

    def _cost(self, key: tuple) -> Optional[dict]:
        """``roofline.hotpath_cost`` of one gradient-class key of an LM
        (None for the forward-only class and other models)."""
        if key[0] == "fwd" or not isinstance(self.cfg, ArchConfig):
            return None
        if key[0] == "hop":
            bucket, m, chunk, probes = key[1], key[3], key[4], 0
        else:
            if key[0] == "start":
                bucket, m, chunk = key[1], key[4], key[6]
            else:
                bucket, m, chunk = key[0], key[3], key[5].chunk
            probes = self._forwards_a_row(with_fx=key[-1])
        return hotpath_cost(self.cfg, bucket, m, chunk, self.cfg.compute_dtype,
                            probe_forwards=probes, fused=self.fused)

    def _forwards_a_row(self, *, with_fx: bool) -> int:
        """Forwards a row of a fixed-m or start call runs besides stage 2:
        stage 1's probe and the endpoints f(x), f(x′) (f(x′) alone when
        f(x) is donated)."""
        return probe_cost(family(self.schedule).probe, n_int=self.n_int,
                          rounds=self._explainer.refine_rounds, known_fx=with_fx) + (1 if with_fx else 2)

    def _executable(self, key: tuple, bs: BucketStats, args: tuple) -> Callable:
        """The cached callable for ``key``; a miss builds it, records the
        arguments' spec and the key's cost, and charges the build to the
        stats row ``bs``. Under a mesh, a miss whose arguments do not divide
        dp is counted in ``mesh_fallbacks`` and warned of: ``_timed_call``
        serves it on this rank alone."""
        if key in self._cache:
            self.stats.hits += 1
            return self._cache[key]
        self.stats.misses += 1
        bs.compiles += 1
        if self.dp > 1 and explain_arg_shardings(self.mesh, args, self.mesh_rules) is None:
            self.stats.mesh_fallbacks += 1
            warnings.warn(f"ExplainEngine: bucket batch {args[0].shape[0]} does not divide dp={self.dp}; "
                          f"serving replicated (key={key[:2]})", stacklevel=3)
        t0 = time.perf_counter()
        self._cache[key] = self._build(key)
        self._arg_specs[key] = arg_spec(args)
        bs.compile_s += time.perf_counter() - t0
        cost = self._cost(key)
        if cost is not None:
            bs.bytes_accessed, bs.peak_bytes = cost["bytes accessed"], cost["peak bytes"]
        return self._cache[key]

    def precompile_hop_zero_starts(self) -> int:
        """Build the start callables the δ-history now implies.

        The history grows while the engine serves, so the elevated starting
        rung ``_hop_zero_m`` would now pick for a bucket may never have been
        built. ``serve.warm_state.save_warm_state`` calls this first, so a
        restored engine serves seen buckets without a miss where the
        restored history elevates the start. The rung changes no argument
        shape: the new key takes the base start's spec. Returns how many
        keys were added (not charged to the serving stats)."""
        if not self.hop_zero:
            return 0
        n = 0
        for key in [k for k in self._cache if k[0] == "start"]:
            bucket, with_fx = key[1], key[-1]
            m0 = self._hop_zero_m(bucket)
            if m0 == key[4]:
                continue
            new_key = ("start", bucket, self._spec.accum, self.schedule, m0, self.n_int,
                       self._explainer_for_m(m0).adaptive_chunk, self.fused, self.use_kernels,
                       self.attn, self._mesh_key, with_fx)
            if new_key in self._cache:
                continue
            self._cache[new_key] = self._build(new_key)
            self._arg_specs[new_key] = self._arg_specs[key]
            n += 1
        return n

    # -- content-addressed identity (result cache, warm state) --------------

    @property
    def model_fingerprint(self) -> str:
        """sha256 of (config repr, parameter bytes), computed once, lazily."""
        if self._model_fp is None:
            self._model_fp = model_fingerprint(self.cfg, self.params)
        return self._model_fp

    def _context_parts(self) -> list:
        """Everything engine-level that changes the attribution bytes:
        ``repro``'s list, entry for entry. Keyed by METHOD NAME (IDGI and IG
        attributions of one input differ though they share callables); the
        bucket ladders are absent, since padding invariance makes results
        independent of the bucket a request lands in."""
        return [
            "ctx-v1", self.model_fingerprint, self.method, self.schedule,
            self.m, self.n_int, self.chunk, self.adaptive, self.tol,
            self.m_max, self.n_samples, self.sigma, self.sample_seed,
            self.n_masks, self.fused, self.use_kernels, self.attn,
            self._mesh_key, self.pad_id, self._autotune_cache is not None,
        ]

    def warm_context(self) -> str:
        """The identity a warm state must match. The autotune ENTRIES are not
        in it: the warm state carries and installs them itself."""
        return hashlib.sha256(repr(self._context_parts()).encode()).hexdigest()

    def request_cache_key(self, req: ExplainRequest) -> str:
        """sha256 content key of one request's result: the engine context
        with the loaded autotune entries (a tuned chunk changes the bits),
        then the request's tokens, target, features and donated f(x) — the
        last dropped where ``explain`` drops it (path ensembles, the
        forward-only class)."""
        parts = self._context_parts()
        if self._autotune_cache is not None:
            parts.append(self._autotune_cache.entries_fingerprint())
        h = hashlib.sha256(repr(parts).encode())
        tok = np.ascontiguousarray(np.asarray(req.tokens, np.int32))
        h.update(str(tok.shape).encode())
        h.update(tok.tobytes())
        h.update(str(int(req.target)).encode())
        if req.features is not None:
            f = np.ascontiguousarray(np.asarray(req.features, np.float32))
            h.update(b"feat")
            h.update(str(f.shape).encode())
            h.update(f.tobytes())
        f_x = None if self._spec.forward_only or self.n_samples > 1 else req.f_x
        h.update(b"fx" + (np.float32(f_x).tobytes() if f_x is not None else b"none"))
        return h.hexdigest()

    def _sync_result_stats(self) -> None:
        """Mirror the result cache's counters onto ``stats``."""
        rc = self.result_cache
        if rc is not None:
            st = self.stats
            st.result_hits, st.result_misses = rc.hits, rc.misses
            st.result_evictions, st.result_bytes = rc.evictions, rc.bytes

    def _timed_call(self, bs: BucketStats, key: tuple, fn: Callable, args: tuple) -> Any:
        """Run one cached callable, synchronised, and charge its wall time;
        under a mesh, data-parallel over its ranks (the rows' trip out and
        back is part of the serving latency, so it stays inside the timer),
        or on this rank alone where the arguments do not divide dp."""
        t0 = time.perf_counter()
        if self.dp > 1 and explain_arg_shardings(self.mesh, args, self.mesh_rules) is not None:
            out = dispatch.call("engine", self._recipe, key, args, self.mesh, fn, self.mesh_rules)
        else:
            out = fn(*args)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        bs.total_s += time.perf_counter() - t0
        bs.calls += 1
        return out

    # -- adaptive units ----------------------------------------------------

    def _explainer_for_m(self, m0: int) -> Explainer:
        """The per-row Explainer at ladder rung ``m0`` (hop-zero starts)."""
        if m0 == self.m:
            return self._explainer
        if m0 not in self._explainers_m:
            self._explainers_m[m0] = replace(self._explainer, m=m0)
        return self._explainers_m[m0]

    def _start_fn_for(self, m0: int):
        """Adaptive rung 0 at rung ``m0`` (``repro``'s ``_start_fn`` at m0 =
        m): probe + base schedule + resumable stage 2. The schedule comes
        back per row (uniform's shared (m,) one broadcast), so survivor rows
        can be gathered."""
        exp = self._explainer_for_m(m0)

        def start_fn(embeds, baseline, aux, mask, f_x=None):
            res, state, sched = exp.start(embeds, baseline, aux, mask=mask, f_x=f_x)
            B = embeds.shape[0]
            sched = Schedule(sched.alphas.expand(B, -1), sched.weights.expand(B, -1))
            return res, state, sched

        return start_fn

    def _hop_fn_for(self, m0: int):
        """One ladder hop (``repro``'s ``_hop_fn`` at m0 = m): stage 2 over
        the refined schedule's new nodes only."""
        exp = self._explainer_for_m(m0)

        def hop_fn(embeds, baseline, aux, mask, new_nodes, state):
            return exp.resume(embeds, baseline, aux, new_nodes, state, mask=mask)

        return hop_fn

    def _hop_zero_m(self, bucket: tuple[int, int]) -> int:
        """The ladder's starting rung for one bucket: with ``hop_zero_min``
        base-rung observations for (S-bucket, method), the smallest rung
        covering their ``hop_zero_q`` quantile of m_used; else ``m``."""
        if not self.hop_zero:
            return self.m
        hist = self._delta_hist.get((bucket[1], self.method))
        if not hist or len(hist) < self.hop_zero_min:
            return self.m
        q = float(np.quantile(np.asarray(hist, np.float64), self.hop_zero_q))
        for rung in self.m_ladder:
            if rung >= q:
                return rung
        return self.m_ladder[-1]

    def _record_m_used(self, seq_bucket: int, values: Sequence[int]) -> None:
        """Accumulate base-rung-start m_used outcomes (capped at 512)."""
        hist = self._delta_hist.setdefault((seq_bucket, self.method), [])
        hist.extend(int(v) for v in values)
        if len(hist) > 512:
            del hist[:-512]

    # -- batch construction ------------------------------------------------

    def _padded_indices(self, bb: BucketBatch) -> list[int]:
        """The bucket's row indices, batch-pad rows repeating the last."""
        padded = list(bb.indices)
        return padded + [padded[-1]] * (bb.bucket[0] - len(padded))

    def _normals(self, S: int, rows: Sequence[int], shape: tuple) -> torch.Tensor:
        """(rows, *shape) standard normals, each row's pure in (sample_seed,
        S, row index)."""
        if self._draw is not None:
            z = torch.as_tensor(np.asarray(self._draw(S, rows, shape)))
        else:
            z = torch.stack([
                torch.randn(shape, generator=torch.Generator().manual_seed(
                    perturb.request_seed(self.sample_seed, S, i)))
                for i in rows
            ])
        return z.to(device=self.device, dtype=torch.float32)

    def _bucket_inputs(self, bb: BucketBatch) -> tuple:
        dev = self.device
        aux = {
            "target": torch.as_tensor(bb.targets, device=dev),
            "pos": torch.as_tensor(bb.lens - 1, device=dev),
        }
        mask = torch.as_tensor(bb.mask, device=dev)
        if bb.features is not None:
            # feature-space requests (ViT patches): the path runs from the
            # embedded black image to the embedded features
            feats = torch.as_tensor(bb.features, device=dev)
            embeds = self.model.embed_features(self.params, feats)
            baseline = self.model.embed_features(self.params, torch.zeros_like(feats))
        else:
            embeds = self.model.embed_inputs(self.params, {"tokens": torch.as_tensor(bb.tokens, device=dev)})
            # the PAD-token embedding, not zeros: RMSNorm is scale-invariant,
            # so a ray through the origin has (near-)zero gradient
            baseline = pad_embedding(self.params["embed"]["embedding"], embeds,
                                     pad_id=self.pad_id).contiguous()
        if self._spec.expand is not None:
            # path-ensemble rows (already replicated requests, see
            # _explain_uncached) each draw their own sample, pure in their
            # own expanded request index: replay draws the same ensemble
            noise = self._normals(bb.bucket[1], self._padded_indices(bb), tuple(embeds.shape[1:]))
            embeds, baseline = self._spec.expand(embeds, baseline, noise, 1, self.sigma)
        if bb.f_x is not None:
            return embeds, baseline, aux, mask, torch.as_tensor(bb.f_x, device=dev)
        return embeds, baseline, aux, mask

    def _run_bucket(self, bb: BucketBatch) -> Any:
        args = self._bucket_inputs(bb)
        with_fx = bb.f_x is not None
        bs = self.stats.bucket(bb.bucket)
        key = self._key(bb.bucket, with_fx=with_fx)
        res = self._timed_call(bs, key, self._executable(key, bs, args), args)
        bs.requests += len(bb.indices)
        return res

    # -- forward-only (perturbation) class ---------------------------------

    def _fwd_chunk(self) -> int:
        """Masks per model call: the engine chunk when it divides P, else
        the whole mask batch."""
        return self.chunk if self.chunk and self.n_masks % self.chunk == 0 else 0

    def _fwd_fn_at(self, cfg: HotpathConfig):
        """The forward-evaluator unit: embeds + masks -> scores. LIME's group
        map and ragged-group validity are pure in (bucket shape, mask) and
        recomputed inside; the solve is the kernel op ``wls_solve``."""
        f = self._explainer.f
        spec = self._spec
        chunk = self._fwd_chunk()
        if spec.accum == "lime":

            def fwd_lime(embeds, baseline, aux, mask, z, zg):
                G = zg.shape[-1]
                gids = perturb.lime_group_ids(embeds.shape[1], G).to(embeds.device)
                return perturb.attribute_from_masks(
                    f, embeds, baseline, aux, perturb.PerturbMasks(z, zg, gids),
                    method=spec, mask=mask, group_valid=perturb.group_real_mask(mask, gids, G),
                    chunk=chunk, solve_fn=wls_solve,
                )

            return fwd_lime

        def fwd(embeds, baseline, aux, mask, z):
            return perturb.attribute_from_masks(
                f, embeds, baseline, aux, perturb.PerturbMasks(z),
                method=spec, mask=mask, chunk=chunk,
            )

        return fwd

    def _fwd_bucket_inputs(self, bb: BucketBatch) -> tuple:
        """Fixed-m inputs plus the plan-time mask draw: every row's masks
        come from ``perturb.request_seed`` over its own request index, so
        replay is bit-identical and pad rows repeat the last real row's."""
        embeds, baseline, aux, mask = self._bucket_inputs(bb)[:4]
        S, rows = bb.bucket[1], self._padded_indices(bb)
        if self._draw_masks is not None:
            pm = self._draw_masks(self._spec.name, S, rows, self.n_masks)
        else:
            seeds = [perturb.request_seed(self.sample_seed, S, i) for i in rows]
            pm = perturb.draw_masks(self._spec.name, seeds, S, self.n_masks, device=self.device)
        z = torch.as_tensor(pm.z, device=self.device, dtype=torch.float32)
        if pm.groups is not None:
            return embeds, baseline, aux, mask, z, torch.as_tensor(
                pm.groups, device=self.device, dtype=torch.float32)
        return embeds, baseline, aux, mask, z

    def _run_bucket_fwd(self, bb: BucketBatch) -> Any:
        """One forward-evaluator bucket call -> ``perturb.PerturbResult``
        (scores per position (B, S), exactly zero at pads)."""
        args = self._fwd_bucket_inputs(bb)
        bs = self.stats.bucket(bb.bucket)
        key = ("fwd", bb.bucket, self._spec.accum, self.n_masks, self._fwd_chunk(),
               self.use_kernels, self.attn, self._mesh_key)
        res = self._timed_call(bs, key, self._executable(key, bs, args), args)
        bs.requests += len(bb.indices)
        return res

    # -- serving -----------------------------------------------------------

    def _run_bucket_adaptive(self, bb: BucketBatch) -> list[dict]:
        """δ-feedback serving for one bucket: rung 0, then escalate the
        survivors (``AdaptiveBucketRun`` driven to completion)."""
        run = AdaptiveBucketRun(self, bb)
        run.start()
        while run.hop():
            pass
        return run.results()

    @staticmethod
    def _reduce_samples(group: list[dict]) -> dict:
        """Average one request's contiguous sample results (path ensembles).
        δ is recomputed on the reduced quantities."""
        if len(group) == 1:
            return group[0]
        r = dict(group[0])
        mean = lambda k: np.mean([g[k] for g in group], axis=0)
        r["token_scores"] = mean("token_scores")
        if "raw_token_scores" in r:
            r["raw_token_scores"] = mean("raw_token_scores")
        r["f_x"] = float(mean("f_x"))
        r["f_baseline"] = float(mean("f_baseline"))
        r["delta"] = float(abs(float(np.sum(r["token_scores"])) - (r["f_x"] - r["f_baseline"])))
        if "m_used" in r:  # adaptive: the request pays its worst sample
            r["m_used"] = max(g["m_used"] for g in group)
            r["hops"] = max(g["hops"] for g in group)
            r["threshold"] = float(mean("threshold"))
            r["converged"] = all(g["converged"] for g in group)
        return r

    def explain(self, requests: Sequence[ExplainRequest], *, return_raw: bool = False) -> list[dict]:
        """Serve a heterogeneous batch; results align with ``requests``.

        With a ``result_cache`` each request's content key is looked up
        before planning: hits replay the stored dict (a fresh copy), and only
        the misses are planned and computed — always with their raw rows, so
        an entry serves both ``return_raw`` variants. Degraded results are
        never cached."""
        rc = self.result_cache
        if rc is None:
            return self._explain_uncached(requests, return_raw=return_raw)
        keys = [self.request_cache_key(r) for r in requests]
        results: list[Optional[dict]] = [rc.get(k) for k in keys]
        miss = [i for i, r in enumerate(results) if r is None]
        if miss:
            fresh = self._explain_uncached([requests[i] for i in miss], return_raw=True)
            for i, r in zip(miss, fresh):
                if not r.get("degraded"):
                    rc.put(keys[i], r)
                results[i] = r
        self._sync_result_stats()
        if not return_raw:
            for r in results:
                r.pop("raw_token_scores", None)
        return results

    def _explain_uncached(self, requests: Sequence[ExplainRequest], *,
                          return_raw: bool = False) -> list[dict]:
        """The compute path.

        Each result dict: token_scores (S_req,), delta, f_x, f_baseline,
        bucket (B, S); with ``return_raw`` also raw_token_scores (S_bucket,),
        exactly zero at padded positions. Adaptive results add ``m_used``,
        ``hops``, ``threshold`` and ``converged``. Path-ensemble requests
        are replicated ``n_samples``× at plan time and their sample results
        averaged back into one dict.
        """
        n = self.n_samples
        expanded = list(requests) if n == 1 else [r for r in requests for _ in range(n)]
        if n > 1 or self._spec.forward_only:
            # an ensemble row perturbs x, so a donated f(x) is for the wrong
            # point; the forward-only class computes both endpoints itself
            expanded = [replace(r, f_x=None) if r.f_x is not None else r for r in expanded]
        plan = plan_buckets(
            expanded,
            seq_buckets=self.seq_buckets,
            batch_buckets=self.batch_buckets,
            max_batch=self.max_batch,
            pad_id=self.pad_id,
            batch_multiple=self.dp,
        )
        out: list[Optional[dict]] = [None] * len(expanded)
        for bb in plan:
            if self.adaptive:
                for r in self._run_bucket_adaptive(bb):
                    ri = r.pop("request")
                    if not return_raw:
                        r.pop("raw_token_scores")
                    out[ri] = r
                continue
            if self._spec.forward_only:
                res = self._run_bucket_fwd(bb)
                per_token = res.attributions  # already per position (B, S)
            else:
                res = self._run_bucket(bb)
                per_token = res.attributions.sum(-1)  # (B, S)
            per_token = per_token.cpu().numpy()
            delta, f_x, f_b = (t.cpu().numpy() for t in (res.delta, res.f_x, res.f_baseline))
            for row, ri in enumerate(bb.indices):
                r = {
                    "token_scores": per_token[row, : bb.lens[row]],
                    "delta": float(delta[row]),
                    "f_x": float(f_x[row]),
                    "f_baseline": float(f_b[row]),
                    "bucket": bb.bucket,
                }
                if return_raw:
                    r["raw_token_scores"] = per_token[row]
                out[ri] = r
        if n == 1:
            return out
        return [self._reduce_samples(out[i * n : (i + 1) * n]) for i in range(len(requests))]


class AdaptiveBucketRun:
    """One bucket's δ-adaptive ladder as explicit work items.

      * ``start()`` — rung 0: probe + base schedule + resumable stage 2;
      * while ``active``: ``hop()`` escalates the survivors one rung;
      * ``degrade()`` — abandon the remaining ladder after a fault: the
        current rung's results stand, the affected rows are marked
        ``degraded`` and counted on ``EngineStats.degraded``;
      * ``results()`` — finalize the adaptive stats (once) and return one
        dict per real request in ``bb.indices`` order.

    The bucket's inputs and the survivors' schedules and accumulators stay
    on the engine's device; δ, the thresholds and the traces live on the
    host, where the escalation is decided. A unit that raises inside its
    call leaves the run as it found it (``start`` and ``hop`` advance their
    state after the call returns), so the scheduler can retry it.
    """

    def __init__(self, engine: ExplainEngine, bb: BucketBatch):
        self.eng = engine
        self.bb = bb
        self._started = False
        self._results: Optional[list[dict]] = None
        self._degraded: set[int] = set()
        self._rung_i = 1  # next ladder index to run (0 is start())
        self.act: list[int] = []

    @property
    def active(self) -> bool:
        """More ladder hops pending (unconverged survivors + rungs left)."""
        return bool(self.act) and self._rung_i < len(self.eng.m_ladder)

    def _rows(self, rows: Sequence[int]) -> torch.Tensor:
        return torch.as_tensor(list(rows), dtype=torch.long, device=self.eng.device)

    def start(self) -> None:
        eng, bb = self.eng, self.bb
        assert not self._started
        self.m0 = eng._hop_zero_m(bb.bucket)
        self._rung_i = eng.m_ladder.index(self.m0) + 1
        self.chunk = eng._explainer_for_m(self.m0).adaptive_chunk
        with_fx = bb.f_x is not None
        args = eng._bucket_inputs(bb)
        key = ("start", bb.bucket, eng._spec.accum, eng.schedule, self.m0, eng.n_int,
               self.chunk, eng.fused, eng.use_kernels, eng.attn, eng._mesh_key, with_fx)
        bs = eng.stats.bucket(bb.bucket)
        res, state, sched = eng._timed_call(bs, key, eng._executable(key, bs, args), args)
        self._started = True
        bs.requests += len(bb.indices)

        n_real = len(bb.indices)
        ast = eng.stats.adaptive
        ast.requests += n_real
        ast.total_steps += n_real * self.m0
        ast.launched_steps += bb.bucket[0] * self.m0
        ast.probe_forwards += n_real * probe_cost(
            family(eng.schedule).probe, n_int=eng.n_int,
            rounds=eng._explainer.refine_rounds, known_fx=with_fx,
        )

        self.embeds, self.baseline, self.aux, self.mask = args[:4]
        self.f_x_t, self.f_b_t = res.f_x, res.f_baseline
        self.delta = res.delta.cpu().numpy().copy()
        self.f_x = res.f_x.cpu().numpy()
        self.f_b = res.f_baseline.cpu().numpy()
        self.threshold = eng.tol * np.abs(self.f_x - self.f_b)
        self.per_token = res.attributions.sum(-1).cpu().numpy().copy()  # (B, S)
        self.m_used = np.full((bb.bucket[0],), self.m0, np.int64)
        self.hops = np.zeros((bb.bucket[0],), np.int64)

        # survivors: real rows whose δ still exceeds tol·|f_x − f_b|
        self.act = [r for r in range(n_real) if self.delta[r] > self.threshold[r]]
        sel = self._rows(self.act)
        self.a_act, self.w_act = sched.alphas[sel], sched.weights[sel]
        self.acc_act = state.acc[sel]

    def hop(self) -> bool:
        """Run ONE escalation rung over the survivors; returns ``active``.

        The survivors are re-batched (the batch axis padded up the ladder by
        repeating the last survivor) and only the refined schedule's new
        nodes run, through hop callables keyed ``("hop", (B', S), n_new,
        chunk)`` — a closed shape set."""
        if not self.active:
            return False
        eng, act = self.eng, self.act
        S = self.bb.bucket[1]
        rung = eng.m_ladder[self._rung_i]
        n_new = rung // 2
        refined = family(eng.schedule).refine(Schedule(self.a_act, self.w_act))
        rows, B2 = pad_rows(act, eng.batch_buckets, multiple=eng.dp)
        # schedule/state slot per padded row: act is a prefix of rows and
        # the pad slots repeat the last survivor
        r_t = self._rows(rows)
        s_t = self._rows(list(range(len(act))) + [len(act) - 1] * (B2 - len(act)))
        hop_bucket = (B2, S)
        hop_args = (
            self.embeds[r_t],
            self.baseline[r_t],
            map_tree(lambda t: t[r_t], self.aux),
            self.mask[r_t],
            Schedule(refined.alphas[s_t, n_new:], refined.weights[s_t, n_new:]),
            IGState(self.acc_act[s_t], self.f_x_t[r_t], self.f_b_t[r_t]),
        )
        hop_key = ("hop", hop_bucket, eng._spec.accum, n_new, self.chunk,
                   eng.fused, eng.use_kernels, eng.attn, eng._mesh_key)
        hbs = eng.stats.hop_bucket(hop_bucket)
        res2, st2 = eng._timed_call(hbs, hop_key, eng._executable(hop_key, hbs, hop_args), hop_args)
        self._rung_i += 1  # only now: a hop that raised is retried at the same rung
        ast = eng.stats.adaptive
        ast.hop_calls += 1
        ast.launched_steps += B2 * n_new
        ast.total_steps += len(act) * n_new

        d2 = res2.delta.cpu().numpy()
        pt2 = res2.attributions.sum(-1).cpu().numpy()
        keep = []
        for slot, r in enumerate(act):  # real survivors occupy slots [0, len(act))
            self.delta[r] = d2[slot]
            self.per_token[r] = pt2[slot]
            self.m_used[r] = rung
            self.hops[r] += 1
            if d2[slot] > self.threshold[r]:
                keep.append(slot)
        self.act = [act[s] for s in keep]
        k_t = self._rows(keep)
        self.a_act, self.w_act = refined.alphas[k_t], refined.weights[k_t]
        self.acc_act = st2.acc[k_t]
        return self.active

    def degrade(self) -> int:
        """Abandon the remaining ladder; the current rung's results become
        the fallback. Returns how many real rows were degraded (each counted
        on ``EngineStats.degraded``); a second call degrades none."""
        n = len(self.act)
        if n:
            self._degraded.update(self.act)
            self.eng.stats.degraded += n
            self.act = []
        return n

    def results(self) -> list[dict]:
        """One result dict per real request (``bb.indices`` order); finalizes
        the aggregate adaptive counters exactly once."""
        if self._results is not None:
            return self._results
        eng, bb = self.eng, self.bb
        ast = eng.stats.adaptive
        out = []
        for row, ri in enumerate(bb.indices):
            converged = bool(self.delta[row] <= self.threshold[row])
            ast.converged += converged
            ast.early_exits += converged and int(self.m_used[row]) < eng.m_ladder[-1]
            mu = int(self.m_used[row])
            ast.m_used[mu] = ast.m_used.get(mu, 0) + 1
            out.append({
                "request": ri,
                "token_scores": self.per_token[row, : bb.lens[row]],
                "raw_token_scores": self.per_token[row],
                "delta": float(self.delta[row]),
                "threshold": float(self.threshold[row]),
                "f_x": float(self.f_x[row]),
                "f_baseline": float(self.f_b[row]),
                "bucket": bb.bucket,
                "m_used": mu,
                "hops": int(self.hops[row]),
                "converged": converged,
                "degraded": row in self._degraded,
            })
        # hop-zero evidence: only base-rung starts (an elevated start's
        # m_used is floored at m0, which would ratchet the quantile up), and
        # no degraded row (its ladder stopped by fault, not by δ)
        if self.m0 == eng.m:
            eng._record_m_used(bb.bucket[1], [r["m_used"] for r in out if not r["degraded"]])
        self._results = out
        return out


def serve_worker(cfg: Any, params: Any, *, device="cuda", f: Optional[Callable] = None) -> int:
    """A worker rank of a mesh (every rank but 0): serve rank 0's sharded
    calls until it stops them, with engines built on this rank's own
    ``params`` from each call's recipe (``sharding.dispatch.worker_loop``);
    ``f`` serves ``Explainer.attribute_adaptive`` calls on ``f``. Each
    engine or explainer it builds first holds this rank's weights
    (``params_digest``; of ``f``, the tensors it reaches) to the digest of
    rank 0's in the recipe, and raises, failing rank 0's call, where they
    differ. Returns the number of calls served."""
    params = tree_map(lambda _, t: t.to(device), params)
    digests: dict[str, str] = {}

    def check(recipe: dict, field: str, weights: Callable[[], Any]) -> None:
        want = recipe.pop(field)
        if field not in digests:
            digests[field] = params_digest(weights())
        if digests[field] != want:
            raise ValueError(f"rank {dist.get_rank()} holds other weights than rank 0 ({field} "
                             f"{digests[field][:16]} against {want[:16]}): every rank of a mesh must "
                             "serve the same model")

    def engine(recipe: dict) -> ExplainEngine:
        check(recipe, "params_digest", lambda: params)
        return ExplainEngine(recipe.pop("cfg"), params, device=device, **recipe)

    def explainer(recipe: dict) -> Explainer:
        check(recipe, "model_digest", lambda: reachable_tensors(f))
        return Explainer(f, device=device, **recipe)

    targets = {"engine": engine}
    if f is not None:
        targets["explainer"] = explainer
    return dispatch.worker_loop(targets, torch.device(device))
