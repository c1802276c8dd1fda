"""MixedScheduler of ``repro.serve.scheduler``: one admission-controlled queue
for generate AND explain over one ``ExplainEngine``'s model and parameters.

  * **Bounded queue, backpressure, per-tenant rate and priority classes** —
    ``submit()`` rejects (never blocks, never drops silently) when the queue
    is full (``rejected_backpressure``) or the tenant's token bucket is dry
    (``rejected_rate``); every request carries an ``SLOClass`` whose
    priority orders the dispatch heap.
  * **The donated endpoint** — a generate request with ``explain=True``
    attributes its prompt toward the first emitted token and hands the
    prefill's chosen-token log-prob to the explain request as its
    endpoint f(x) (``ExplainRequest.f_x``), so the α=1 probe forward and
    the endpoint forward are not run again. ``repro`` calls the donated
    value bit-identical to the engine's own probe at f32; here it is not:
    the prefill runs at the prompt's exact length, the engine's forward
    padded to its bucket, so the two sum in other orders (within 1e-5 on
    the reduced LM at f32, ``tests/test_torch_scheduler.py``; the card's
    bf16 gap is printed by ``chip_smoke.py``'s ``mixed`` phase). Later
    positions (``explain_stream=True``) probe themselves: ``f_x=None``.
  * **Preemption** — adaptive hops and forward-only mask batches sit below
    every request class in the heap; a prefill or decode item that
    dispatches while one of them waits counts on ``EngineStats.preempted``.
  * **Degradation, not death** — every model-executing item runs under
    ``runtime.fault.RetryPolicy``; when it exhausts, the AFFECTED requests
    degrade (decode keeps the tokens emitted so far, explain falls back to
    the last completed rung or zero scores) and the loop keeps serving. A
    kernel that fails to build or launch raises there like any fault: no
    item falls back to a plain version. ``StragglerMonitor`` observes each
    item's wall time.

Where ``repro`` AOT-compiles a prefill executable per ``("dprefill", B, S)``
and a decode chunk per ``("dchunk", B, n)``, the scheduler builds one
callable per key, as the engine does: a miss is a build, counted on the
ENGINE's ``hits``/``misses`` and in the scheduler's ``decode_stats``. The
KV cache is written in place, so nothing is donated.

Sampling: each generate group gets one ``torch.Generator`` on the engine's
device, seeded with the group's seed (0 for a greedy group), and draws in a
fixed order: the prefill token's noise (sampled groups only), then every
step of every decode chunk. A retried decode chunk first restores the
cache's length, the generator's state, where local layers hold rings the
ring slots the chunk writes, and where mamba layers hold an SSM state that
state and the conv tail whole (``Model.decode_snapshot``), so it decodes
what its first attempt would have. ``repro`` cannot retry inside a chunk (its
chunk donates the cache), so this exactness is the port's own.

**The result cache** — with an engine ``result_cache``, an explain request
whose content key is cached completes at admission, before backpressure
and rate checks (no queue slot, no tenant budget), and a streamed
position's hit never reaches the explain queue; every finished result is
cached but a degraded one (``_cached_result``/``_cache_result``).

Not ported yet: buckets are padded to no multiple of a data-parallel
extent until the mesh (ROADMAP.md queue 1, item 7).

The dispatch loop is synchronous and cooperative: ``step()`` runs exactly
one work item, so preemption happens between items.
"""
from __future__ import annotations

import heapq
import logging
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from repro_torch.runtime.fault import FaultConfig, RetryPolicy, StragglerMonitor
from repro_torch.serve import engine as engine_mod  # gumbel, looked up at each draw as the chunk's is
from repro_torch.serve.batching import bucket_for, pad_rows, plan_buckets
from repro_torch.serve.engine import make_decode_chunk, make_prefill_step, sample_token
from repro_torch.serve.explain_engine import (
    AdaptiveBucketRun,
    BucketStats,
    ExplainEngine,
    ExplainRequest,
)

log = logging.getLogger(__name__)

# -- request classes ---------------------------------------------------------


@dataclass(frozen=True)
class SLOClass:
    """A latency class: ``priority`` orders the dispatch heap (lower = more
    urgent); ``target_p99_ms`` is the class's reported target (0 = none)."""

    name: str
    priority: int
    target_p99_ms: float = 0.0


INTERACTIVE = SLOClass("interactive", 0, 150.0)
BATCH = SLOClass("batch", 1, 1500.0)
EXPLAIN = SLOClass("explain", 2, 0.0)

# hops and forward-only mask batches sit BELOW every request class: they
# must never starve decode
_PRIO_EXPLAIN_WORK = 10
_PRIO_HOP = 20


@dataclass(frozen=True)
class TenantPolicy:
    """Token-bucket admission: ``rate`` requests/s refill, ``burst`` capacity."""

    rate: float = float("inf")
    burst: int = 8


@dataclass(frozen=True)
class GenerateRequest:
    """A decode request, optionally with attribution riding along.

    ``explain=True`` attributes the prompt toward the FIRST emitted token
    with the donated endpoint; ``explain_stream=True`` also attributes every
    later emitted token (prompt + prefix → token), self-probed. ``seed=None``
    decodes greedily; a seed samples at ``temperature``.
    """

    tokens: np.ndarray  # (S,) int32 prompt
    num_tokens: int
    tenant: str = "default"
    slo: SLOClass = INTERACTIVE
    explain: bool = False
    explain_stream: bool = False
    temperature: float = 0.0
    seed: Optional[int] = None


@dataclass
class Ticket:
    """The caller's handle: filled in as the scheduler makes progress.

    ``status`` ∈ queued | running | done | degraded | rejected_backpressure |
    rejected_rate. ``tokens`` accumulates emitted ids; ``attributions``
    accumulates per-position explain result dicts (each tagged ``pos`` /
    ``token``), sorted by ``pos`` when the ticket finishes; explain-only
    tickets get ``result``.
    """

    id: int
    kind: str  # "generate" | "explain"
    status: str = "queued"
    tenant: str = "default"
    slo: SLOClass = EXPLAIN
    tokens: Optional[np.ndarray] = None
    attributions: list = field(default_factory=list)
    result: Optional[dict] = None
    degraded: bool = False
    submitted_s: float = 0.0
    finished_s: float = 0.0
    # internal completion tracking
    _decode_done: bool = False
    _pending_explains: int = 0

    @property
    def latency_s(self) -> float:
        return self.finished_s - self.submitted_s


class _TokenBucket:
    def __init__(self, policy: TenantPolicy, time_fn: Callable[[], float]):
        self.policy = policy
        self.tokens = float(policy.burst)
        self.time_fn = time_fn
        self._t = time_fn()

    def try_take(self) -> bool:
        now = self.time_fn()
        if self.policy.rate != float("inf"):
            self.tokens = min(float(self.policy.burst), self.tokens + (now - self._t) * self.policy.rate)
        self._t = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


# -- internal work-item payloads --------------------------------------------


@dataclass
class _GenGroup:
    """Same-shape generate requests batched for one prefill + decode stream.

    Grouping key: exact prompt length (a padded prompt's prefill would
    attend over pad tokens), num_tokens and the sampling config. The batch
    axis pads up the engine's batch ladder by repeating the last row;
    pad-row outputs are dropped.
    """

    tickets: list  # real tickets, row-aligned with prompts
    requests: list  # the GenerateRequests, row-aligned with tickets
    prompts: np.ndarray  # (B_pad, S) int32
    n_real: int
    num_tokens: int
    temperature: float
    seed: Optional[int]
    priority: int


@dataclass
class _DecodeStream:
    group: _GenGroup
    cache: dict  # the KV cache, written in place chunk to chunk
    last_tok: torch.Tensor  # (B, 1) on the engine's device
    remaining: int
    emitted: int  # tokens emitted per row so far (incl. the prefill token)
    generator: torch.Generator  # the group's noise, drawn in a fixed order


class MixedScheduler:
    """The unified serving path over one ``ExplainEngine``'s model and params.

    Decode callables (a prefill per exact (B, S), decode chunks) live in the
    scheduler's own cache but count on the ENGINE's hit/miss stats: the
    mixed path's set of callables is one set. Explain work goes through the
    engine's own buckets, start/hop callables and stats, so mixed and
    standalone traffic share every callable. Everything runs on the
    engine's device.

    Args:
        engine: the ``ExplainEngine`` (its cfg/params also serve decode).
        max_len: the KV cache's length (prompt + generation must fit).
        max_queue: bounded-queue capacity (backpressure above it).
        decode_chunk: tokens per preemptible decode work item.
        tenants: name → ``TenantPolicy`` (absent tenants are unlimited).
        fault_cfg / time_fn: fault policy knobs and the clock (injectable
            for tests).

    Example (the reduced LM on the CPU):

        >>> import numpy as np, torch
        >>> from repro_torch.configs import ARCHS, reduced
        >>> from repro_torch.models.registry import Model
        >>> cfg = reduced(ARCHS["llama3-8b"])
        >>> params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
        >>> eng = ExplainEngine(cfg, params, m=4, n_int=2, seq_buckets=(8, 16), device="cpu")
        >>> sched = MixedScheduler(eng, max_len=16, decode_chunk=2)
        >>> t = sched.submit(GenerateRequest(np.arange(1, 7, dtype=np.int32), 3, explain=True))
        >>> sched.run_until_idle()
        >>> t.status, t.tokens.shape, t.attributions[0]["token_scores"].shape
        ('done', (3,), (6,))
    """

    def __init__(
        self,
        engine: ExplainEngine,
        *,
        max_len: int = 128,
        max_queue: int = 64,
        decode_chunk: int = 8,
        tenants: Optional[dict] = None,
        fault_cfg: FaultConfig = FaultConfig(backoff_base_s=0.0),
        time_fn: Callable[[], float] = time.monotonic,
    ):
        assert engine.n_samples == 1, (
            "MixedScheduler serves per-row methods; path-ensemble methods "
            "(n_samples > 1) go through ExplainEngine.explain directly"
        )
        self.engine = engine
        self.max_len = max_len
        self.max_queue = max_queue
        self.decode_chunk = decode_chunk
        self.tenants = tenants or {}
        self.time_fn = time_fn
        self._buckets = {name: _TokenBucket(pol, time_fn) for name, pol in self.tenants.items()}
        self.retry = RetryPolicy(fault_cfg)
        self.monitor = StragglerMonitor(fault_cfg)
        # fault injection for tests and the smoke: called as fault_hook(kind,
        # payload) at the top of every (retried) work-item attempt; raise to
        # inject a failure, sleep to inject a straggler
        self.fault_hook: Optional[Callable[[str, Any], None]] = None

        self._prefill_fn = make_prefill_step(engine.cfg, max_len)
        self._chunk_fn = make_decode_chunk(engine.cfg)
        self._exec_cache: dict[tuple, Callable] = {}
        self.decode_stats: dict[tuple, BucketStats] = {}

        self._heap: list = []  # (priority, seq, kind, payload)
        self._seq = 0
        self._next_id = 0
        self.tickets: list[Ticket] = []
        self._pending_gen: list[tuple[Ticket, GenerateRequest]] = []
        self._pending_exp: list[tuple[Ticket, int, Optional[int], ExplainRequest]] = []
        self._gen_flush_queued = False
        self._exp_flush_queued = False
        self.latencies: dict[str, list[float]] = {}
        self.rejected_backpressure = 0
        self.rejected_rate = 0

    # -- admission -----------------------------------------------------------

    @property
    def queue_depth(self) -> int:
        return len(self._heap) + len(self._pending_gen) + len(self._pending_exp)

    def submit(
        self,
        req: Union[GenerateRequest, ExplainRequest],
        *,
        tenant: str = "default",
        slo: Optional[SLOClass] = None,
    ) -> Ticket:
        """Admit one request; returns its ``Ticket`` at once.

        Rejection (full queue, dry tenant bucket) and admission-time
        degradation (a prompt no bucket or the KV cache can hold: a poisoned
        request must not reach, and kill, the dispatch loop) are reported on
        the ticket, never raised.
        """
        is_gen = isinstance(req, GenerateRequest)
        t = Ticket(
            id=self._next_id,
            kind="generate" if is_gen else "explain",
            tenant=req.tenant if is_gen else tenant,
            slo=(slo or req.slo) if is_gen else (
                slo or (BATCH if self.engine._spec.forward_only else EXPLAIN)
            ),
            submitted_s=self.time_fn(),
        )
        self._next_id += 1
        self.tickets.append(t)
        if not is_gen:
            hit = self._cached_result(req)
            if hit is not None:
                # a replayed result costs no queue slot and no tenant budget,
                # so cached traffic never pushes fresh traffic into rejection
                t.result = hit
                t._decode_done = True
                t._pending_explains = 0
                self._finish(t)
                return t
        if self.queue_depth >= self.max_queue:
            t.status = "rejected_backpressure"
            self.rejected_backpressure += 1
            return t
        bucket = self._buckets.get(t.tenant)
        if bucket is not None and not bucket.try_take():
            t.status = "rejected_rate"
            self.rejected_rate += 1
            return t
        try:  # poisoned-size admission check: degrade, don't explode later
            bucket_for(len(req.tokens), self.engine.seq_buckets)
            if is_gen and len(req.tokens) + req.num_tokens > self.max_len:
                raise ValueError("prompt + generation exceeds KV capacity")
        except ValueError:
            self._degrade_ticket(t)
            return t
        if is_gen:
            t.tokens = np.zeros((0,), np.int32)
            if req.num_tokens <= 0:
                self._finish(t)
                return t
            self._pending_gen.append((t, req))
            if not self._gen_flush_queued:
                self._gen_flush_queued = True
                self._push(t.slo.priority, "gen_flush", None)
        else:
            t._pending_explains = 1
            t._decode_done = True
            self._pending_exp.append((t, -1, None, req))
            if not self._exp_flush_queued:
                self._exp_flush_queued = True
                self._push(_PRIO_EXPLAIN_WORK, "exp_flush", None)
        return t

    # -- dispatch loop -------------------------------------------------------

    def _push(self, priority: int, kind: str, payload: Any) -> None:
        heapq.heappush(self._heap, (priority, self._seq, kind, payload))
        self._seq += 1

    def step(self) -> bool:
        """Dispatch exactly one work item; False when idle."""
        if not self._heap:
            return False
        self.engine.stats.queue_depth = self.queue_depth
        _, _, kind, payload = heapq.heappop(self._heap)
        if kind in ("prefill", "decode") and any(k in ("hop", "exp_fwd") for _, _, k, _ in self._heap):
            # this decode work runs AHEAD of a queued hop or forward-only
            # mask batch: count the deferral
            self.engine.stats.preempted += 1
        handler = {
            "gen_flush": self._do_gen_flush,
            "exp_flush": self._do_exp_flush,
            "prefill": self._do_prefill,
            "decode": self._do_decode,
            "exp_fixed": self._do_exp_fixed,
            "exp_fwd": self._do_exp_fwd,
            "exp_start": self._do_exp_start,
            "hop": self._do_hop,
        }[kind]
        handler(payload)
        self.engine.stats.queue_depth = self.queue_depth
        return True

    def run_until_idle(self) -> None:
        while self.step():
            pass

    # -- flush markers: coalesce pending requests into batched items ---------

    def _do_gen_flush(self, _payload) -> None:
        self._gen_flush_queued = False
        pending, self._pending_gen = self._pending_gen, []
        groups: dict[tuple, list[tuple[Ticket, GenerateRequest]]] = {}
        for t, r in pending:
            groups.setdefault((len(r.tokens), r.num_tokens, r.temperature, r.seed), []).append((t, r))
        for (_, num_tokens, temp, seed), members in groups.items():
            rows, _ = pad_rows(list(range(len(members))), self.engine.batch_buckets)
            grp = _GenGroup(
                tickets=[m[0] for m in members],
                requests=[m[1] for m in members],
                prompts=np.stack([np.asarray(members[i][1].tokens, np.int32) for i in rows]),
                n_real=len(members),
                num_tokens=num_tokens,
                temperature=temp,
                seed=seed,
                priority=min(m[0].slo.priority for m in members),
            )
            self._push(grp.priority, "prefill", grp)

    def _do_exp_flush(self, _payload) -> None:
        self._exp_flush_queued = False
        pending, self._pending_exp = self._pending_exp, []
        forward_only = self.engine._spec.forward_only
        if forward_only:
            # forward-only buckets compute both endpoints themselves
            pending = [(t, pos, tok, replace(r, f_x=None) if r.f_x is not None else r)
                       for (t, pos, tok, r) in pending]
        plan = plan_buckets(
            [p[3] for p in pending],
            seq_buckets=self.engine.seq_buckets,
            batch_buckets=self.engine.batch_buckets,
            max_batch=self.engine.max_batch,
            pad_id=self.engine.pad_id,
        )
        for bb in plan:
            reqmap = [pending[i] for i in bb.indices]
            if forward_only:
                # mask batches are preemptible BATCH-class work, at the hop rung
                self._push(_PRIO_HOP, "exp_fwd", (bb, reqmap))
            elif self.engine.adaptive:
                self._push(_PRIO_EXPLAIN_WORK, "exp_start", (AdaptiveBucketRun(self.engine, bb), reqmap))
            else:
                self._push(_PRIO_EXPLAIN_WORK, "exp_fixed", (bb, reqmap))

    # -- decode items --------------------------------------------------------

    def _cached(self, key: tuple, build: Callable[[], Callable]) -> Callable:
        """The decode callable for ``key``, built on a miss; counted on the
        ENGINE's hit/miss stats so the mixed path's callables are one set.
        The cache is the scheduler's own: its prefill is built for its
        ``max_len``."""
        fn = self._exec_cache.get(key)
        if fn is not None:
            self.engine.stats.hits += 1
            return fn
        self.engine.stats.misses += 1
        bs = self.decode_stats.setdefault(key, BucketStats())
        bs.compiles += 1
        t0 = time.perf_counter()
        fn = self._exec_cache[key] = build()
        bs.compile_s += time.perf_counter() - t0
        return fn

    def _do_prefill(self, grp: _GenGroup) -> None:
        eng = self.engine
        B, S = grp.prompts.shape
        batch = {"tokens": torch.as_tensor(grp.prompts, device=eng.device)}
        prefill = self._cached(("dprefill", B, S), lambda: self._prefill_fn)
        ok, out = self._run_item("prefill", grp, lambda: prefill(eng.params, batch))
        if not ok:
            for t in grp.tickets:
                self._degrade_ticket(t)
            return
        logits, cache = out
        lg = logits[:, -1].float()
        gen = torch.Generator(device=eng.device).manual_seed(grp.seed if grp.seed is not None else 0)
        if grp.seed is None:
            tok = torch.argmax(lg, dim=-1).to(torch.int32)
        else:
            tok = sample_token(lg, engine_mod.gumbel(gen, lg.shape, lg.device), grp.temperature)
        # the chosen token's log-prob is the explain endpoint f(x)
        lp = torch.log_softmax(lg, dim=-1).gather(1, tok[:, None].long())[:, 0]
        tok_np, lp_np = tok.cpu().numpy(), lp.cpu().numpy()
        for row in range(grp.n_real):
            t, req = grp.tickets[row], grp.requests[row]
            t.status = "running"
            t.tokens = np.append(t.tokens, tok_np[row]).astype(np.int32)
            if req.explain:
                self._enqueue_explain(t, pos=0, token=int(tok_np[row]),
                                      prompt=np.asarray(req.tokens, np.int32), f_x=float(lp_np[row]))
        if grp.num_tokens > 1:
            self._push(grp.priority, "decode", _DecodeStream(
                group=grp, cache=cache, last_tok=tok[:, None], remaining=grp.num_tokens - 1,
                emitted=1, generator=gen))
        else:
            for t in grp.tickets:
                t._decode_done = True
                self._maybe_finish(t)

    def _do_decode(self, st: _DecodeStream) -> None:
        eng, grp = self.engine, st.group
        n = min(self.decode_chunk, st.remaining)
        temp = grp.temperature if grp.seed is not None else 0.0
        chunk = self._cached(
            ("dchunk", grp.prompts.shape[0], n),
            lambda: lambda cache, tok, gen, t: self._chunk_fn(eng.params, cache, tok, gen, t, n))
        # every attempt starts from the state the first one found: the
        # generator's, and the cache's that the chunk overwrites and still
        # reads (its length, the ring slots of local layers, mamba layers' states)
        restore_cache, gen_state = eng.model.decode_snapshot(st.cache, n), st.generator.get_state()

        def attempt():
            restore_cache()
            st.generator.set_state(gen_state)
            return chunk(st.cache, st.last_tok, st.generator, temp)

        ok, out = self._run_item("decode", st, attempt)
        if not ok:
            # the emitted prefix is the fallback result
            for t in grp.tickets:
                self._degrade_ticket(t, keep_tokens=True)
            return
        toks, _, st.cache = out
        toks_np = toks.cpu().numpy()
        for row in range(grp.n_real):
            t, req = grp.tickets[row], grp.requests[row]
            if t.degraded:
                continue
            for k in range(n):
                pos, tok_id = st.emitted + k, int(toks_np[row, k])
                t.tokens = np.append(t.tokens, tok_id).astype(np.int32)
                if req.explain_stream:
                    prefix = np.concatenate([np.asarray(req.tokens, np.int32), t.tokens[:pos]])
                    self._enqueue_explain(t, pos=pos, token=tok_id, prompt=prefix, f_x=None)
        st.last_tok = toks[:, -1:]
        st.remaining -= n
        st.emitted += n
        if st.remaining > 0:
            self._push(grp.priority, "decode", st)
        else:
            for t in grp.tickets:
                t._decode_done = True
                self._maybe_finish(t)

    # -- explain items -------------------------------------------------------

    def _cached_result(self, req: ExplainRequest) -> Optional[dict]:
        """The engine's result cache's entry for ``req`` (a fresh copy, raw
        row dropped: tickets carry caller-facing dicts), or None."""
        rc = self.engine.result_cache
        if rc is None:
            return None
        hit = rc.get(self.engine.request_cache_key(req))
        self.engine._sync_result_stats()
        if hit is not None:
            hit.pop("raw_token_scores", None)
        return hit

    def _cache_result(self, req: ExplainRequest, r: dict) -> None:
        """Cache one finished result; a degraded fallback never is (replaying
        a fault's zero vector forever would be wrong)."""
        rc = self.engine.result_cache
        if rc is not None and not r.get("degraded"):
            rc.put(self.engine.request_cache_key(req), r)
            self.engine._sync_result_stats()

    def _enqueue_explain(self, t: Ticket, *, pos: int, token: int, prompt: np.ndarray,
                         f_x: Optional[float]) -> None:
        t._pending_explains += 1
        if len(prompt) > max(self.engine.seq_buckets):
            self._deliver_degraded(t, pos, token, n_tokens=len(prompt))
            return
        req = ExplainRequest(tokens=prompt, target=token, f_x=f_x)
        hit = self._cached_result(req)
        if hit is not None:  # this position's attribution never reaches the queue
            self._deliver(t, pos, token, hit)
            return
        self._pending_exp.append((t, pos, token, req))
        if not self._exp_flush_queued:
            self._exp_flush_queued = True
            self._push(_PRIO_EXPLAIN_WORK, "exp_flush", None)

    def _deliver_bucket(self, bb, reqmap, res, per_token: torch.Tensor) -> None:
        """One result dict per request of a fixed-budget or forward-only
        bucket (``per_token`` (B, S), exactly 0 at padding)."""
        per_token = per_token.cpu().numpy()
        delta, f_x, f_b = (v.cpu().numpy() for v in (res.delta, res.f_x, res.f_baseline))
        for row, (t, pos, token, req) in enumerate(reqmap):
            r = {
                "token_scores": per_token[row, : bb.lens[row]],
                "delta": float(delta[row]),
                "f_x": float(f_x[row]),
                "f_baseline": float(f_b[row]),
                "bucket": bb.bucket,
                "degraded": False,
                "raw_token_scores": per_token[row],
            }
            self._cache_result(req, r)
            self._deliver(t, pos, token, r)

    def _degrade_items(self, reqmap) -> None:
        self.engine.stats.degraded += len(reqmap)
        for (t, pos, token, req) in reqmap:
            self._deliver_degraded(t, pos, token, n_tokens=len(req.tokens))

    def _do_exp_fixed(self, payload) -> None:
        bb, reqmap = payload
        ok, res = self._run_item("exp_fixed", bb, lambda: self.engine._run_bucket(bb))
        if not ok:
            self._degrade_items(reqmap)
            return
        self._deliver_bucket(bb, reqmap, res, res.attributions.sum(-1))

    def _do_exp_fwd(self, payload) -> None:
        bb, reqmap = payload
        ok, res = self._run_item("exp_fwd", bb, lambda: self.engine._run_bucket_fwd(bb))
        if not ok:
            self._degrade_items(reqmap)
            return
        # perturbation scores are per POSITION already: no feature axis
        self._deliver_bucket(bb, reqmap, res, res.attributions)

    def _do_exp_start(self, payload) -> None:
        run, reqmap = payload
        ok, _ = self._run_item("exp_start", run, run.start)
        if not ok:
            # rung 0 never ran: there is no partial result to fall back to
            self._degrade_items(reqmap)
            return
        self._next_rung(payload)

    def _do_hop(self, payload) -> None:
        run, _ = payload
        ok, _ = self._run_item("hop", run, run.hop)
        if not ok:
            # the completed rungs stand: degrade ONLY the still-active rows
            run.degrade()
        self._next_rung(payload)

    def _next_rung(self, payload) -> None:
        run, reqmap = payload
        if run.active:
            self._push(_PRIO_HOP, "hop", payload)
            return
        # results arrive in bb.indices order, which is reqmap's
        for r, (t, pos, token, req) in zip(run.results(), reqmap):
            r.pop("request", None)
            self._cache_result(req, r)
            self._deliver(t, pos, token, r)

    # -- completion / degradation -------------------------------------------

    def _deliver(self, t: Ticket, pos: int, token: Optional[int], r: dict) -> None:
        r.pop("raw_token_scores", None)
        if t.kind == "explain":
            t.result = r
        else:
            t.attributions.append({"pos": pos, "token": token, **r})
        if r.get("degraded"):
            t.degraded = True
        t._pending_explains -= 1
        self._maybe_finish(t)

    def _deliver_degraded(self, t: Ticket, pos: int, token: Optional[int], *, n_tokens: int) -> None:
        """Zero-attribution fallback for a request whose explain work could
        not run at all (fault exhaustion, unservable size)."""
        t.degraded = True
        self._deliver(t, pos, token, {"token_scores": np.zeros((n_tokens,), np.float32),
                                      "delta": float("inf"), "degraded": True, "converged": False})

    def _degrade_ticket(self, t: Ticket, *, keep_tokens: bool = False) -> None:
        t.degraded = True
        self.engine.stats.degraded += 1
        if t.kind == "generate" and (t.tokens is None or not keep_tokens):
            t.tokens = np.zeros((0,), np.int32)
        t._decode_done = True
        t._pending_explains = 0
        t.status = "degraded"
        t.finished_s = self.time_fn()
        self._record_latency(t)

    def _maybe_finish(self, t: Ticket) -> None:
        if t._decode_done and t._pending_explains <= 0 and t.status not in ("done", "degraded"):
            self._finish(t)

    def _finish(self, t: Ticket) -> None:
        t.status = "degraded" if t.degraded else "done"
        # bucket interleave may deliver out of emission order; the caller
        # sees the per-token stream position-ordered
        t.attributions.sort(key=lambda a: a["pos"])
        t.finished_s = self.time_fn()
        self._record_latency(t)

    def _record_latency(self, t: Ticket) -> None:
        self.latencies.setdefault(t.slo.name, []).append(t.latency_s)

    def _run_item(self, kind: str, payload: Any, fn: Callable):
        """One retried, straggler-observed work item. Returns (ok, result);
        ``ok=False`` means the retry policy exhausted: the caller degrades
        the affected requests and the loop keeps serving. On the card each
        attempt ends with a synchronise, so a fault of the device surfaces
        inside its item and the monitor sees device time."""
        t0 = time.perf_counter()

        def attempt():
            if self.fault_hook is not None:
                self.fault_hook(kind, payload)
            out = fn()
            if self.engine.device.type == "cuda":
                torch.cuda.synchronize(self.engine.device)
            return out

        try:
            out, ok = self.retry(attempt), True
        except Exception:  # noqa: BLE001 — the degradation boundary
            log.warning("%s item failed after %d retries; degrading its requests", kind,
                        self.retry.cfg.max_retries, exc_info=True)
            out, ok = None, False
        self.monitor.observe(time.perf_counter() - t0)
        return ok, out

    # -- reporting -----------------------------------------------------------

    def latency_summary(self) -> dict:
        """Per-SLO-class p50/p99 (seconds) over completed tickets."""
        out = {}
        for name, vals in self.latencies.items():
            v = np.asarray(vals)
            out[name] = {"n": int(v.size), "p50_s": float(np.percentile(v, 50)),
                         "p99_s": float(np.percentile(v, 99))}
        return out
