"""The port's ``MixedScheduler`` against ``repro``'s, and its contracts, on the CPU.

Both packages serve ``reduced(ARCHS["llama3-8b"])`` at f32 compute with
``repro``'s seeded weights (through ``lm.params_from_numpy``) behind an
adaptive ``ExplainEngine`` (m=4, n_int=2, ``seq_buckets=(8, 16)``, tol
1e-3, m_max 8) and a scheduler with ``max_len=16``, ``decode_chunk=2``
and one retry, as ``tests/test_scheduler.py`` sets them up. ``repro``'s
scheduler runs once, in a module-scoped fixture, on one mixed workload
(an explain-only request whose ladder is stepped until a hop waits, then
two generate+explain requests, one streamed, one sampled with a seed; the
first hop fails for good); the port's runs the same workload. The sampled
group gets ``repro``'s own Gumbel noise in the port's draw order (the
prefill token's at ``fold_in(PRNGKey(seed), 2**32 − 1)``, then each
chunk's steps at ``fold_in(fold_in(PRNGKey(seed), emitted), k)``).

Tolerances (those of ``tests/test_torch_engine.py`` and
``tests/test_torch_serve.py``): token ids and statuses exactly; token
scores within 1e-4 of the request's largest |score|; f(x′) 1e-6 and the
engine's own f(x) 1e-6 absolute, a donated f(x) (a prefill log-prob) 1e-5;
δ within 1e-6 plus 1e-4 of |f(x) − f(x′)| (sums in another order);
adaptive traces equal, ``converged`` excepted where δ lies within 1e-7 of
its threshold. The port's donated f(x) is within 1e-5 of its engine's own
(the prefill at the prompt's length, the engine padded to its bucket).

The remaining tests run ``tests/test_scheduler.py``'s eleven contracts on
the port (the first in its port form: the donated endpoint within 1e-5,
then the same bits given that endpoint), faults raised inside a decode
chunk and a hop (retried to the clean run's tokens and trace), and the
fault policy's classes on ``tests/test_fault.py``'s sequences.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS, reduced as j_reduced
from repro.models.registry import Model as JModel
from repro.runtime import fault as jfault
from repro.serve import (
    AdaptiveBucketRun as JRun,
    ExplainEngine as JEngine,
    ExplainRequest as JRequest,
    GenerateRequest as JGenerate,
    MixedScheduler as JScheduler,
)
from repro.serve.batching import plan_buckets as j_plan_buckets
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import lm
from repro_torch.runtime import FaultConfig, RetryPolicy, StragglerMonitor
from repro_torch.serve import (
    INTERACTIVE,
    AdaptiveBucketRun,
    ExplainEngine,
    ExplainRequest,
    GenerateRequest,
    MixedScheduler,
    TenantPolicy,
    engine as engine_mod,
)
from repro_torch.serve.batching import plan_buckets

torch.set_num_threads(1)

ENGINE_KW = dict(m=4, n_int=2, seq_buckets=(8, 16), adaptive=True, tol=1e-3, m_max=8)
SCHED_KW = dict(max_len=16, decode_chunk=2)
SEED, TEMP = 7, 0.8


def _cfgs():
    return (dataclasses.replace(j_reduced(J_ARCHS["llama3-8b"]), compute_dtype="float32"),
            dataclasses.replace(reduced(ARCHS["llama3-8b"]), compute_dtype="float32"))


def _workload():
    """(explain-only (tokens, target), generate specs) of the shared workload."""
    rng = np.random.default_rng(0)
    p = lambda n: rng.integers(1, 512, n).astype(np.int32)
    explain = (p(9), 5)
    gens = [dict(tokens=p(6), num_tokens=3, explain=True),
            dict(tokens=p(6), num_tokens=3, explain=True),
            dict(tokens=p(7), num_tokens=3, explain=True, explain_stream=True),
            dict(tokens=p(6), num_tokens=4, temperature=TEMP, seed=SEED)]
    return explain, gens


def _first_hop_fails():
    """A fault hook: every attempt of the first hop's run raises."""
    seen = []

    def hook(kind, payload):
        if kind == "hop":
            seen.append(payload) if not seen else None
            if payload is seen[0]:
                raise RuntimeError("injected hop fault")

    return hook


def _drive(sched, explain_cls, gen_cls):
    """The shared workload: the explain-only request is stepped until a hop
    waits, then the generate requests arrive (their prefill and decode
    preempt the hop) and the loop runs dry with the first hop failing."""
    explain, gens = _workload()
    tickets = [sched.submit(explain_cls(tokens=explain[0], target=explain[1]))]
    while not any(k == "hop" for _, _, k, _ in sched._heap):
        assert sched.step(), "the ladder converged before any hop was queued"
    tickets += [sched.submit(gen_cls(**g)) for g in gens]
    sched.fault_hook = _first_hop_fails()
    sched.run_until_idle()
    sched.fault_hook = None
    return tickets


def _repro_noise(vocab):
    """``repro``'s Gumbel noise for the sampled group (batch 1), in the
    port's draw order."""
    base = jax.random.PRNGKey(SEED)
    keys = [jax.random.fold_in(base, 2**32 - 1)]
    emitted, remaining = 1, _workload()[1][-1]["num_tokens"] - 1
    while remaining:
        n = min(SCHED_KW["decode_chunk"], remaining)
        keys += [jax.random.fold_in(jax.random.fold_in(base, emitted), k) for k in range(n)]
        emitted, remaining = emitted + n, remaining - n
    return [np.asarray(jax.random.gumbel(k, (1, vocab), jax.numpy.float32)) for k in keys]


class _Shared:
    """Both packages' schedulers, run once on the shared workload, and the
    port's engine, which the contract tests go on using."""

    def __init__(self):
        jcfg, tcfg = _cfgs()
        jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
        self.tcfg = tcfg
        self.params = lm.params_from_numpy(jparams, device="cpu")
        self.jeng = JEngine(jcfg, jparams, **ENGINE_KW)
        jsched = JScheduler(self.jeng, fault_cfg=jfault.FaultConfig(max_retries=1, backoff_base_s=0.0),
                            **SCHED_KW)
        self.want = _drive(jsched, JRequest, JGenerate)
        self.want_counts = (self.jeng.stats.degraded, self.jeng.stats.preempted)

        self.engine = ExplainEngine(tcfg, self.params, device="cpu", **ENGINE_KW)
        noise = _repro_noise(tcfg.vocab_size)

        def draw(generator, shape, device):
            if generator.initial_seed() != SEED:  # a greedy group: its noise is never used
                return torch.zeros(shape, device=device)
            a = torch.from_numpy(np.array(noise.pop(0))).to(device)
            assert tuple(a.shape) == tuple(shape)
            return a

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(engine_mod, "gumbel", draw)
            self.got = _drive(_sched(self.engine), ExplainRequest, GenerateRequest)
        assert not noise, "the sampled group drew less noise than repro's"
        self.got_counts = (self.engine.stats.degraded, self.engine.stats.preempted)


def _sched(engine, **kw):
    kw = {**SCHED_KW, "fault_cfg": FaultConfig(max_retries=1, backoff_base_s=0.0), **kw}
    return MixedScheduler(engine, **kw)


@pytest.fixture(scope="module")
def shared():
    return _Shared()


@pytest.fixture
def engine(shared):
    return shared.engine


RNG = np.random.default_rng(1)


def _prompt(n):
    return RNG.integers(1, 512, n).astype(np.int32)


def _results(ticket):
    return [ticket.result] if ticket.kind == "explain" else ticket.attributions


# -- the port against repro on the shared workload --------------------------


def test_statuses_and_counts_match_repro(shared):
    assert [t.status for t in shared.got] == [t.status for t in shared.want]
    assert [t.degraded for t in shared.got] == [t.degraded for t in shared.want]
    assert shared.got_counts == shared.want_counts
    degraded, preempted = shared.got_counts
    assert degraded > 0 and preempted > 0  # the workload exercises both


def test_tokens_match_repro_greedy_and_sampled(shared):
    for g, w in zip(shared.got[1:], shared.want[1:]):
        assert g.tokens.dtype == np.int32
        np.testing.assert_array_equal(g.tokens, np.asarray(w.tokens))
    assert [t.tokens.shape for t in shared.got[1:]] == [(3,), (3,), (3,), (4,)]


def test_scores_and_traces_match_repro(shared):
    for g_t, w_t in zip(shared.got, shared.want):
        got, want = _results(g_t), _results(w_t)
        assert [(a.get("pos"), a.get("token")) for a in got] == [(a.get("pos"), a.get("token"))
                                                                  for a in want]
        for g, w in zip(got, want):
            assert g["bucket"] == w["bucket"] and g["degraded"] == w["degraded"]
            assert g["token_scores"].shape == w["token_scores"].shape
            np.testing.assert_allclose(g["token_scores"], w["token_scores"], rtol=0,
                                       atol=1e-4 * np.abs(w["token_scores"]).max())
            donated = g_t.kind == "generate" and g["pos"] == 0
            assert abs(g["f_x"] - w["f_x"]) <= (1e-5 if donated else 1e-6)
            assert abs(g["f_baseline"] - w["f_baseline"]) <= 1e-6
            assert abs(g["delta"] - w["delta"]) <= 1e-6 + 1e-4 * abs(w["f_x"] - w["f_baseline"])
            assert (g["m_used"], g["hops"]) == (w["m_used"], w["hops"])
            near = min(abs(g["delta"] - g["threshold"]), abs(w["delta"] - w["threshold"])) <= 1e-7
            assert near or g["converged"] == w["converged"]


def test_adaptive_run_degrade_matches_repro(shared):
    """``degrade`` after rung 0: results carry ``degraded``, the hop-zero
    history skips those rows, the counter counts them, a second call
    degrades none."""
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(1, 512, s).astype(np.int32), int(rng.integers(0, 512))) for s in (9, 12, 14)]
    out = {}
    for name, eng, req_cls, plan, run_cls in (
            ("repro", shared.jeng, JRequest, j_plan_buckets, JRun),
            ("port", ExplainEngine(shared.tcfg, shared.params, device="cpu", **ENGINE_KW), ExplainRequest,
             plan_buckets, AdaptiveBucketRun)):
        (bb,) = plan([req_cls(t, g) for t, g in reqs], seq_buckets=ENGINE_KW["seq_buckets"])
        run = run_cls(eng, bb)
        run.start()
        hist0, deg0 = len(eng._delta_hist.get((16, "ig"), [])), eng.stats.degraded
        n = run.degrade()
        assert run.degrade() == 0 and not run.active
        res = run.results()
        out[name] = (n, eng.stats.degraded - deg0, [r["degraded"] for r in res],
                     [r["m_used"] for r in res], len(eng._delta_hist.get((16, "ig"), [])) - hist0)
    assert out["port"] == out["repro"]
    n, counted, flags, _, recorded = out["port"]
    assert n > 0 and counted == n and sum(flags) == n and recorded == len(reqs) - n


# -- tests/test_scheduler.py's contracts on the port -------------------------


def test_donated_f_x_within_1e_5_of_the_engines_own(engine):
    sched = _sched(engine)
    prompts = [_prompt(6), _prompt(7)]
    tickets = [sched.submit(GenerateRequest(tokens=p, num_tokens=2, explain=True)) for p in prompts]
    sched.run_until_idle()
    own = engine.explain([ExplainRequest(p, int(t.tokens[0])) for p, t in zip(prompts, tickets)])
    for t, r in zip(tickets, own):
        assert abs(t.attributions[0]["f_x"] - r["f_x"]) <= 1e-5


def test_donated_endpoint_bit_identical_given_its_f_x(engine):
    """The scheduled ladder, given the donated f(x), is the engine's: the
    same bits and the same adaptive trace."""
    sched = _sched(engine)
    prompts = [_prompt(6), _prompt(7)]
    tickets = [sched.submit(GenerateRequest(tokens=p, num_tokens=2, explain=True)) for p in prompts]
    sched.run_until_idle()
    assert all(t.status == "done" for t in tickets)
    got = [next(a for a in t.attributions if a["pos"] == 0) for t in tickets]
    ref = engine.explain([ExplainRequest(p, int(t.tokens[0]), f_x=a["f_x"])
                          for p, t, a in zip(prompts, tickets, got)])
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g["token_scores"], r["token_scores"])
        for k in ("delta", "f_x", "f_baseline", "m_used", "hops", "converged", "degraded"):
            assert g[k] == r[k], k
        assert not g["degraded"]


def test_streamed_attributions_position_ordered(engine):
    sched = _sched(engine)
    t = sched.submit(GenerateRequest(tokens=_prompt(6), num_tokens=3, explain=True, explain_stream=True))
    sched.run_until_idle()
    assert t.status == "done" and t.tokens.shape == (3,)
    assert [a["pos"] for a in t.attributions] == [0, 1, 2]
    for a in t.attributions:
        assert a["token"] == int(t.tokens[a["pos"]])
        assert a["token_scores"].shape == (6 + a["pos"],)  # prompt + pos emitted tokens
        assert np.isfinite(a["token_scores"]).all()
    assert t.attributions[0]["f_x"] != t.attributions[1]["f_x"]


def test_fault_degrades_only_affected_bucket(engine):
    sched = _sched(engine)
    healthy = [sched.submit(ExplainRequest(tokens=_prompt(6), target=3)) for _ in range(2)]
    poisoned = sched.submit(ExplainRequest(tokens=_prompt(12), target=3))

    def hook(kind, payload):
        if kind in ("exp_start", "hop", "exp_fixed"):
            bucket = payload.bb.bucket if hasattr(payload, "bb") else payload.bucket
            if bucket[1] == 16:
                raise RuntimeError("injected poison")

    degraded0 = engine.stats.degraded
    sched.fault_hook = hook
    sched.run_until_idle()
    sched.fault_hook = None
    assert poisoned.status == "degraded" and poisoned.degraded and poisoned.result["degraded"]
    np.testing.assert_array_equal(poisoned.result["token_scores"], np.zeros(12, np.float32))
    assert engine.stats.degraded == degraded0 + 1
    for t in healthy:
        assert t.status == "done" and not t.degraded
        assert np.isfinite(t.result["token_scores"]).all()
    again = sched.submit(ExplainRequest(tokens=_prompt(12), target=3))
    sched.run_until_idle()
    assert again.status == "done"


def test_decode_failure_keeps_emitted_prefix(engine):
    sched = _sched(engine)
    t = sched.submit(GenerateRequest(tokens=_prompt(6), num_tokens=4))

    def hook(kind, payload):
        if kind == "decode":
            raise RuntimeError("injected decode fault")

    sched.fault_hook = hook
    sched.run_until_idle()
    sched.fault_hook = None
    assert t.status == "degraded"
    assert t.tokens.shape == (1,)  # the prefill token was emitted before decode died


def test_hop_failure_falls_back_to_completed_rung(engine):
    sched = _sched(engine)
    t = sched.submit(ExplainRequest(tokens=_prompt(6), target=3))

    def hook(kind, payload):
        if kind == "hop":
            raise RuntimeError("injected hop fault")

    sched.fault_hook = hook
    sched.run_until_idle()
    sched.fault_hook = None
    assert t.status == "degraded"
    r = t.result
    assert r["degraded"] and not r["converged"]
    assert r["m_used"] == engine.m and r["hops"] == 0
    assert np.isfinite(r["token_scores"]).all() and np.abs(r["token_scores"]).sum() > 0


def test_hops_are_preempted_by_decode(engine):
    sched = _sched(engine)
    preempted0 = engine.stats.preempted
    sched.submit(ExplainRequest(tokens=_prompt(6), target=3))
    while not any(k == "hop" for _, _, k, _ in sched._heap):
        assert sched.step(), "ladder converged before any hop was queued"
    t = sched.submit(GenerateRequest(tokens=_prompt(7), num_tokens=2, slo=INTERACTIVE))
    sched.run_until_idle()
    assert t.status == "done"
    assert engine.stats.preempted > preempted0


def test_backpressure_rejects_above_max_queue(engine):
    sched = _sched(engine, max_queue=1)
    t1 = sched.submit(GenerateRequest(tokens=_prompt(6), num_tokens=1))
    t2 = sched.submit(GenerateRequest(tokens=_prompt(6), num_tokens=1))
    assert (t1.status, t2.status) == ("queued", "rejected_backpressure")
    assert sched.rejected_backpressure == 1
    sched.run_until_idle()
    assert t1.status == "done"


def test_tenant_rate_limit(engine):
    sched = _sched(engine, tenants={"default": TenantPolicy(rate=0.0, burst=1)})
    t1 = sched.submit(ExplainRequest(tokens=_prompt(6), target=1))
    t2 = sched.submit(ExplainRequest(tokens=_prompt(6), target=1))
    assert (t1.status, t2.status) == ("queued", "rejected_rate")
    assert sched.rejected_rate == 1


def test_poisoned_size_degrades_at_admission(engine):
    sched = _sched(engine)
    too_long = sched.submit(ExplainRequest(tokens=_prompt(64), target=1))
    assert too_long.status == "degraded"
    overflow = sched.submit(GenerateRequest(tokens=_prompt(12), num_tokens=8))
    assert overflow.status == "degraded"  # 12 + 8 > max_len=16
    assert overflow.tokens.shape == (0,)
    sched.run_until_idle()  # nothing queued explodes


def test_num_tokens_zero_completes_empty(engine):
    sched = _sched(engine)
    t = sched.submit(GenerateRequest(tokens=_prompt(6), num_tokens=0))
    assert t.status == "done" and t.tokens.shape == (0,)


def test_zero_steady_state_recompiles(engine):
    """Replaying a mixed workload reuses every callable: decode and explain
    are one set on the engine's counters, and replay gives the same bits."""
    sched = _sched(engine)
    prompts = (_prompt(6), _prompt(7))

    def workload():
        ts = [sched.submit(GenerateRequest(tokens=prompts[0], num_tokens=2, explain=True)),
              sched.submit(ExplainRequest(tokens=prompts[1], target=5))]
        sched.run_until_idle()
        return ts

    first = workload()
    misses0 = engine.stats.misses
    ts = workload()
    assert engine.stats.misses == misses0
    assert all(t.status == "done" for t in ts)
    assert sched.decode_stats and all(s.compiles == 1 for s in sched.decode_stats.values())
    np.testing.assert_array_equal(ts[0].tokens, first[0].tokens)
    np.testing.assert_array_equal(ts[1].result["token_scores"], first[1].result["token_scores"])


# -- faults inside a call, retried -------------------------------------------


def _raise_inside(monkeypatch, module, name, at_call):
    """Make ``module.name`` raise once, at its ``at_call``-th call after the
    returned ``arm()``."""
    real, state = getattr(module, name), {"calls": None}

    def wrapped(*a, **kw):
        if state["calls"] is not None:
            state["calls"] += 1
            if state["calls"] == at_call:
                state["calls"] = None
                raise RuntimeError(f"injected fault inside {name}")
        return real(*a, **kw)

    monkeypatch.setattr(module, name, wrapped)
    return lambda: state.__setitem__("calls", 0)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_decode_fault_inside_the_chunk_retries_to_the_clean_tokens(engine, monkeypatch, sampled):
    """A chunk that raises at its second ``decode_step``, once: the retry
    restores the cache's length and the generator's state and decodes the
    clean run's tokens."""
    prompt = _prompt(6)
    kw = dict(temperature=TEMP, seed=1234) if sampled else {}

    def run(hook=None):
        sched = _sched(engine, decode_chunk=3)
        sched.fault_hook = hook
        t = sched.submit(GenerateRequest(tokens=prompt, num_tokens=7, **kw))
        sched.run_until_idle()
        assert t.status == "done" and not t.degraded
        return t.tokens

    clean = run()
    arm = _raise_inside(monkeypatch, lm, "decode_step", at_call=2)
    armed = []

    def hook(kind, payload):
        if kind == "decode" and not armed:
            armed.append(1)
            arm()

    assert np.array_equal(run(hook), clean)
    assert armed


@pytest.mark.parametrize("kind", ["exp_start", "hop"])
def test_explain_fault_inside_the_call_retries_to_the_clean_trace(engine, monkeypatch, kind):
    """A ladder start or hop whose model forward raises once is retried at
    the same rung: the clean run's m_used, hops and bits."""
    req = ExplainRequest(tokens=_prompt(6), target=3)

    def run(hook=None):
        sched = _sched(engine)
        sched.fault_hook = hook
        t = sched.submit(req)
        sched.run_until_idle()
        assert t.status == "done" and not t.degraded
        return t.result

    clean = run()
    assert clean["hops"] > 0
    arm = _raise_inside(monkeypatch, lm, "hidden_from_embeds", at_call=1)
    armed = []

    def hook(item, payload):
        if item == kind and not armed:
            armed.append(1)
            arm()

    got = run(hook)
    assert armed
    for k in ("m_used", "hops", "converged", "delta", "f_x", "f_baseline"):
        assert got[k] == clean[k], k
    np.testing.assert_array_equal(got["token_scores"], clean["token_scores"])


# -- the fault policy against repro's ----------------------------------------


def _flaky(fail_first):
    calls = {"n": 0}

    def fn():
        calls["n"] += 1
        if calls["n"] <= fail_first:
            raise RuntimeError("boom")
        return "ok"

    return fn, calls


@pytest.mark.parametrize("max_retries,fail_first", [(3, 2), (2, 5), (0, 0), (0, 1)])
def test_retry_policy_matches_repro(max_retries, fail_first):
    out = []
    for cfg_cls, policy_cls in ((jfault.FaultConfig, jfault.RetryPolicy), (FaultConfig, RetryPolicy)):
        fn, calls = _flaky(fail_first)
        retried = []
        try:
            res = policy_cls(cfg_cls(max_retries=max_retries, backoff_base_s=0.0))(
                fn, on_retry=lambda a, e: retried.append(a))
        except RuntimeError:
            res = "raised"
        out.append((res, calls["n"], retried))
    assert out[0] == out[1]


@pytest.mark.parametrize("kw,seq", [
    (dict(straggler_threshold=2.0, straggler_ewma=0.5), [1.0] * 5 + [5.0, 1.0]),
    (dict(straggler_threshold=2.0, straggler_warmup=3), [10.0, 0.1, 0.1, 0.1, 0.5]),
])
def test_straggler_monitor_matches_repro(kw, seq):
    jmon, mon = jfault.StragglerMonitor(jfault.FaultConfig(**kw)), StragglerMonitor(FaultConfig(**kw))
    assert [mon.observe(x) for x in seq] == [jmon.observe(x) for x in seq]
    assert mon.flagged == jmon.flagged and len(mon.flagged) == 1
    assert mon.mean == pytest.approx(jmon.mean, rel=0, abs=1e-12)
