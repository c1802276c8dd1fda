"""The port's caches against ``repro``'s, on the CPU: fingerprints, the result
cache, the roofline-priced tuner and warm state.

Cross-package parity (live ``repro`` calls, never golden fixtures, never
``repro``'s warm restore as an oracle): ``config_fingerprint``,
``params_fingerprint`` and ``model_fingerprint`` on reduced llama3-8b,
gemma3-27b and yi-9b with ``repro``'s seeded weights (through
``lm.params_from_numpy``) and on bf16 leaves; ``_context_parts``,
``warm_context`` and ``request_cache_key`` for engines built with the same
knobs (``use_kernels=False`` on both); ``hardware_for`` on every kind
``repro`` maps, ``hotpath_terms``, ``chunk_candidates``, ``bucket_key``,
``cache_path`` and ``AutotuneCache.entries_fingerprint``; ``ResultCache``'s
counters over one put/get sequence; ``sha256_file``; the exports of
``serve``. Everything else holds the port's own engine (reduced llama3-8b,
f32, ``repro``'s weights) to ``repro``'s contracts of
``tests/test_result_cache.py`` and ``tests/test_hotpath.py``, and the warm
state to the replay form: exact equality throughout (same process, same
device, same bits).
"""
import dataclasses
import functools
import json
import os
import warnings

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as j_manager
from repro.configs import ARCHS as J_ARCHS, reduced as j_reduced
from repro.core import fingerprint as j_fp
from repro.models.registry import Model as JModel
from repro.roofline import analyze as j_roofline
from repro.serve import ExplainEngine as JEngine, ExplainRequest as JRequest
from repro.serve import ResultCache as JResultCache
from repro.serve import autotune as j_autotune
from repro_torch.checkpoint import atomic_dir, sha256_file
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import fingerprint as fp
from repro_torch.models import lm
from repro_torch.roofline import HW_H100, Hardware, analyze as roofline
from repro_torch.runtime import FaultConfig
from repro_torch.serve import (
    AutotuneCache,
    ExplainEngine,
    ExplainRequest,
    ExplainService,
    GenerateRequest,
    HotpathConfig,
    MixedScheduler,
    ResultCache,
    autotune,
    autotune_engine,
    load_warm_state,
    save_warm_state,
)
from repro_torch.serve.result_cache import _entry_bytes

torch.set_num_threads(1)

KW = dict(m=4, n_int=2, seq_buckets=(8, 16))
ADAPTIVE = dict(adaptive=True, tol=1e-3, m_max=16, hop_zero=True, hop_zero_min=2)
LENS = (5, 7, 12, 3, 9)


def _cfgs(name="llama3-8b"):
    return (dataclasses.replace(j_reduced(J_ARCHS[name]), compute_dtype="float32"),
            dataclasses.replace(reduced(ARCHS[name]), compute_dtype="float32"))


@functools.cache
def _jax_params(name="llama3-8b", seed=0):
    return JModel(_cfgs(name)[0]).init(jax.random.PRNGKey(seed))


@functools.cache
def _port_params(name="llama3-8b", seed=0):
    return lm.params_from_numpy(_jax_params(name, seed), device="cpu")


def _engine(seed=0, **kw):
    return ExplainEngine(_cfgs()[1], _port_params(seed=seed), device="cpu", **{**KW, **kw})


def _tokens(n, seed=0):
    return np.random.default_rng(seed).integers(1, 512, n).astype(np.int32)


def _req(n=7, seed=0, target=3, **kw):
    return ExplainRequest(_tokens(n, seed), target, **kw)


def _traffic(lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [ExplainRequest(rng.integers(1, 512, s).astype(np.int32), int(rng.integers(0, 512))) for s in lens]


def _same(a: list, b: list) -> None:
    """Result dicts equal key for key, arrays bit for bit."""
    for x, y in zip(a, b, strict=True):
        assert x.keys() == y.keys()
        for k in x:
            if isinstance(x[k], np.ndarray):
                np.testing.assert_array_equal(x[k], y[k])
            else:
                assert x[k] == y[k], k


# -- fingerprints ------------------------------------------------------------


@pytest.mark.parametrize("name", ["llama3-8b", "gemma3-27b", "yi-9b"])
def test_fingerprints_match_repro(name):
    jcfg, tcfg = _cfgs(name)
    jp, tp = _jax_params(name), _port_params(name)
    assert repr(jcfg) == repr(tcfg)
    assert fp.config_fingerprint(tcfg) == j_fp.config_fingerprint(jcfg)
    assert fp.params_fingerprint(tp) == j_fp.params_fingerprint(jp)
    assert fp.model_fingerprint(tcfg, tp) == j_fp.model_fingerprint(jcfg, jp)


def test_params_fingerprint_bf16_leaves_match_repro():
    """bf16 leaves hash as their raw 16-bit words under the dtype name
    ``bfloat16``; a 0-d leaf keeps its shape ``()``."""
    rng = np.random.default_rng(0)
    a32 = rng.standard_normal((3, 5)).astype(np.float32)
    jtree = {"w": a32.astype(ml_dtypes.bfloat16), "b": (np.float32(2.5), np.arange(4, dtype=np.int32))}
    ttree = {"w": torch.from_numpy(a32).to(torch.bfloat16),
             "b": (torch.tensor(2.5), torch.arange(4, dtype=torch.int32))}
    assert fp.params_fingerprint(ttree) == j_fp.params_fingerprint(jtree)
    ttree["w"] = ttree["w"].float()  # same values, another dtype: another identity
    assert fp.params_fingerprint(ttree) != j_fp.params_fingerprint(jtree)


# -- engine identity against repro -------------------------------------------

# knob sets built identically on both engines; sample_seed/n_samples/sigma
# only reach the context through the ensemble methods
KNOBS = {
    "ig": {},
    "idgi fused": dict(method="idgi", fused=True),
    "noise_tunnel": dict(method="noise_tunnel", sample_seed=3, n_samples=4, sigma=0.2),
    "adaptive": dict(adaptive=True, tol=1e-2, m_max=32),
    "occlusion": dict(method="occlusion", n_masks=16),
    "flash, pad 1, chunk 2": dict(attn="flash", pad_id=1, chunk=2, schedule="uniform"),
}


@pytest.mark.parametrize("knobs", list(KNOBS), ids=list(KNOBS))
def test_context_and_request_keys_match_repro(knobs, tmp_path):
    jcfg, tcfg = _cfgs()
    kw = {**KW, "use_kernels": False, **KNOBS[knobs]}
    jeng = JEngine(jcfg, _jax_params(), **kw)
    teng = ExplainEngine(tcfg, _port_params(), device="cpu", **kw)
    assert teng._context_parts() == jeng._context_parts()
    assert repr(teng._context_parts()) == repr(jeng._context_parts())
    assert teng.warm_context() == jeng.warm_context()
    feats = np.random.default_rng(1).standard_normal((6, 3)).astype(np.float32)
    for n, seed, target, f_x, f in ((7, 0, 3, None, None), (12, 2, 5, None, None), (7, 0, 3, -1.25, None),
                                    (6, 4, 1, None, feats)):
        tok = _tokens(n, seed)
        got = teng.request_cache_key(ExplainRequest(tok, target, features=f, f_x=f_x))
        assert got == jeng.request_cache_key(JRequest(tok, target, features=f, f_x=f_x))


def test_request_keys_with_autotune_entries_match_repro(tmp_path):
    """Both engines load the same tuned file: the entries' fingerprint rides
    both keys alike."""
    entries = {j_autotune.bucket_key((1, 8), "riemann", "paper", 4, 2, False): {"chunk": 2, "latency_s": 0.5}}
    with open(j_autotune.cache_path(str(tmp_path), "cpu"), "w") as fh:
        json.dump({"device": "cpu", "entries": entries}, fh)
    jcfg, tcfg = _cfgs()
    kw = {**KW, "use_kernels": False, "autotune": True, "autotune_dir": str(tmp_path)}
    jeng = JEngine(jcfg, _jax_params(), **kw)
    teng = ExplainEngine(tcfg, _port_params(), device="cpu", **kw)
    assert teng._autotune_cache.entries == entries
    assert teng.warm_context() == jeng.warm_context()
    tok = _tokens(7)
    assert teng.request_cache_key(ExplainRequest(tok, 3)) == jeng.request_cache_key(JRequest(tok, 3))
    assert teng._cfg_for((1, 8)) == HotpathConfig(2) and teng._cfg_for((2, 8)) == HotpathConfig(0)


# -- roofline and the tuner's helpers against repro --------------------------

KINDS = ("cpu", "TPU v5 lite", "TPU v4", "tpu v6e", "gpu", "cuda", "NVIDIA A100-SXM4-80GB",
         "nvidia_a100_sxm4_80gb", "Quadro RTX 6000", "some accelerator")


@pytest.mark.parametrize("kind", KINDS)
def test_hardware_for_matches_repro(kind):
    assert dataclasses.asdict(roofline.hardware_for(kind)) == dataclasses.asdict(j_roofline.hardware_for(kind))


@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3", "nvidia_h100_80gb_hbm3", "H100 PCIe"])
def test_hardware_for_h100(kind):
    """The one row ``repro`` lacks: matched ahead of the generic GPU rows."""
    assert roofline.hardware_for(kind) is HW_H100
    assert j_roofline.hardware_for(kind).name == "generic_gpu"
    assert (HW_H100.peak_flops, HW_H100.hbm_bw, HW_H100.link_bw, HW_H100.hbm_bytes) == (989e12, 3.35e12,
                                                                                         450e9, 80e9)


def test_hotpath_terms_and_hardware_rows_match_repro():
    for name in ("HW_V5E", "HW_GENERIC_GPU", "HW_CPU_HOST"):
        assert dataclasses.asdict(getattr(roofline, name)) == dataclasses.asdict(getattr(j_roofline, name))
    for cost in ({"bytes accessed": 3e9, "flops": 1e12}, {"flops": 5e14}, {"bytes accessed": 7.0}, {}):
        for hw_name in ("HW_V5E", "HW_CPU_HOST"):
            assert (roofline.hotpath_terms(cost, getattr(roofline, hw_name))
                    == j_roofline.hotpath_terms(cost, getattr(j_roofline, hw_name)))


def test_tuner_helpers_match_repro(tmp_path):
    for m in range(1, 70):
        assert autotune.chunk_candidates(m) == j_autotune.chunk_candidates(m)
    for args in (((4, 32), "riemann", "paper", 64, 4, False), ((1, 8), "idgi", "uniform", 8, 2, True)):
        for attn in ("auto", "flash"):
            assert autotune.bucket_key(*args, attn=attn) == j_autotune.bucket_key(*args, attn=attn)
    assert autotune.cache_path(str(tmp_path), "cpu") == j_autotune.cache_path(str(tmp_path), "cpu")
    a, b = AutotuneCache(kind="cpu"), j_autotune.AutotuneCache(device="cpu")
    assert a.entries_fingerprint() == b.entries_fingerprint()
    for key, chunk in (("B4xS32/riemann/paper/m64/n4/unfused", 16), ("B1xS8/riemann/paper/m4/n2/fused", 2)):
        metrics = {"latency_s": 0.125, "bound_s": 0.0625, "dominant": "compute", "bytes_accessed": 1e9}
        a.put(key, HotpathConfig(chunk), metrics)
        b.put(key, j_autotune.HotpathConfig(chunk), metrics)
        assert a.entries == b.entries and a.entries_fingerprint() == b.entries_fingerprint()
    assert autotune.device_kind("cpu") == j_autotune.device_kind() == "cpu"


def test_result_cache_counters_match_repro():
    """One put/get sequence, oversize refusal and a repeated put included."""
    rng = np.random.default_rng(0)
    entry = lambda n: {"token_scores": rng.standard_normal(n).astype(np.float32), "delta": 0.5,
                       "bucket": (1, 8)}
    size = _entry_bytes(entry(64))
    ours, theirs = ResultCache(max_bytes=3 * size), JResultCache(max_bytes=3 * size)
    ops = [("put", "k0", entry(64)), ("put", "k1", entry(64)), ("get", "k0"), ("put", "k2", entry(64)),
           ("put", "k3", entry(64)), ("get", "k1"), ("get", "k0"), ("put", "big", entry(4096)),
           ("put", "k0", entry(64)), ("put", "k0", entry(16)), ("get", "k3"), ("get", "absent"),
           ("put", "k4", entry(64)), ("get", "k2")]
    for op in ops:
        if op[0] == "put":
            ours.put(op[1], op[2])
            theirs.put(op[1], op[2])
        else:
            got, want = ours.get(op[1]), theirs.get(op[1])
            assert (got is None) == (want is None)
            if got is not None:
                _same([got], [want])
        assert (ours.hits, ours.misses, ours.evictions, ours.bytes, len(ours)) == (
            theirs.hits, theirs.misses, theirs.evictions, theirs.bytes, len(theirs))
        assert ours.bytes <= ours.max_bytes
    assert ours.evictions >= 2 and "big" not in ours


def test_checkpoint_helpers(tmp_path):
    path = tmp_path / "blob"
    path.write_bytes(np.random.default_rng(0).bytes(3 << 20))
    assert sha256_file(str(path)) == j_manager.sha256_file(str(path))
    final = str(tmp_path / "state")
    with atomic_dir(final) as tmp:
        open(os.path.join(tmp, "a"), "w").write("1")
    with pytest.raises(RuntimeError):
        with atomic_dir(final) as tmp:
            open(os.path.join(tmp, "a"), "w").write("2")
            raise RuntimeError("crash mid-write")
    assert open(os.path.join(final, "a")).read() == "1"
    assert sorted(os.listdir(tmp_path)) == ["blob", "state"]  # no temporary left behind


def test_serve_exports_match_repro():
    import repro.serve
    import repro_torch.serve

    assert sorted(repro_torch.serve.__all__) == sorted(repro.serve.__all__)


# -- repro's result-cache contracts on the port's engine ----------------------

VARIANTS = {
    "method": dict(method="idgi"),
    "schedule": dict(schedule="uniform"),
    "m": dict(m=8),
    "baseline pad id": dict(pad_id=1),
    "attn": dict(attn="flash"),
    "fused": dict(fused=True),
    "adaptive": dict(adaptive=True, tol=1e-2),
    "weights": dict(seed=1),
}


@pytest.mark.parametrize("variant", list(VARIANTS), ids=list(VARIANTS))
def test_key_moves_with_every_knob(variant):
    req = _req()
    base = _engine().request_cache_key(req)
    assert _engine().request_cache_key(req) == base, "the same engine and request give the same key"
    assert _engine(**VARIANTS[variant]).request_cache_key(req) != base


def test_key_moves_with_sample_seed_and_mesh():
    req = _req()
    nt = _engine(method="noise_tunnel")
    assert _engine(method="noise_tunnel", sample_seed=1).request_cache_key(req) != nt.request_cache_key(req)
    eng = _engine()
    base = eng.request_cache_key(req)
    eng._mesh_key = (("data", 2), ("model", 1))  # what a dp=2 mesh would record
    assert eng.request_cache_key(req) != base


@pytest.mark.parametrize("other", [dict(seed=1), dict(target=5), dict(n=9)], ids=["tokens", "target", "length"])
def test_key_moves_with_the_request(other):
    eng = _engine()
    assert eng.request_cache_key(_req(**other)) != eng.request_cache_key(_req())


def test_key_ignores_batch_composition():
    eng = _engine(result_cache=1 << 20)
    reqs = [_req(7), _req(12, seed=2), _req(7, seed=3)]
    batched = eng.explain(reqs)
    solo = eng.explain([reqs[0]])[0]
    assert eng.stats.result_hits == 1 and eng.stats.result_misses == 3
    np.testing.assert_array_equal(solo["token_scores"], batched[0]["token_scores"])


def test_hit_is_bit_identical_and_tamper_proof():
    eng = _engine(result_cache=1 << 20)
    reqs = [_req(), _req(12, seed=2)]
    first = eng.explain(reqs)
    fresh = _engine().explain(reqs)
    hit = eng.explain(reqs)
    assert (eng.stats.result_hits, eng.stats.result_misses) == (2, 2)
    assert eng.stats.result_hit_rate == 0.5 and eng.stats.result_bytes > 0
    _same(first, hit)
    _same(hit, fresh)
    hit[0]["token_scores"][:] = -1.0  # a caller's change never reaches the stored bytes
    _same(eng.explain([reqs[0]]), first[:1])


def test_raw_rows_served_from_cache():
    eng = _engine(result_cache=1 << 20)
    req = _req()
    assert "raw_token_scores" not in eng.explain([req])[0]
    raw = eng.explain([req], return_raw=True)[0]
    assert eng.stats.result_hits == 1
    assert raw["raw_token_scores"].shape == (8,) and np.all(raw["raw_token_scores"][7:] == 0)


def _sched(eng):
    return MixedScheduler(eng, max_len=16, decode_chunk=2, fault_cfg=FaultConfig(max_retries=1, backoff_base_s=0.0))


@pytest.mark.parametrize("adaptive", [False, True], ids=["fixed", "adaptive"])
def test_scheduler_cached_explain_completes_at_admission(adaptive):
    eng = _engine(result_cache=1 << 20, **(dict(adaptive=True, tol=1e-2) if adaptive else {}))
    sched = _sched(eng)
    req = _req()
    t1 = sched.submit(req)
    sched.run_until_idle()
    assert t1.status == "done"
    t2 = sched.submit(req)
    assert t2.status == "done", "a cached request completes at admission"
    assert sched.queue_depth == 0 and eng.stats.result_hits == 1
    np.testing.assert_array_equal(t1.result["token_scores"], t2.result["token_scores"])
    assert "raw_token_scores" not in t2.result


def test_scheduler_streamed_position_hits_the_cache():
    """A generate's explain position whose key is cached never reaches the
    explain queue: the second identical generate replays it."""
    eng = _engine(result_cache=1 << 20)
    req = GenerateRequest(tokens=_tokens(6, seed=5), num_tokens=2, explain=True)
    sched = _sched(eng)
    t1 = sched.submit(req)
    sched.run_until_idle()
    hits = eng.stats.result_hits
    t2 = sched.submit(req)
    sched.run_until_idle()
    assert t1.status == t2.status == "done" and eng.stats.result_hits == hits + 1
    _same(t2.attributions, t1.attributions)


def test_degraded_results_never_cached():
    eng = _engine(result_cache=1 << 20)
    sched = _sched(eng)

    def poison(kind, payload):
        if kind.startswith("exp"):
            raise RuntimeError("injected")

    sched.fault_hook = poison
    req = _req(seed=9)
    t1 = sched.submit(req)
    sched.run_until_idle()
    assert t1.status == "degraded" and len(eng.result_cache) == 0
    sched.fault_hook = None
    t2 = sched.submit(req)
    sched.run_until_idle()
    assert t2.status == "done" and not t2.result["degraded"]


# -- the tuner ---------------------------------------------------------------


@pytest.mark.parametrize("payload", ['{"device": "cpu", "entr', "[1, 2, 3]"], ids=["truncated", "list"])
def test_autotune_load_unreadable_warns_and_empties(payload, tmp_path):
    with open(autotune.cache_path(str(tmp_path), "cpu"), "w") as fh:
        fh.write(payload)
    with pytest.warns(UserWarning, match="unreadable"):
        cache = AutotuneCache.load(str(tmp_path), "cpu")
    assert cache.entries == {}


def test_autotune_load_other_device_ignores_entries(tmp_path):
    with open(autotune.cache_path(str(tmp_path), "cpu"), "w") as fh:
        json.dump({"device": "tpu-v9000", "entries": {"k": {"chunk": 2}}}, fh)
    with pytest.warns(UserWarning, match="tuned for device"):
        cache = AutotuneCache.load(str(tmp_path), "cpu")
    assert cache.kind == "cpu" and cache.entries == {}


def test_autotune_entries_fingerprint_tracks_entries():
    a = AutotuneCache(kind="cpu")
    fp0 = a.entries_fingerprint()
    a.put("k", HotpathConfig(chunk=2), {"wall_s": 0.1})
    assert a.entries_fingerprint() != fp0
    assert AutotuneCache(kind="cpu", entries=dict(a.entries)).entries_fingerprint() == a.entries_fingerprint()


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_autotuned_engine_zero_misses_and_equals_fixed_chunk(fused, tmp_path):
    reqs = _traffic()
    eng = _engine(m=8, fused=fused)
    report = autotune_engine(eng, reqs, rounds=1, results_dir=str(tmp_path))
    assert eng.stats.misses == 0 and not eng.stats.buckets, "tuning leaves the engine's cache and stats"
    assert report["path"] == autotune.cache_path(str(tmp_path), "cpu")
    tuned = _engine(m=8, fused=fused, autotune=True, autotune_dir=str(tmp_path))
    out = tuned.explain(reqs)
    misses = tuned.stats.misses
    _same(tuned.explain(reqs), out)
    assert tuned.stats.misses == misses, "an autotuned replay is all hits"
    winners = {}
    for key, b in report["buckets"].items():
        bucket = tuple(int(v) for v in key.split("/")[0][1:].split("xS"))
        assert tuned._cfg_for(bucket).chunk == b["winner"]["chunk"]
        assert {c["chunk"] for c in b["candidates"]} == set(autotune.chunk_candidates(8))
        winners[bucket] = b["winner"]["chunk"]
    assert set(winners) == set(tuned.stats.buckets)
    for bucket, chunk in winners.items():  # each bucket's bits are a fixed-chunk engine's at its winner
        fixed = _engine(m=8, fused=fused, chunk=chunk).explain(reqs)
        rows = [i for i, r in enumerate(out) if r["bucket"] == bucket]
        _same([out[i] for i in rows], [fixed[i] for i in rows])
    for bucket, bs in tuned.stats.buckets.items():
        want = roofline.hotpath_cost(tuned.cfg, bucket, 8, winners[bucket], "float32", probe_forwards=5,
                                     fused=fused)
        assert (bs.bytes_accessed, bs.peak_bytes) == (want["bytes accessed"], want["peak bytes"]) > (0, 0)


def test_tuner_prunes_by_memory_before_any_launch(tmp_path, monkeypatch):
    """A candidate whose predicted peak exceeds the device is never run."""
    reqs = _traffic((12, 13))
    eng = _engine(m=8)
    peaks = {c: roofline.hotpath_cost(eng.cfg, (2, 16), 8, c, "float32", probe_forwards=5)["peak bytes"]
             for c in autotune.chunk_candidates(8)}
    limit = (peaks[2] + peaks[4]) / 2  # chunks 1 and 2 fit, 4 and 8 do not
    monkeypatch.setattr(autotune, "hardware_for", lambda kind: Hardware("tiny", 1e12, 1e11, 1e9, limit))
    ran = []
    real = eng._attr_fn_at
    monkeypatch.setattr(eng, "_attr_fn_at", lambda cfg, **kw: ran.append(cfg.chunk) or real(cfg, **kw))
    report = autotune_engine(eng, reqs, rounds=1, results_dir=str(tmp_path), save=False)
    (b,) = report["buckets"].values()
    pruned = {c["chunk"]: c["pruned"] for c in b["candidates"]}
    assert pruned == {1: None, 2: None, 4: "memory", 8: "memory"}
    assert sorted(set(ran)) == [1, 2] and b["winner"]["chunk"] in (1, 2)
    assert "path" not in report


def test_hotpath_cost_shape():
    """FLOPs do not depend on the chunk; the weights' passes fall and the
    peak grows with it; the probe adds forwards only."""
    cfg = _cfgs()[1]
    costs = [roofline.hotpath_cost(cfg, (4, 16), 16, c, "float32") for c in (1, 2, 4, 8, 16)]
    assert len({c["flops"] for c in costs}) == 1
    assert all(a["bytes accessed"] > b["bytes accessed"] for a, b in zip(costs, costs[1:]))
    assert all(a["peak bytes"] < b["peak bytes"] for a, b in zip(costs, costs[1:]))
    probed = roofline.hotpath_cost(cfg, (4, 16), 16, 4, "float32", probe_forwards=3)
    assert probed["flops"] > costs[2]["flops"] and probed["peak bytes"] == costs[2]["peak bytes"]
    with pytest.raises(ValueError):
        roofline.hotpath_cost(cfg, (4, 16), 16, 3, "float32")


@pytest.mark.parametrize("S,m,chunk,fused", [(16, 8, 4, False), (32, 8, 8, True), (64, 4, 2, False)])
def test_hotpath_cost_flops_match_the_flop_counter(S, m, chunk, fused, monkeypatch):
    """The analytic FLOPs against ``torch.utils.flop_counter`` over one
    fixed-m bucket call of the engine (2 rows, the plain attention, which
    computes all S² pairs: the count takes them here). The rest is the
    norms' weights, which the count takes as projections: within 1%."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.serve.batching import plan_buckets

    eng = _engine(m=m, chunk=chunk, fused=fused, seq_buckets=(S,))
    bb = plan_buckets([_req(S), _req(S, seed=1)], seq_buckets=(S,))[0]
    with FlopCounterMode(display=False) as fc:
        eng._attr_fn_at(eng._cfg_for(bb.bucket))(*eng._bucket_inputs(bb))
    monkeypatch.setattr(roofline, "_causal_pairs", lambda S, window: S * S)
    want = roofline.hotpath_cost(eng.cfg, bb.bucket, m, chunk, "float32",
                                 probe_forwards=eng._forwards_a_row(with_fx=False))["flops"]
    assert abs(fc.get_total_flops() / want - 1) < 0.01


def test_explain_service_takes_autotune(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the service reads results/ under the working directory
    svc = ExplainService(_cfgs()[1], _port_params(), m=4, n_int=2, autotune=True, device="cpu")
    assert svc.engine._autotune_cache is not None and svc.engine._autotune_cache.entries == {}


# -- warm state --------------------------------------------------------------


@pytest.fixture(scope="module")
def warmed(tmp_path_factory):
    """An adaptive hop-zero engine served twice (the history elevates some
    starts in round 2, and round 2 moves them no further: the state saved
    is the one round 2 ran under), then saved."""
    eng = _engine(**ADAPTIVE)
    reqs = _traffic()
    eng.explain(reqs)
    starts = [eng._hop_zero_m(b) for b in ((4, 8), (2, 16))]
    out = eng.explain(reqs, return_raw=True)
    assert [eng._hop_zero_m(b) for b in ((4, 8), (2, 16))] == starts
    td = str(tmp_path_factory.mktemp("warm") / "state")
    save_warm_state(eng, td)
    return eng, reqs, out, td


def test_warm_restore_replays_with_zero_misses_and_same_bits(warmed):
    eng, reqs, out, td = warmed
    elevated = {b for b in ((1, 8), (2, 8), (4, 8), (1, 16), (2, 16)) if eng._hop_zero_m(b) > eng.m}
    assert elevated, "the traffic must elevate a start for this test to mean anything"
    eng2 = _engine(**ADAPTIVE)
    rep = load_warm_state(eng2, td)
    assert rep.restored and rep.via == "replay" and rep.executables == len(eng._cache)
    assert set(eng2._cache) == set(eng._cache) and eng2._delta_hist == eng._delta_hist
    assert all(eng2._hop_zero_m(b) == eng._hop_zero_m(b) for b in elevated)
    _same(eng2.explain(reqs, return_raw=True), out)
    assert eng2.stats.misses == 0 and eng2.stats.hits > 0


def test_replay_leaves_stats_history_and_result_cache(warmed):
    eng, _, _, td = warmed
    eng2 = _engine(**ADAPTIVE, result_cache=1 << 20)
    assert load_warm_state(eng2, td).restored
    st = eng2.stats
    assert (st.hits, st.misses, st.buckets, st.hop_buckets, st.adaptive.requests) == (0, 0, {}, {}, 0)
    assert eng2._delta_hist == eng._delta_hist  # restored, nothing added
    assert len(eng2.result_cache) == 0 and (eng2.result_cache.hits, eng2.result_cache.misses) == (0, 0)


def test_precompile_hop_zero_starts_adds_the_elevated_rungs():
    eng = _engine(**ADAPTIVE)
    eng.explain(_traffic())  # base-rung starts only: the history grows as it serves
    before = set(eng._cache)
    n = eng.precompile_hop_zero_starts()
    added = set(eng._cache) - before
    assert n == len(added) > 0
    for key in added:
        assert key[0] == "start" and key[4] == eng._hop_zero_m(key[1]) > eng.m
        base = next(k for k in before if k[0] == "start" and k[1] == key[1])
        assert eng._arg_specs[key] == eng._arg_specs[base]
    assert eng.precompile_hop_zero_starts() == 0


def test_warm_save_restore_save_keeps_the_key_set(warmed, tmp_path):
    eng, reqs, out, td = warmed
    eng2 = _engine(**ADAPTIVE)
    assert load_warm_state(eng2, td).restored
    again = str(tmp_path / "again")
    save_warm_state(eng2, again)
    with open(os.path.join(again, "manifest.json")) as fh:
        assert json.load(fh)["n_executables"] == len(eng._cache)
    eng3 = _engine(**ADAPTIVE)
    assert load_warm_state(eng3, again).executables == len(eng._cache)
    _same(eng3.explain(reqs, return_raw=True), out)
    assert eng3.stats.misses == 0


def _corrupt(td, tmp_path, how):
    import shutil

    broken = str(tmp_path / "broken")
    shutil.copytree(td, broken)
    if how == "shard":
        with open(os.path.join(broken, "state.json"), "r+b") as fh:
            fh.write(b"\x00" * 16)
    elif how == "manifest":
        with open(os.path.join(broken, "manifest.json"), "w") as fh:
            fh.write('{"format": 1, "fi')
    elif how == "format":
        with open(os.path.join(broken, "manifest.json")) as fh:
            manifest = json.load(fh)
        with open(os.path.join(broken, "manifest.json"), "w") as fh:
            json.dump(dict(manifest, format=99), fh)
    return broken


@pytest.mark.parametrize("how,reason", [("shard", "corrupted"), ("manifest", "unreadable manifest"),
                                        ("format", "unknown format"), ("context", "context")])
def test_warm_restore_falls_back_cold(how, reason, warmed, tmp_path):
    _, reqs, _, td = warmed
    eng2 = _engine(**{**ADAPTIVE, "m": 8}) if how == "context" else _engine(**ADAPTIVE)
    src = td if how == "context" else _corrupt(td, tmp_path, how)
    with pytest.warns(UserWarning, match="starting cold"):
        rep = load_warm_state(eng2, src)
    assert not rep.restored and reason in rep.reason
    assert eng2._cache == {} and eng2._delta_hist == {}
    out = eng2.explain(reqs[:1])  # a cold engine still serves
    assert eng2.stats.misses > 0 and np.isfinite(out[0]["delta"])


def test_warm_restore_missing_dir_is_quiet(tmp_path):
    eng = _engine()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        rep = load_warm_state(eng, str(tmp_path / "nope"))
    assert not rep.restored and rep.reason == "no warm state"


def test_warm_restore_drops_entries_tuned_for_another_device(tmp_path):
    """Autotune entries of another device kind are dropped with a warning;
    the rest of the state restores."""
    reqs = _traffic((5, 6))
    entries = {autotune.bucket_key((2, 8), "riemann", "paper", 4, 2, False): {"chunk": 2}}
    with open(autotune.cache_path(str(tmp_path), "cpu"), "w") as fh:
        json.dump({"device": "cpu", "entries": entries}, fh)
    kw = dict(autotune=True, autotune_dir=str(tmp_path))
    eng = _engine(**kw)
    eng.explain(reqs)
    td = str(tmp_path / "warm")
    save_warm_state(eng, td)
    with open(os.path.join(td, "state.json")) as fh:
        state = json.load(fh)
    with open(os.path.join(td, "state.json"), "w") as fh:
        json.dump(dict(state, autotune_device="tpu_v9000"), fh)
    with open(os.path.join(td, "manifest.json")) as fh:
        manifest = json.load(fh)
    manifest["files"]["state.json"] = sha256_file(os.path.join(td, "state.json"))
    with open(os.path.join(td, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)
    os.remove(autotune.cache_path(str(tmp_path), "cpu"))
    eng2 = _engine(**kw)
    with pytest.warns(UserWarning, match="tuned for 'tpu_v9000'"):
        rep = load_warm_state(eng2, td)
    assert rep.restored and eng2._autotune_cache.entries == {}
    assert set(eng2._cache) == set(eng._cache)
