"""The port's ``ExplainEngine`` against ``repro``'s, gradient class, on the CPU.

Both engines serve ``reduced(ARCHS["llama3-8b"])`` at
``compute_dtype="float32"`` with ``repro``'s seeded weights (through
``lm.params_from_numpy``) on mixed-length traffic (9, 17 and 24 tokens,
ids and targets from numpy) at m=8, n_int=4 and ``seq_buckets=(8, 16,
32)``, so two buckets per call, one of them batch-padded. ``repro`` runs
its plain stage 2 (``use_kernels=False``); the port's kernel ops take their
plain versions on CPU tensors. The path ensembles get ``repro``'s own
per-row normal draws (``jax.random.normal`` at the row's
``fold_in(fold_in(PRNGKey(sample_seed), S), index)``) through the
engine's ``draw=`` hook.

Tolerances: token scores to 1e-4 of the request's largest |score|; f(x),
f(x′) to 1e-6 absolute; δ to 1e-6 plus 1e-4 of |f(x) − f(x′)| (the sums of
the attributions in another order). Adaptive traces (m_used, hops) must be
equal, and ``converged`` too except where δ lies within 1e-7 of its
threshold on either side. Padded positions score exactly 0, and replayed
traffic adds no miss and returns the same bits. The bf16 test holds the
port against ``repro`` (and fused against unfused) at ``repro``'s own
bf16 tolerance (``tests/test_hotpath.py``), rtol = 2e-2, with the atol of
2e-2 taken relative to the request's largest |score| as above; f(x), f(x′)
and δ at rtol = atol = 2e-2.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS, reduced as j_reduced
from repro.models.registry import Model as JModel
from repro.serve import ExplainEngine as JEngine, ExplainRequest as JRequest
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import lm
from repro_torch.serve import ExplainEngine, ExplainRequest, ExplainService

torch.set_num_threads(1)

LENS = (9, 17, 24)
KW = dict(m=8, n_int=4, seq_buckets=(8, 16, 32))
GRAD = ("ig", "idgi", "noise_tunnel", "expected_grad")
ADAPTIVE = dict(adaptive=True, m_max=32, tol=1e-3)


def _cfgs(dtype="float32"):
    return (dataclasses.replace(j_reduced(J_ARCHS["llama3-8b"]), compute_dtype=dtype),
            dataclasses.replace(reduced(ARCHS["llama3-8b"]), compute_dtype=dtype))


@functools.cache
def _jax_params():
    return JModel(_cfgs()[0]).init(jax.random.PRNGKey(0))


@functools.cache
def _port_params():
    return lm.params_from_numpy(_jax_params(), device="cpu")


def _traffic(lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 512, s).astype(np.int32), int(rng.integers(0, 512))) for s in lens]


def jax_normals(seed: int):
    """``repro``'s per-row ensemble draw, as the port's ``draw=`` hook."""

    def draw(S, rows, shape):
        base = jax.random.fold_in(jax.random.PRNGKey(seed), S)
        return np.stack([np.asarray(jax.random.normal(jax.random.fold_in(base, jnp.uint32(i)),
                                                      (1,) + tuple(shape)))[0] for i in rows])

    return draw


def _engines(dtype="float32", **kw):
    jcfg, tcfg = _cfgs(dtype)
    jeng = JEngine(jcfg, _jax_params(), **KW, **kw)
    teng = ExplainEngine(tcfg, _port_params(), device="cpu",
                         draw=jax_normals(jeng.sample_seed), **KW, **kw)
    return jeng, teng


@functools.cache
def _served(dtype="float32", **kw):
    """Each engine's results on the traffic (return_raw), cached by config."""
    jeng, teng = _engines(dtype, **kw)
    reqs = _traffic()
    want = jeng.explain([JRequest(t, g) for t, g in reqs], return_raw=True)
    got = teng.explain([ExplainRequest(t, g) for t, g in reqs], return_raw=True)
    return got, want, teng


def assert_results_close(got, want, rel=1e-4):
    for g, w in zip(got, want):
        assert g["bucket"] == w["bucket"] and g["token_scores"].shape == w["token_scores"].shape
        assert np.isfinite(g["token_scores"]).all()
        np.testing.assert_allclose(g["token_scores"], w["token_scores"], rtol=0,
                                   atol=rel * np.abs(w["token_scores"]).max())
        for k in ("f_x", "f_baseline"):
            assert abs(g[k] - w[k]) <= 1e-6, (k, g[k], w[k])
        assert abs(g["delta"] - w["delta"]) <= 1e-6 + 1e-4 * abs(w["f_x"] - w["f_baseline"])


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("method", GRAD)
def test_engine_matches_jax(method, fused):
    got, want, teng = _served(method=method, fused=fused)
    assert_results_close(got, want)
    n = teng.n_samples  # ensemble rows per request
    assert sorted(teng.stats.buckets) == [(n, 16), (2 * n, 32)] and teng.stats.misses == 2
    assert sum(b.requests for b in teng.stats.buckets.values()) == len(LENS) * n


def _assert_traces_equal(got, want):
    for g, w in zip(got, want):
        assert (g["m_used"], g["hops"]) == (w["m_used"], w["hops"])
        near = min(abs(g["delta"] - g["threshold"]), abs(w["delta"] - w["threshold"])) <= 1e-7
        assert near or g["converged"] == w["converged"]


@pytest.mark.parametrize("method", ["ig", "idgi", "noise_tunnel"])
def test_adaptive_traces_match_jax(method):
    """tol 1e-3 on m=8 up to 32: on this traffic requests exit at each of
    the three rungs, so the start and both hop sizes run."""
    got, want, teng = _served(method=method, **ADAPTIVE)
    _assert_traces_equal(got, want)
    assert_results_close(got, want)
    if method == "ig":
        assert sorted(r["m_used"] for r in got) == [16, 16, 32]
    assert teng.stats.adaptive.requests == len(LENS) * teng.n_samples
    assert teng.stats.adaptive.hop_calls > 0 and teng.stats.hop_buckets


def test_hop_zero_starts_match_jax():
    """With hop-zero history from a first round, the second round starts
    buckets above the base rung, as ``repro``'s engine does."""
    jeng, teng = _engines(method="ig", hop_zero=True, hop_zero_min=2, **ADAPTIVE)
    for rnd in range(2):
        reqs = _traffic(seed=rnd)
        want = jeng.explain([JRequest(t, g) for t, g in reqs])
        got = teng.explain([ExplainRequest(t, g) for t, g in reqs])
        _assert_traces_equal(got, want)
        assert_results_close(got, want)
    starts = sorted(k[4] for k in teng._cache if k[0] == "start")
    assert starts[-1] > teng.m, starts
    assert teng._delta_hist == jeng._delta_hist


@pytest.mark.parametrize("kw", [dict(method="ig"), dict(method="ig", fused=True),
                                dict(method="idgi"), dict(method="noise_tunnel"),
                                dict(method="ig", **ADAPTIVE)])
def test_padded_positions_score_exactly_zero(kw):
    got, _, _ = _served(**kw)
    for r, s in zip(got, LENS):
        raw = r["raw_token_scores"]
        assert raw.shape == (r["bucket"][1],) and np.all(raw[s:] == 0.0)
        assert np.array_equal(raw[:s], r["token_scores"])


@pytest.mark.parametrize("kw", [dict(method="ig"), dict(method="ig", **ADAPTIVE),
                                dict(method="expected_grad", fused=True)])
def test_replay_adds_no_miss_and_is_bit_identical(kw):
    teng = ExplainEngine(_cfgs()[1], _port_params(), device="cpu", **KW, **kw)
    reqs = [ExplainRequest(t, g) for t, g in _traffic()]
    first = teng.explain(reqs)
    misses, hits = teng.stats.misses, teng.stats.hits
    again = teng.explain(reqs)
    assert teng.stats.misses == misses and teng.stats.hits > hits
    assert teng.stats.compiles == misses
    for a, b in zip(first, again):
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[k], b[k]) for k in a)


def test_mixed_length_matches_unbatched():
    """A request's scores do not depend on the bucket it rides in."""
    teng = ExplainEngine(_cfgs()[1], _port_params(), device="cpu", **KW)
    reqs = [ExplainRequest(t, g) for t, g in _traffic()]
    mixed = teng.explain(reqs)
    for r, m in zip(reqs, mixed):
        single = teng.explain([r])[0]
        np.testing.assert_allclose(m["token_scores"], single["token_scores"], rtol=0,
                                   atol=1e-5 * np.abs(single["token_scores"]).max())
        assert abs(m["delta"] - single["delta"]) <= 1e-6


def test_probe_reuse_f_x_matches_jax():
    """A donated f(x) rides its own bucket unit and gives the same result."""
    jeng, teng = _engines(method="ig")
    reqs = _traffic()
    fx = [r["f_x"] for r in _served(method="ig")[1]]
    want = jeng.explain([JRequest(t, g, f_x=f) for (t, g), f in zip(reqs, fx)])
    got = teng.explain([ExplainRequest(t, g, f_x=f) for (t, g), f in zip(reqs, fx)])
    assert_results_close(got, want)
    assert all(k[-1] for k in teng._cache)


def test_explain_service_returns_the_engines_results():
    svc = ExplainService(_cfgs()[1], _port_params(), m=8, n_int=4, device="cpu")
    reqs = [ExplainRequest(t, g) for t, g in _traffic()]
    eng = ExplainEngine(_cfgs()[1], _port_params(), m=8, n_int=4, device="cpu")
    for a, b in zip(svc.explain(reqs), eng.explain(reqs)):
        assert a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)
    assert svc.engine.stats.misses == eng.stats.misses


def test_forward_only_adaptive_is_refused():
    with pytest.raises(ValueError, match="forward-only"):
        ExplainEngine(_cfgs()[1], _port_params(), method="lime", adaptive=True, device="cpu")


def test_use_kernels_false_is_refused_on_the_card():
    """The port has no plain stage 2 on the card: ``use_kernels=False`` is
    refused there (before any tensor moves), and accepted on the CPU."""
    with pytest.raises(ValueError, match="use_kernels=False"):
        ExplainEngine(_cfgs()[1], _port_params(), use_kernels=False, device="cuda")
    assert not ExplainEngine(_cfgs()[1], _port_params(), use_kernels=False, device="cpu").use_kernels


def test_bf16_engine_matches_jax():
    """The LM's own compute dtype: embeddings, interpolants, activations
    and gradients in bf16, stage-2 sums in f32."""
    got, want, _ = _served("bfloat16", method="ig")
    got_f, _, _ = _served("bfloat16", method="ig", fused=True)
    for g, w, gf in zip(got, want, got_f):
        assert np.isfinite(g["token_scores"]).all()
        for a, b in ((g, w), (gf, g)):  # the port vs repro, fused vs unfused
            np.testing.assert_allclose(a["token_scores"], b["token_scores"], rtol=2e-2,
                                       atol=2e-2 * np.abs(b["token_scores"]).max())
        for k in ("f_x", "f_baseline", "delta"):
            np.testing.assert_allclose(g[k], w[k], rtol=2e-2, atol=2e-2)
