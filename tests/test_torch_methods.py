"""The port's method registry, baselines, ensembles and metrics against ``repro``'s.

On the CPU, with inputs made by numpy from a seed and random draws taken
from ``jax.random`` and handed to the port through numpy.

Tolerances: IDGI's accumulation 1e-5 of the largest |value| plus 1e-5
relative (dot products over F summed in another order); the ensembles'
expansions exactly equal in f32 (one f32 multiply and one add, the same
roundings in the same order) and to one bf16 ulp (2**-7 relative) in bf16;
the smooth wrappers' means 1e-6; insertion/deletion AUCs 1e-6 (sums of 17
f32 values in another order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core import methods as jmethods
from repro.core import metrics as jmetrics
from repro.core import smooth as jsmooth
from repro.core.ig import IGResult as JIGResult
from repro_torch.core import baselines as tbase
from repro_torch.core import methods as tmethods
from repro_torch.core import metrics as tmetrics
from repro_torch.core import smooth as tsmooth
from repro_torch.core.ig import IGResult

torch.set_num_threads(1)

GRAD_METHODS = ["ig", "idgi", "noise_tunnel", "expected_grad"]


def _np(a):
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _normal(seed, shape):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), shape))


@pytest.mark.parametrize("B,K,feat", [(1, 1, (3,)), (3, 5, (7, 11)), (2, 9, (4, 6, 3))])
@pytest.mark.parametrize("masked", [False, True])
def test_idgi_accum_and_finalize_match_jax(B, K, feat, masked):
    rng = np.random.default_rng(0)
    acc = rng.normal(0, 1, (B,) + feat).astype(np.float32)
    g = rng.normal(0, 1, (B, K) + feat).astype(np.float32)
    g[0, 0] = 0.0  # a flat step: contributes exactly 0
    w = rng.uniform(0, 0.2, (B, K)).astype(np.float32)
    x, b = (rng.uniform(-1, 1, (B,) + feat).astype(np.float32) for _ in range(2))
    mask = rng.uniform(size=(B, feat[0])) > 0.3 if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    want = _np(jmethods.idgi_accum(jnp.asarray(acc), jnp.asarray(g), jnp.asarray(w),
                                   diff=jnp.asarray(x - b), mask=jm))
    got = tmethods.idgi_accum(torch.from_numpy(acc), torch.from_numpy(g), torch.from_numpy(w),
                              diff=torch.from_numpy(x - b), mask=tm)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    fin_j = _np(jmethods.idgi_finalize(jnp.asarray(want), jnp.asarray(x), jnp.asarray(b), jm))
    fin_t = tmethods.idgi_finalize(torch.from_numpy(want), torch.from_numpy(x), torch.from_numpy(b), tm)
    np.testing.assert_array_equal(fin_t.numpy(), fin_j)


def test_registry_matches_jax():
    assert sorted(tmethods.METHODS) == sorted(jmethods.METHODS)
    for name in GRAD_METHODS:
        js, ts = jmethods.get(name), tmethods.get(name)
        for field in ("name", "accum", "n_samples", "sigma_default", "grad_linear", "forward_only",
                      "n_masks", "description"):
            assert getattr(ts, field) == getattr(js, field), (name, field)
        assert (ts.expand is None) == (js.expand is None)
        assert ts.expand is None or ts.expand.__name__ == js.expand.__name__
        row = ts.row_spec()
        assert row.expand is None and row.n_samples == 1 and row.accum == ts.accum
        assert tmethods.get(ts) is ts
    with pytest.raises(ValueError, match="expected_grad"):
        tmethods.get("saliency")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("expand", ["noise_expand", "baseline_expand"])
def test_ensemble_expansion_matches_jax_with_its_draw(expand, dtype):
    B, n, feat, sigma = 3, 4, (5, 7, 3), 0.1
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (B,) + feat).astype(np.float32)
    b = rng.uniform(0, 0.5, (B,) + feat).astype(np.float32)
    key = jax.random.PRNGKey(7)
    xj, bj = getattr(jmethods, expand)(jnp.asarray(x, dtype), jnp.asarray(b, dtype), key, n, sigma)
    draw = torch.from_numpy(_normal(7, (B * n,) + feat))
    tdt = getattr(torch, dtype)
    xt, bt = getattr(tmethods, expand)(torch.from_numpy(x).to(tdt), torch.from_numpy(b).to(tdt),
                                       draw, n, sigma)
    assert xt.dtype == bt.dtype == tdt and tuple(xt.shape) == (B * n,) + feat
    rtol = 0.0 if dtype == "float32" else 2.0**-7
    np.testing.assert_allclose(xt.float().numpy(), _np(xj), rtol=rtol, atol=0)
    np.testing.assert_allclose(bt.float().numpy(), _np(bj), rtol=rtol, atol=0)


def test_ensemble_expansion_draws_from_a_generator():
    x, b = torch.rand(2, 3, 4), torch.zeros(2, 3, 4)
    one = tmethods.noise_expand(x, b, torch.Generator().manual_seed(3), 5, 0.1)
    two = tmethods.noise_expand(x, b, torch.Generator().manual_seed(3), 5, 0.1)
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], b.repeat_interleave(5, 0))
    assert not torch.equal(one[0][::5], x)
    with pytest.raises(ValueError, match="shape"):
        tmethods.noise_expand(x, b, torch.zeros(3, 3, 4), 5, 0.1)


def test_baselines_match_jax():
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (2, 4, 3)).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    np.testing.assert_array_equal(tbase.black(xt).numpy(), np.asarray(jbase.black(xj)))
    np.testing.assert_array_equal(tbase.white(xt, 0.5).numpy(), np.asarray(jbase.white(xj, 0.5)))
    gj = jbase.gaussian(xj, jax.random.PRNGKey(4), 0.3)
    gt = tbase.gaussian(xt, torch.from_numpy(_normal(4, x.shape)), 0.3)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(gj))
    table = rng.normal(0, 1, (6, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tbase.pad_embedding(torch.from_numpy(table), xt, pad_id=2).numpy(),
        np.asarray(jbase.pad_embedding(jnp.asarray(table), xj, pad_id=2)))
    assert sorted(tbase.BASELINES) == sorted(jbase.BASELINES)
    assert all(tbase.get(k).__name__ == jbase.get(k).__name__ for k in jbase.BASELINES)
    with pytest.raises(ValueError, match="black"):
        tbase.get("grey")


def _linear_attr():
    """attribute_fn(x) of a fixed linear model in each framework."""
    wt = np.random.default_rng(5).normal(0, 1, (4, 3)).astype(np.float32)

    def jfn(x):
        a = x * jnp.asarray(wt)
        return JIGResult(a, a.sum((1, 2)), jnp.zeros(x.shape[0]), jnp.abs(a).sum((1, 2)))

    def tfn(x):
        a = x * torch.from_numpy(wt)
        return IGResult(a, a.sum((1, 2)), torch.zeros(x.shape[0]), a.abs().sum((1, 2)))

    return jfn, tfn


def _result_close(rt, rj):
    for got, want in zip(rt, rj):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_smooth_wrappers_match_jax():
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 1, (2, 4, 3)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    np.testing.assert_array_equal(
        tsmooth.noise_samples(torch.from_numpy(x), torch.from_numpy(_normal(8, (6, 4, 3))), 3, 0.2).numpy(),
        np.asarray(jsmooth.noise_samples(jnp.asarray(x), key, 3, 0.2)))
    jfn, tfn = _linear_attr()
    rj = jsmooth.noise_tunnel(jfn, jnp.asarray(x), key, n_samples=3, sigma=0.2)
    draws = np.stack([np.asarray(jax.random.normal(k, x.shape)) for k in jax.random.split(key, 3)])
    rt = tsmooth.noise_tunnel(tfn, torch.from_numpy(x), torch.from_numpy(draws), n_samples=3, sigma=0.2)
    _result_close(rt, rj)
    bases = [rng.uniform(0, 1, x.shape).astype(np.float32) for _ in range(3)]
    _result_close(tsmooth.multi_baseline(tfn, [torch.from_numpy(v) for v in bases]),
                  jsmooth.multi_baseline(jfn, [jnp.asarray(v) for v in bases]))
    again = tsmooth.noise_tunnel(tfn, torch.from_numpy(x), torch.Generator().manual_seed(0), n_samples=3)
    assert all(torch.isfinite(v).all() for v in again)


@functools.cache
def _auc_model():
    c = np.random.default_rng(9).normal(0, 1, (6, 5)).astype(np.float32)
    fj = lambda xs, t: jnp.tanh(jnp.sum(jnp.asarray(c) * xs, axis=(1, 2))) + t
    ct = torch.from_numpy(c)
    ft = lambda xs, t: torch.tanh((ct * xs).sum((1, 2))) + t
    return fj, ft


@pytest.mark.parametrize("steps", [4, 16, 7])
def test_insertion_deletion_auc_matches_jax(steps):
    rng = np.random.default_rng(10)
    x = rng.uniform(0, 1, (3, 6, 5)).astype(np.float32)
    b = np.zeros_like(x)
    attr = np.round(rng.normal(0, 1, x.shape), 1).astype(np.float32)  # with ties
    t = rng.uniform(0, 1, 3).astype(np.float32)
    fj, ft = _auc_model()
    ij, dj = jmetrics.insertion_deletion_auc(fj, *map(jnp.asarray, (x, b, attr, t)), steps=steps)
    it, dt = tmetrics.insertion_deletion_auc(ft, *map(torch.from_numpy, (x, b, attr, t)), steps=steps)
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), rtol=0, atol=1e-6)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=1e-6)
