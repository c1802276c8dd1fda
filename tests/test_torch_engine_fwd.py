"""The port's ``ExplainEngine``: the forward-only class and feature requests, on the CPU.

Occlusion, RISE and LIME served on ``reduced(ARCHS["llama3-8b"])`` at
``compute_dtype="float32"`` with ``repro``'s seeded weights, on the
mixed-length traffic of ``test_torch_engine.py`` (9, 17, 24 tokens; m is
moot, 16 masks a row, chunk 8). The RISE and LIME masks are ``repro``'s
own draw (``perturb.draw_masks`` on the rows' ``request_key``), handed to
the port through the engine's ``draw_masks=`` hook. ``repro`` solves LIME
with its Pallas kernel in interpret mode (``use_kernels=True``); the port
with the plain Gauss–Jordan sweep of its kernel op.

Feature requests: the reduced ViT (``reduced_vit``, ``repro``'s seeded
weights) served on patch features of 40, 64 and 27 patches in buckets of
32 and 64, ``ig`` fixed-m and ``occlusion``.

Tolerances: scores to 1e-4 of the request's largest |score| (LIME's solve
amplifies the f-values' f32 sums in another order; occlusion and RISE are
well inside); f(x), f(x′) to 1e-6 absolute (log-probabilities); padded
positions exactly 0; replay bit-identical with no new miss.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS, reduced as j_reduced
from repro.configs.vit import reduced_vit as j_reduced_vit
from repro.core import perturb as jperturb
from repro.models import vit as jvit
from repro.models.registry import Model as JModel
from repro.serve import ExplainEngine as JEngine, ExplainRequest as JRequest
from repro_torch.configs import ARCHS, reduced
from repro_torch.configs.vit import reduced_vit
from repro_torch.core import perturb
from repro_torch.models import lm, vit as tvit
from repro_torch.serve import ExplainEngine, ExplainRequest

torch.set_num_threads(1)

LENS = (9, 17, 24)
FWD = ("occlusion", "rise", "lime")
KW = dict(m=8, n_int=4, seq_buckets=(8, 16, 32), n_masks=16, chunk=8)


def _cfgs():
    return (dataclasses.replace(j_reduced(J_ARCHS["llama3-8b"]), compute_dtype="float32"),
            dataclasses.replace(reduced(ARCHS["llama3-8b"]), compute_dtype="float32"))


@functools.cache
def _jax_params():
    return JModel(_cfgs()[0]).init(jax.random.PRNGKey(0))


@functools.cache
def _port_params():
    return lm.params_from_numpy(_jax_params(), device="cpu")


def _traffic(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 512, s).astype(np.int32), int(rng.integers(0, 512))) for s in LENS]


def jax_masks(seed: int):
    """``repro``'s plan-time mask draw, as the port's ``draw_masks=`` hook."""

    def draw(method, S, rows, n_masks):
        keys = jax.vmap(lambda i: jperturb.request_key(seed, S, i))(jnp.asarray(rows, jnp.uint32))
        pm = jperturb.draw_masks(method, keys, S, n_masks)
        return perturb.PerturbMasks(*(None if a is None else torch.from_numpy(np.array(a))
                                      for a in pm))

    return draw


@functools.cache
def _served(method):
    jcfg, tcfg = _cfgs()
    jeng = JEngine(jcfg, _jax_params(), method=method, use_kernels=True, **KW)
    teng = ExplainEngine(tcfg, _port_params(), method=method, device="cpu",
                         draw_masks=jax_masks(jeng.sample_seed), **KW)
    reqs = _traffic()
    want = jeng.explain([JRequest(t, g) for t, g in reqs], return_raw=True)
    got = teng.explain([ExplainRequest(t, g) for t, g in reqs], return_raw=True)
    return got, want, teng


def _assert_close(got, want):
    for g, w in zip(got, want):
        assert g["bucket"] == w["bucket"] and np.isfinite(g["token_scores"]).all()
        np.testing.assert_allclose(g["token_scores"], w["token_scores"], rtol=0,
                                   atol=1e-4 * np.abs(w["token_scores"]).max())
        for k in ("f_x", "f_baseline"):
            assert abs(g[k] - w[k]) <= 1e-6, (k, g[k], w[k])


@pytest.mark.parametrize("method", FWD)
def test_forward_only_engine_matches_jax(method):
    got, want, teng = _served(method)
    _assert_close(got, want)
    assert teng.stats.misses == 2 and all(k[0] == "fwd" for k in teng._cache)


@pytest.mark.parametrize("method", FWD)
def test_forward_only_padding_scores_exactly_zero(method):
    got, _, _ = _served(method)
    for r, s in zip(got, LENS):
        assert np.all(r["raw_token_scores"][s:] == 0.0)
        assert np.array_equal(r["raw_token_scores"][:s], r["token_scores"])


@pytest.mark.parametrize("method", ["rise", "lime"])
def test_forward_only_replay_and_default_draw(method):
    """The port's own draw (``request_seed`` per row): replay adds no miss
    and gives the same bits; the masks are those of ``perturb.draw_masks``
    at the rows' seeds."""
    teng = ExplainEngine(_cfgs()[1], _port_params(), method=method, device="cpu", **KW)
    reqs = [ExplainRequest(t, g) for t, g in _traffic()]
    first = teng.explain(reqs, return_raw=True)
    misses = teng.stats.misses
    again = teng.explain(reqs, return_raw=True)
    assert teng.stats.misses == misses
    for a, b in zip(first, again):
        assert all(np.array_equal(a[k], b[k]) for k in a)
    rows = [1, 2]  # the S=32 bucket (2, 32): requests 1 and 2
    seeds = [perturb.request_seed(0, 32, i) for i in rows]
    pm = perturb.draw_masks(method, seeds, 32, 16, device="cpu")
    hooked = ExplainEngine(_cfgs()[1], _port_params(), method=method, device="cpu",
                           draw_masks=lambda *_: pm, **KW)
    out = hooked.explain(reqs[1:], return_raw=True)
    assert all(np.array_equal(a["raw_token_scores"], b["raw_token_scores"])
               for a, b in zip(out, first[1:]))


# --------------------------------------------------------- feature requests


@functools.cache
def _vit():
    jp = jvit.init(j_reduced_vit(), jax.random.PRNGKey(0))
    return jp, tvit.params_from_numpy(jp, device="cpu")


@pytest.mark.parametrize("method", ["ig", "occlusion"])
def test_feature_requests_match_jax(method):
    """ViT patch features: the path from the embedded black image to the
    embedded features, buckets padded past the patch grid."""
    jp, tp = _vit()
    rng = np.random.default_rng(6)
    pd = reduced_vit().patch_dim
    feats = [rng.uniform(0, 1, (n, pd)).astype(np.float32) for n in (40, 64, 27)]
    targets = [1, 4, 7]
    kw = dict(method=method, m=8, n_int=4, seq_buckets=(32, 64), n_masks=16)
    jeng = JEngine(j_reduced_vit(), jp, **kw)
    teng = ExplainEngine(reduced_vit(), tp, device="cpu", **kw)
    want = jeng.explain([JRequest(np.arange(len(f), dtype=np.int32), t, features=f)
                         for f, t in zip(feats, targets)], return_raw=True)
    got = teng.explain([ExplainRequest(np.arange(len(f), dtype=np.int32), t, features=f)
                        for f, t in zip(feats, targets)], return_raw=True)
    _assert_close(got, want)
    for r, f in zip(got, feats):
        assert r["token_scores"].shape == (len(f),) and np.all(r["raw_token_scores"][len(f):] == 0)
