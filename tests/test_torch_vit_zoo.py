"""Every method × schedule of the port's ``Explainer`` against ``repro``'s on the flash reduced ViT.

Weights come from ``repro``'s seeded ``vit.init`` on ``reduced_vit()`` (two
layers, d=64, four heads of 16, 8×8 patches of 4×4×3) through
``params_from_numpy``; 2 images from numpy with a fixed seed, targets
(1, 2), a zero baseline, m=16, n_int=4. ``attn_impl="flash"`` runs the
JAX flash op's Pallas kernels in interpret mode and the port's flash op
through its plain versions. The ensembles take 2 samples (σ 0.1, seed 0)
and JAX's own draw, handed to the port through numpy.

Tolerances: attributions to 1e-4 of the largest |attribution| of their
row (f32 matrix products summed in another order); f(x), f(x′) to 1e-6
and δ to 1e-6 plus 1e-4 of |f(x) − f(x′)| (another summation order of the
attributions' sum). Adaptive traces (m_used, hops, converged) must be
equal: on random weights δ is a sizeable share of |f(x) − f(x′)|, far
from float noise.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.vit import reduced_vit as j_reduced_vit
from repro.core.api import Explainer as JExplainer
from repro.models import vit as jvit
from repro_torch.configs.vit import reduced_vit
from repro_torch.core.api import Explainer
from repro_torch.models import vit as tvit

torch.set_num_threads(1)

M, N_INT, TARGETS, N_SAMPLES = 16, 4, (1, 2), 2
METHODS = ["ig", "idgi", "noise_tunnel", "expected_grad"]
SCHEDULES = ["uniform", "paper", "warp", "gauss", "refine"]


@functools.cache
def _setup():
    jcfg = dataclasses.replace(j_reduced_vit(), attn_impl="flash")
    tcfg = dataclasses.replace(reduced_vit(), attn_impl="flash")
    params = jvit.init(j_reduced_vit(), jax.random.PRNGKey(0))
    tparams = tvit.params_from_numpy(params, device="cpu")
    s = tcfg.image_size
    x = np.random.default_rng(6).uniform(0, 1, (2, s, s, 3)).astype(np.float32)
    fj = lambda xs, tt: jvit.prob_fn(jcfg, params, xs, tt)
    ft = lambda xs, tt: tvit.prob_fn(tcfg, tparams, xs, tt)
    return fj, ft, x, np.zeros_like(x), np.array(TARGETS, np.int32)


def _explainers(method, schedule, fused):
    fj, ft = _setup()[:2]
    kw = dict(method=method, schedule=schedule, m=M, n_int=N_INT, fused=fused, n_samples=N_SAMPLES)
    return JExplainer(fj, **kw), Explainer(ft, device="cpu", **kw)


def _draw(ex, x):
    n = ex.ensemble_size
    if n == 1:
        return None
    return np.array(jax.random.normal(jax.random.PRNGKey(ex.sample_seed), (x.shape[0] * n,) + x.shape[1:]))


def _assert_close(rt, rj):
    ja, jfx, jfb, jd = (np.asarray(a) for a in rj)
    ta, tfx, tfb, td = (a.numpy() for a in rt)
    assert ta.shape == ja.shape and np.isfinite(ta).all()
    B = ja.shape[0]
    lim = 1e-4 * np.abs(ja).reshape(B, -1).max(1)
    assert (np.abs(ta - ja).reshape(B, -1).max(1) <= lim).all()
    np.testing.assert_allclose(tfx, jfx, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tfb, jfb, rtol=0, atol=1e-6)
    assert (np.abs(td - jd) <= 1e-6 + 1e-4 * np.abs(jfx - jfb)).all()


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("method", METHODS)
def test_flash_vit_method_and_schedule_match_jax(method, schedule, fused):
    _, _, x, b, t = _setup()
    jex, tex = _explainers(method, schedule, fused)
    rj = jex.attribute(jnp.asarray(x), jnp.asarray(b), jnp.asarray(t))
    _assert_close(tex.attribute(x, b, t, draw=_draw(jex, x)), rj)


@pytest.mark.parametrize("method,schedule", [("idgi", "paper"), ("noise_tunnel", "refine")])
def test_flash_vit_adaptive_traces_match_jax(method, schedule):
    _, _, x, b, t = _setup()
    jex, tex = _explainers(method, schedule, False)
    rj, ij = jex.attribute_adaptive(jnp.asarray(x), jnp.asarray(b), jnp.asarray(t), tol=1e-2,
                                    m_max=2 * M)
    rt, it = tex.attribute_adaptive(x, b, t, tol=1e-2, m_max=2 * M, draw=_draw(jex, x))
    for key in ("m_used", "hops", "converged"):
        np.testing.assert_array_equal(it[key], ij[key])
    for key in ("total_steps", "probe_forwards", "ladder", "chunk", "n_samples"):
        assert it[key] == ij[key], key
    assert (it["hops"] > 0).any()
    _assert_close(rt, rj)
