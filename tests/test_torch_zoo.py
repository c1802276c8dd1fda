"""Every method × schedule of the port's ``Explainer`` against ``repro``'s, on the paper CNN.

The pipeline is ``tools/make_golden.py``'s, computed live: the paper CNN
from ``cnn.init`` at seed 0, a batch of 2 uniform images from seed 1,
targets (1, 2), a zero baseline, m=16, n_int=4. The port runs on the CPU,
where its kernel ops take their plain versions. The path ensembles
(noise_tunnel, expected_grad: 4 samples, σ 0.1, seed 0) get JAX's own
draw, ``jax.random.normal(PRNGKey(sample_seed), (B·n, *F))``, through numpy.

Tolerances: attributions to 1e-4 of the largest |attribution| (f32
convolutions and sums in another order), 1e-3 for the ensembles; f(x),
f(x′) and δ to 1e-6 absolute (probabilities near 0.1, δ near 1e-7).
Adaptive traces (m_used, hops) and the integer ``info`` entries must be
equal, and ``converged`` too except where a final δ lies within 1e-7 of
its threshold on either side: δ on this batch is f32 rounding noise of
f(x) − f(x′) (1e-9 to 1e-7, exactly 0 now and then), so there the flag
is a coin toss between two summation orders. The ensembles' looser bound: their noisy rows put some of
the CNN's ReLUs within float noise of the kink at some nodes, where the
two frameworks' f32 convolutions, summed in other orders, can switch one
unit's gradient on in one and off in the other. One such unit moved one
sample row by 1e-3 of its largest attribution (noise_tunnel on ``warp``,
the same with JAX's schedule handed in), which is 3.8e-4 of the largest
attribution of the example's mean.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import CONFIG as J_CONFIG
from repro.core.api import Explainer as JExplainer
from repro.models import cnn as jcnn
from repro_torch.configs.paper_cnn import CONFIG
from repro_torch.core.api import Explainer
from repro_torch.models import cnn as tcnn

torch.set_num_threads(1)

SEED, BATCH, M, N_INT, TARGETS = 0, 2, 16, 4, (1, 2)
METHODS = ["ig", "idgi", "noise_tunnel", "expected_grad"]
SCHEDULES = ["uniform", "paper", "warp", "gauss", "refine"]


@functools.cache
def _pipeline():
    params = jcnn.init(J_CONFIG, jax.random.PRNGKey(SEED))
    s = J_CONFIG.image_size
    x = np.array(jax.random.uniform(jax.random.PRNGKey(SEED + 1), (BATCH, s, s, J_CONFIG.channels)))
    t = np.array(TARGETS, np.int32)
    fj = lambda xs, tt: jcnn.prob_fn(J_CONFIG, params, xs, tt)
    tparams = tcnn.params_from_numpy(params, device="cpu")
    ft = lambda xs, tt: tcnn.prob_fn(CONFIG, tparams, xs, tt)
    return fj, ft, x, np.zeros_like(x), t


def jax_draw(ex, x):
    """The standard normals ``repro``'s ``Explainer`` expands an ensemble
    with (None for the other methods)."""
    n = ex.ensemble_size
    if n == 1:
        return None
    return np.array(jax.random.normal(jax.random.PRNGKey(ex.sample_seed), (x.shape[0] * n,) + x.shape[1:]))


def _explainers(method, schedule, fused):
    fj, ft = _pipeline()[:2]
    kw = dict(method=method, schedule=schedule, m=M, n_int=N_INT, fused=fused)
    return JExplainer(fj, **kw), Explainer(ft, device="cpu", **kw)


def assert_result_close(port, ref, ensemble=False):
    attr, f_x, f_b, delta = (a.numpy() for a in port)
    ref = [np.asarray(a) for a in ref]
    assert attr.shape == ref[0].shape and np.isfinite(attr).all()
    rel = 1e-3 if ensemble else 1e-4
    np.testing.assert_allclose(attr, ref[0], rtol=0, atol=rel * np.abs(ref[0]).max())
    for got, want in ((f_x, ref[1]), (f_b, ref[2]), (delta, ref[3])):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("method", METHODS)
def test_every_method_and_schedule_matches_jax(method, schedule, fused):
    _, _, x, b, t = _pipeline()
    jex, tex = _explainers(method, schedule, fused)
    rj = jex.attribute(jnp.asarray(x), jnp.asarray(b), jnp.asarray(t))
    rt = tex.attribute(x, b, t, draw=jax_draw(jex, x))
    assert_result_close(rt, rj, tex.ensemble_size > 1)


@pytest.mark.parametrize("method,schedule", [(m, "paper") for m in METHODS]
                         + [("ig", s) for s in SCHEDULES if s != "paper"] + [("idgi", "refine")])
def test_adaptive_traces_match_jax(method, schedule):
    """δ on this batch is float noise, so tol 1e-9 sends every row (every
    sample row, for the ensembles) up the ladder through one hop."""
    _, _, x, b, t = _pipeline()
    jex, tex = _explainers(method, schedule, False)
    rj, ij = jex.attribute_adaptive(jnp.asarray(x), jnp.asarray(b), jnp.asarray(t), tol=1e-9,
                                    m_max=2 * M)
    rt, it = tex.attribute_adaptive(x, b, t, tol=1e-9, m_max=2 * M, draw=jax_draw(jex, x))
    assert it["hops"].tolist() == [1] * BATCH * tex.ensemble_size
    for key in ("m_used", "hops"):
        np.testing.assert_array_equal(it[key], ij[key])
    thr = np.asarray(ij["threshold"])
    noise = (np.abs(it["delta"] - thr) <= 1e-7) | (np.abs(np.asarray(ij["delta"]) - thr) <= 1e-7)
    np.testing.assert_array_equal(it["converged"][~noise], np.asarray(ij["converged"])[~noise])
    for key in ("total_steps", "probe_forwards", "ladder", "chunk", "n_samples"):
        assert it[key] == ij[key], key
    assert set(it) == set(ij) and it["mesh_fallbacks"] == ij["mesh_fallbacks"] == 0
    assert_result_close(rt, rj, tex.ensemble_size > 1)
