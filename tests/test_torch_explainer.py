"""The port's ``Explainer`` against ``repro``'s on the golden CNN pipeline.

The pipeline is ``tools/make_golden.py``'s, computed live here (never read
from the ``.npz`` fixtures): the paper CNN from ``cnn.init`` at seed 0, a
batch of 2 uniform images from seed 1, targets (1, 2), a zero baseline,
``ig`` on the ``paper`` schedule with m=16, n_int=4. The port runs on the
CPU, where its kernel ops take their plain versions.

Tolerances: attributions to 1e-4 of the largest one (f32 convolutions and
sums in another order); f(x), f(x′) and δ to 1e-6 absolute (probabilities
near 0.1, δ near 1e-7). Adaptive traces (m_used, hops, converged) must be
equal. IDGI's and ig's attribution sums agree to 1e-6 (both are the
quadrature Σ_k w_k ⟨g_k, x − x′⟩, summed in other orders, about 0.02 here).
The other methods and schedules are in ``test_torch_zoo.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import CONFIG as J_CONFIG
from repro.core.api import Explainer as JExplainer
from repro.kernels.ig_accum.ops import ig_accum as j_ig_accum
from repro.kernels.ig_accum.ops import ig_accum_idgi as j_ig_accum_idgi
from repro.kernels.interp_accum.ops import interp_accum as j_interp_accum
from repro.kernels.interpolate.ops import interpolate as j_interpolate
from repro.models import cnn as jcnn
from repro_torch.configs.paper_cnn import CONFIG
from repro_torch.core import ig, schedule
from repro_torch.core.api import Explainer
from repro_torch.kernels import common
from repro_torch.models import cnn as tcnn

torch.set_num_threads(1)

SEED, BATCH, M, N_INT, TARGETS = 0, 2, 16, 4, (1, 2)


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


def _jax_explainer(fused=False, kernels=False, schedule="paper"):
    fj = _pipeline()[0]
    kw = {}
    if kernels:  # the Pallas ops, interpreted on the CPU
        kw = dict(interp_fn=functools.partial(j_interpolate, interpret=True),
                  accum_fn=functools.partial(j_ig_accum, interpret=True),
                  interp_add_fn=functools.partial(j_interp_accum, interpret=True))
    return JExplainer(fj, method="ig", schedule=schedule, m=M, n_int=N_INT, fused=fused, **kw)


def _port_explainer(fused=False, schedule="paper"):
    return Explainer(_pipeline()[1], method="ig", schedule=schedule, m=M, n_int=N_INT,
                     fused=fused, device="cpu")


@functools.cache
def _jax_result(fused, kernels, schedule="paper", masked=False):
    _, _, x, b, t = _pipeline()
    mask = _mask() if masked else None
    r = _jax_explainer(fused, kernels, schedule).attribute(
        jnp.asarray(x), jnp.asarray(b), jnp.asarray(t), None if mask is None else jnp.asarray(mask))
    return tuple(np.asarray(a) for a in r)


def _mask():
    m = np.ones((BATCH, J_CONFIG.image_size), bool)
    m[0, 20:] = False
    m[1, :5] = False
    return m


def _assert_result_close(port, ref):
    attr, f_x, f_b, delta = (a.numpy() for a in port)
    np.testing.assert_allclose(attr, ref[0], rtol=0, atol=1e-4 * np.abs(ref[0]).max())
    for got, want in ((f_x, ref[1]), (f_b, ref[2]), (delta, ref[3])):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kernels", [False, True])
def test_fixed_m_matches_jax(fused, kernels):
    """Against the plain JAX path and against the interpreted Pallas ops."""
    _, _, x, b, t = _pipeline()
    res = _port_explainer(fused).attribute(x, b, t)
    assert res.attributions.shape == x.shape and torch.isfinite(res.attributions).all()
    _assert_result_close(res, _jax_result(fused, kernels))


@pytest.mark.parametrize("fused", [False, True])
def test_masked_attribution_matches_jax(fused):
    _, _, x, b, t = _pipeline()
    res = _port_explainer(fused).attribute(x, b, t, mask=_mask())
    _assert_result_close(res, _jax_result(fused, False, masked=True))
    assert not res.attributions[0, 20:].any() and not res.attributions[1, :5].any()


def test_uniform_schedule_matches_jax():
    _, _, x, b, t = _pipeline()
    res = _port_explainer(schedule="uniform").attribute(x, b, t)
    _assert_result_close(res, _jax_result(False, False, "uniform"))


def test_paper_schedule_matches_jax():
    _, _, x, b, t = _pipeline()
    sj = _jax_explainer().build_schedule(jnp.asarray(x), jnp.asarray(b), jnp.asarray(t))
    st = _port_explainer().build_schedule(x, b, t)
    np.testing.assert_allclose(st.alphas.numpy(), np.asarray(sj.alphas), rtol=0, atol=1e-7)
    np.testing.assert_allclose(st.weights.numpy(), np.asarray(sj.weights), rtol=0, atol=1e-7)


@pytest.mark.parametrize("tol", [1e-2, 1e-9])
def test_adaptive_traces_match_jax(tol):
    """δ on this batch is float noise (about 1e-7 of a probability path
    that is nearly linear), so the tolerances sit far from it on either
    side: 1e-2 stops every row at the base rung, 1e-9 sends every row up
    the whole ladder through both hops."""
    _, _, x, b, t = _pipeline()
    rj, ij = _jax_explainer().attribute_adaptive(
        jnp.asarray(x), jnp.asarray(b), jnp.asarray(t), tol=tol, m_max=4 * M)
    rt, it = _port_explainer().attribute_adaptive(x, b, t, tol=tol, m_max=4 * M)
    assert it["hops"].tolist() == ([0, 0] if tol > 1e-3 else [2, 2])
    for key in ("m_used", "hops", "converged"):
        np.testing.assert_array_equal(it[key], ij[key])
    for key in ("total_steps", "probe_forwards", "ladder", "chunk", "n_samples"):
        assert it[key] == ij[key], key
    assert set(it) == set(ij) and it["mesh_fallbacks"] == ij["mesh_fallbacks"] == 0
    _assert_result_close(rt, tuple(np.asarray(a) for a in rj))


@pytest.mark.parametrize("fused", [False, True])
def test_resume_is_bit_identical_to_a_fixed_run(fused):
    _, ft, x, b, t = _pipeline()
    ex = _port_explainer(fused)
    xt, bt, tt = torch.from_numpy(x), torch.from_numpy(b), torch.from_numpy(t)
    _, state, sched = ex.start(xt, bt, tt)
    for _ in range(2):  # two hops up the ladder
        refined = schedule.refine_nested(sched)
        n_old = sched.alphas.shape[-1]
        new = schedule.Schedule(refined.alphas[:, n_old:], refined.weights[:, n_old:])
        res, state = ex.resume(xt, bt, tt, new, state)
        fixed = ig.attribute(ft, xt, bt, refined, tt, chunk=ex.adaptive_chunk, **ex.ig_kwargs())
        assert torch.equal(res.attributions, fixed.attributions)
        assert torch.equal(res.delta, fixed.delta)
        sched = refined


@functools.cache
def _idgi_jax(fused, masked=False):
    """JAX's IDGI on the pipeline through its Pallas ops, interpreted."""
    _, _, x, b, t = _pipeline()
    kw = dict(interp_fn=functools.partial(j_interpolate, interpret=True),
              accum_fn=functools.partial(j_ig_accum_idgi, interpret=True),
              interp_add_fn=functools.partial(j_interp_accum, interpret=True))
    ex = JExplainer(_pipeline()[0], method="idgi", schedule="paper", m=M, n_int=N_INT, fused=fused, **kw)
    mask = jnp.asarray(_mask()) if masked else None
    r = ex.attribute(jnp.asarray(x), jnp.asarray(b), jnp.asarray(t), mask)
    return tuple(np.asarray(a) for a in r)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_idgi_matches_jax_pallas_ops(fused, masked):
    """``fused=True`` with IDGI takes per-step gradients through a per-step
    carry and computes IDGI, not a Riemann sum: it matches JAX's fused IDGI
    and differs from ig's attributions while its total equals ig's."""
    _, _, x, b, t = _pipeline()
    mask = _mask() if masked else None
    ex = Explainer(_pipeline()[1], method="idgi", schedule="paper", m=M, n_int=N_INT, fused=fused,
                   device="cpu")
    common.reset_launches()
    res = ex.attribute(x, b, t, mask=mask)
    _assert_result_close(res, _idgi_jax(fused, masked))
    assert sum(common.LAUNCHES.values()) == 0  # CPU tensors take the plain versions
    r_ig = _port_explainer(fused).attribute(x, b, t, mask=mask)
    gap = np.abs(res.attributions.numpy() - r_ig.attributions.numpy()).max()
    assert gap > 0.1 * np.abs(r_ig.attributions.numpy()).max()
    np.testing.assert_allclose(res.attributions.sum((1, 2, 3)).numpy(),
                               r_ig.attributions.sum((1, 2, 3)).numpy(), rtol=0, atol=1e-6)
    if masked:
        assert not res.attributions[0, 20:].any() and not res.attributions[1, :5].any()


@pytest.mark.parametrize("fused", [False, True])
def test_idgi_resume_is_bit_identical_to_a_fixed_run(fused):
    _, ft, x, b, t = _pipeline()
    ex = Explainer(ft, method="idgi", schedule="paper", m=M, n_int=N_INT, fused=fused, chunk=8,
                   device="cpu")
    xt, bt, tt = torch.from_numpy(x), torch.from_numpy(b), torch.from_numpy(t)
    _, state, sched = ex.start(xt, bt, tt)
    for _ in range(2):
        refined = schedule.refine_nested(sched)
        n_old = sched.alphas.shape[-1]
        new = schedule.Schedule(refined.alphas[:, n_old:], refined.weights[:, n_old:])
        res, state = ex.resume(xt, bt, tt, new, state)
        fixed = ig.attribute(ft, xt, bt, refined, tt, method="idgi", chunk=ex.adaptive_chunk,
                             **ex.ig_kwargs())
        assert torch.equal(res.attributions, fixed.attributions)
        assert torch.equal(res.delta, fixed.delta)
        assert torch.equal(state.acc, res.attributions)  # IDGI's state is the attribution
        sched = refined


@pytest.mark.parametrize("method", ["noise_tunnel", "expected_grad"])
def test_ensemble_is_the_mean_of_its_sample_rows(method):
    """Expansion then per-row ig then the mean, fixed-m and adaptive; the
    default draw is seeded, so two runs agree bit for bit."""
    _, ft, x, b, t = _pipeline()
    ex = Explainer(ft, method=method, schedule="paper", m=M, n_int=N_INT, n_samples=3, sigma=0.05,
                   sample_seed=5, device="cpu")
    assert (ex.ensemble_size, ex.ensemble_sigma) == (3, 0.05)
    res = ex.attribute(x, b, t)
    assert torch.equal(res.attributions, ex.attribute(x, b, t).attributions)
    x2, b2, t2, m2, n = ex.expand_inputs(x, b, t)
    assert n == 3 and m2 is None and tuple(x2.shape) == (6,) + x.shape[1:]
    assert torch.equal(t2, torch.tensor([1, 1, 1, 2, 2, 2], dtype=t2.dtype))
    row = Explainer(ft, method="ig", schedule="paper", m=M, n_int=N_INT, device="cpu")
    rows = row.attribute(x2, b2, t2)
    torch.testing.assert_close(res.attributions, rows.attributions.reshape((2, 3) + x.shape[1:]).mean(1),
                               rtol=0, atol=0)
    red = Explainer.reduce_result(rows, 3)
    torch.testing.assert_close(res.delta, red.delta, rtol=0, atol=0)
    res_a, info = ex.attribute_adaptive(x, b, t, tol=1e-2)
    rows_a, info_r = row.attribute_adaptive(x2, b2, t2, tol=1e-2)
    assert info["n_samples"] == 3 and info_r["n_samples"] == 1 and info["m_used"].shape == (6,)
    assert torch.equal(res_a.attributions, Explainer.reduce_result(rows_a, 3).attributions)
    assert res_a.attributions.shape == x.shape
