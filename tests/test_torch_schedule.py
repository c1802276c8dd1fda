"""Parity of ``repro_torch.core.schedule`` / ``probes`` with ``repro``'s on the CPU.

Both packages get the same probe values, made with numpy from a seed.
Integer step allocations must be exactly equal (ties included: both rank
remainders with a stable sort); alphas and weights agree to 1e-7 (f32
values in [0, 1], at most a rounding apart), except the children that
``refine_nested`` places, which agree to 1e-6 (see ``_refine_close``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import probes as jprobes
from repro.core import schedule as jsched
from repro_torch.core import probes as tprobes
from repro_torch.core import schedule as tsched

torch.set_num_threads(1)

ATOL = 1e-7


def _vals(seed, B=5, n_int=4):
    rng = np.random.default_rng(seed)
    # monotone-ish probability curves, like a classifier along the path
    return np.cumsum(rng.uniform(0, 0.3, (B, n_int + 1)), axis=1).astype(np.float32)


def _close(j, t):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=ATOL)


@pytest.mark.parametrize("rule", ["midpoint", "left", "right", "trapezoid"])
@pytest.mark.parametrize("m", [1, 4, 7, 64])
def test_uniform_matches_jax(rule, m):
    sj, st = jsched.uniform(m, rule), tsched.uniform(m, rule, device="cpu")
    _close(sj.alphas, st.alphas)
    _close(sj.weights, st.weights)
    assert st.alphas.dtype == torch.float32 and st.weights.dtype == torch.float32


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("power", [0.5, 1.0])
def test_normalized_deltas_and_allocation_match_jax(seed, power):
    v = _vals(seed)
    imp_j = jsched.normalized_deltas(jnp.asarray(v), power)
    imp_t = tsched.normalized_deltas(torch.from_numpy(v), power)
    _close(imp_j, imp_t)
    for m, min_steps in ((16, 1), (64, 1), (37, 2)):
        a_j = np.asarray(jsched.allocate_steps(imp_j, m, min_steps))
        a_t = tsched.allocate_steps(imp_t, m, min_steps).numpy()
        np.testing.assert_array_equal(a_t, a_j)
        assert (a_t.sum(-1) == m).all()


def test_tied_remainders_allocate_like_jax():
    # a flat row (the all-deltas-vanish fallback) ties every remainder, and
    # the other rows tie pairs; a stable ranking hands the +1s to the lowest
    # interval indices on both sides
    v = np.array(
        [[0.5, 0.5, 0.5, 0.5, 0.5],
         [0.0, 0.25, 0.5, 0.5, 0.75],
         [0.0, 0.1, 0.1, 0.2, 0.2]], np.float32)
    imp_j = jsched.normalized_deltas(jnp.asarray(v))
    imp_t = tsched.normalized_deltas(torch.from_numpy(v))
    for m in (6, 7, 9, 10):
        a_j = np.asarray(jsched.allocate_steps(imp_j, m))
        a_t = tsched.allocate_steps(imp_t, m).numpy()
        np.testing.assert_array_equal(a_t, a_j)
    np.testing.assert_array_equal(tsched.allocate_steps(imp_t, 7)[0].numpy(), [2, 2, 2, 1])


@pytest.mark.parametrize("rule", ["midpoint", "left", "right"])
@pytest.mark.parametrize("m", [16, 64])
def test_paper_schedule_matches_jax(rule, m):
    v = _vals(7)
    sj = jsched.paper(jnp.asarray(v), m, rule=rule)
    st = tsched.paper(torch.from_numpy(v), m, rule=rule)
    _close(sj.alphas, st.alphas)
    _close(sj.weights, st.weights)
    np.testing.assert_allclose(st.weights.sum(-1).numpy(), 1.0, atol=1e-6)


def _schedule_pair(which):
    if which == "uniform":
        return jsched.uniform(8), tsched.uniform(8, device="cpu")
    v = _vals(9)
    return jsched.paper(jnp.asarray(v), 16), tsched.paper(torch.from_numpy(v), 16)


def _refine_close(sj):
    """One refinement of the same schedule on both sides. Old nodes and all
    weights must be equal; children agree to 1e-6, since their cell edges
    are running sums of the weights, which ``repro`` takes in f32 in an order
    its JAX version picks and the port takes in f64."""
    rj = jsched.refine_nested(sj)
    rt = tsched.refine_nested(tsched.Schedule(*(torch.from_numpy(np.array(t)) for t in sj)))
    np.testing.assert_allclose(rt.alphas.numpy(), np.asarray(rj.alphas), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(rt.weights.numpy(), np.asarray(rj.weights))
    return rj


@pytest.mark.parametrize("which", ["uniform", "paper"])
def test_refine_nested_matches_jax_and_keeps_old_nodes(which):
    sj, st = _schedule_pair(which)
    for _ in range(2):  # step by step, each from the reference's last rung
        sj = _refine_close(sj)
    for _ in range(3):  # the port's own ladder keeps every old node exactly
        rt = tsched.refine_nested(st)
        m = st.alphas.shape[-1]
        assert torch.equal(rt.alphas[..., :m], st.alphas)
        assert torch.equal(rt.weights[..., :m], 0.5 * st.weights)
        assert torch.equal(rt.weights[..., m:], 0.5 * st.weights)
        np.testing.assert_allclose(rt.weights.sum(-1).numpy(), 1.0, atol=1e-6)
        st = rt


@pytest.mark.parametrize("m", [4, 7, 16, 17, 64, 100, 512])
def test_refine_nested_one_step_matches_jax(m):
    _refine_close(jsched.paper(jnp.asarray(_vals(m)), m))


@pytest.mark.parametrize("m,m_max", [(16, 64), (8, 100), (4, 4)])
def test_m_ladder_matches_jax(m, m_max):
    assert tsched.m_ladder(m, m_max) == jsched.m_ladder(m, m_max)


def test_registry_builds_match_jax():
    v = _vals(11)
    kw = dict(power=0.5, min_steps=1, rule="midpoint")
    for name in ("uniform", "paper"):
        fj, ft = jsched.family(name), tsched.family(name)
        assert ft.probe == fj.probe
        pj = jsched.Probe(jnp.zeros_like(v), jnp.asarray(v))
        pt = tsched.Probe(torch.zeros(v.shape), torch.from_numpy(v))
        sj, st = fj.build(pj, 32, **kw), ft.build(pt, 32, device="cpu", **kw)
        _close(sj.alphas, st.alphas)
        _close(sj.weights, st.weights)
    with pytest.raises(ValueError):
        tsched.family("warp")


def _quadratic_fns(seed, feat):
    """The same f(xs, t) = Σ c·xs² + t in both frameworks."""
    c = np.random.default_rng(seed).uniform(0.5, 1.5, feat).astype(np.float32)
    fj = lambda xs, t: jnp.sum(jnp.asarray(c) * xs**2, axis=(1, 2)) + t
    ct = torch.from_numpy(c)
    ft = lambda xs, t: (ct * xs**2).sum((1, 2)) + t
    return fj, ft


@pytest.mark.parametrize("known", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_boundary_probe_matches_jax(known, masked):
    rng = np.random.default_rng(12)
    B, feat = 3, (4, 5)
    x = rng.uniform(0, 1, (B,) + feat).astype(np.float32)
    b = np.zeros_like(x)
    t = rng.uniform(0, 1, B).astype(np.float32)
    mask = rng.uniform(size=(B, 4)) > 0.3 if masked else None
    fj, ft = _quadratic_fns(13, feat)
    fx = rng.uniform(0, 1, B).astype(np.float32) if known else None
    pj = jprobes.run_probe(
        "boundary", fj, jnp.asarray(x), jnp.asarray(b), jnp.asarray(t), n_int=4,
        mask=None if mask is None else jnp.asarray(mask),
        known_fx=None if fx is None else jnp.asarray(fx))
    pt = tprobes.run_probe(
        "boundary", ft, torch.from_numpy(x), torch.from_numpy(b), torch.from_numpy(t), n_int=4,
        mask=None if mask is None else torch.from_numpy(mask),
        known_fx=None if fx is None else torch.from_numpy(fx))
    np.testing.assert_allclose(pt.vals.numpy(), np.asarray(pj.vals), rtol=1e-6)
    _close(pj.bounds, pt.bounds)
    if known:
        np.testing.assert_array_equal(pt.vals[:, -1].numpy(), fx)
    assert tprobes.run_probe("none", ft, None, None, None) is None


@pytest.mark.parametrize("kind,known", [("none", False), ("boundary", False), ("boundary", True)])
def test_probe_cost_matches_jax(kind, known):
    for n_int in (2, 4, 8):
        assert tprobes.probe_cost(kind, n_int=n_int, known_fx=known) == jprobes.probe_cost(
            kind, n_int=n_int, known_fx=known)
