"""Parity of ``repro_torch.core.schedule`` / ``probes`` with ``repro``'s on the CPU.

Both packages get the same probe values, made with numpy from a seed.
Integer step allocations must be exactly equal (ties included: both rank
remainders with a stable sort); alphas and weights agree to 1e-7 (f32
values in [0, 1], at most a rounding apart), except the children that
``refine_nested`` places and the ``warp``, ``gauss`` and
``from_boundaries`` nodes, which agree to 1e-6: their f32 operations are
the reference's, but XLA may fuse and reorder them. The secant-refine
probe's boundaries and values agree to 1e-6 (f32 model values).
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
    for name in ("warp", "gauss", "refine"):
        fj, ft = jsched.family(name), tsched.family(name)
        assert ft.probe == fj.probe
        bounds = _bounds(11, v.shape[0], v.shape[1])
        pj = jsched.Probe(jnp.asarray(bounds), jnp.asarray(v))
        pt = tsched.Probe(torch.from_numpy(bounds), torch.from_numpy(v))
        sj, st = fj.build(pj, 32, **kw), ft.build(pt, 32, device="cpu", **kw)
        _close6(sj.alphas, st.alphas)
        _close6(sj.weights, st.weights)
    assert sorted(tsched.SCHEDULES) == sorted(jsched.SCHEDULES)
    with pytest.raises(ValueError):
        tsched.family("nope")


def _close6(j, t):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)


def _bounds(seed, B, K, pad=0):
    """Sorted non-uniform boundaries on [0, 1], with ``pad`` duplicates of 1
    at the end (the refine probe's padding)."""
    rng = np.random.default_rng(seed)
    inner = np.sort(rng.uniform(0, 1, (B, K - 2 - pad)), axis=1)
    return np.concatenate([np.zeros((B, 1)), inner, np.ones((B, 1 + pad))], axis=1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("m", [4, 16, 37, 64, 512])
@pytest.mark.parametrize("power", [0.5, 1.0])
def test_warp_matches_jax(seed, m, power):
    v = _vals(seed, B=6)
    v[0] = 0.5  # a flat row: the uniform fallback
    sj = jsched.warp(jnp.asarray(v), m, power=power)
    st = tsched.warp(torch.from_numpy(v), m, power=power)
    _close6(sj.alphas, st.alphas)
    _close6(sj.weights, st.weights)
    np.testing.assert_allclose(st.weights.sum(-1).numpy(), 1.0, atol=1e-6)
    assert bool((torch.diff(st.alphas, dim=-1) >= 0).all())


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("m,order", [(16, 8), (64, 8), (37, 8), (12, 5), (4, 8)])
def test_gauss_matches_jax(seed, m, order):
    v = _vals(seed, B=5)
    sj = jsched.gauss(jnp.asarray(v), m, order=order)
    st = tsched.gauss(torch.from_numpy(v), m, order=order)
    _close6(sj.alphas, st.alphas)
    _close6(sj.weights, st.weights)
    np.testing.assert_allclose(st.weights.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("m", [2, 9, 16, 64])
@pytest.mark.parametrize("pad", [0, 3])
def test_from_boundaries_matches_jax(seed, m, pad):
    B, K = 4, 9
    bounds = _bounds(seed, B, K, pad)
    vals = np.cumsum(np.random.default_rng(seed + 5).uniform(0, 0.3, (B, K)), axis=1).astype(np.float32)
    vals[0] = 0.25  # flat: importance ∝ the live intervals
    sj = jsched.from_boundaries(jnp.asarray(bounds), jnp.asarray(vals), m)
    st = tsched.from_boundaries(torch.from_numpy(bounds), torch.from_numpy(vals), m)
    _close6(sj.alphas, st.alphas)
    _close6(sj.weights, st.weights)
    np.testing.assert_allclose(st.weights.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("known", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("rounds", [1, 4])
def test_refined_boundaries_match_jax(known, masked, rounds):
    rng = np.random.default_rng(14)
    B, feat = 4, (4, 5)
    x = rng.uniform(0, 1, (B,) + feat).astype(np.float32)
    b = np.zeros_like(x)
    t = rng.uniform(0, 1, B).astype(np.float32)
    mask = rng.uniform(size=(B, 4)) > 0.3 if masked else None
    fj, ft = _quadratic_fns(15, feat)
    fx = rng.uniform(0, 1, B).astype(np.float32) if known else None
    kw = dict(n_int=4, rounds=rounds)
    pj = jprobes.run_probe(
        "refine", fj, jnp.asarray(x), jnp.asarray(b), jnp.asarray(t), **kw,
        mask=None if mask is None else jnp.asarray(mask),
        known_fx=None if fx is None else jnp.asarray(fx))
    pt = tprobes.run_probe(
        "refine", ft, torch.from_numpy(x), torch.from_numpy(b), torch.from_numpy(t), **kw,
        mask=None if mask is None else torch.from_numpy(mask),
        known_fx=None if fx is None else torch.from_numpy(fx))
    assert tuple(pt.bounds.shape) == tuple(pt.vals.shape) == (B, 5 + rounds)
    np.testing.assert_allclose(pt.bounds.numpy(), np.asarray(pj.bounds), rtol=0, atol=1e-6)
    np.testing.assert_allclose(pt.vals.numpy(), np.asarray(pj.vals), rtol=1e-6, atol=1e-6)
    assert bool((torch.diff(pt.bounds, dim=1) >= 0).all())
    if known:
        np.testing.assert_array_equal(pt.vals[:, -1].numpy(), fx)


def test_refined_boundaries_tie_picks_the_first_interval():
    """A flat f ties every |Δf| at 0: both sides bisect interval 0 first."""
    fj = lambda xs, t: jnp.zeros(xs.shape[0])
    ft = lambda xs, t: torch.zeros(xs.shape[0])
    x = np.ones((2, 3), np.float32)
    bj, _ = jprobes.refined_boundaries(fj, jnp.asarray(x), jnp.zeros((2, 3)), None, 2, 2)
    bt, _ = tprobes.refined_boundaries(ft, torch.from_numpy(x), torch.zeros(2, 3), None, 2, 2)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(bt[0].numpy(), [0.0, 0.125, 0.25, 0.5, 1.0])


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


@pytest.mark.parametrize("kind,known", [("none", False), ("boundary", False), ("boundary", True),
                                        ("refine", False), ("refine", True)])
def test_probe_cost_matches_jax(kind, known):
    for n_int in (2, 4, 8):
        for rounds in (1, 4):
            assert tprobes.probe_cost(kind, n_int=n_int, rounds=rounds, known_fx=known) == \
                jprobes.probe_cost(kind, n_int=n_int, rounds=rounds, known_fx=known)
