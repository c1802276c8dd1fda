"""The port's forward-only class (occlusion, RISE, LIME) against ``repro.core.perturb``.

Both packages run on the CPU in one process. Inputs come from numpy with a
fixed seed; the RISE and LIME masks are JAX's own draw (``jax.random`` has
no PyTorch counterpart), handed to the port's ``attribute_from_masks`` as
numpy, as the path-ensemble tests hand in JAX's normals. Three models: a
toy position-weighted nonlinearity, the reduced ViT (``reduced_vit``,
``repro``'s seeded weights through ``params_from_numpy``) over its 64 patch
features, and the paper CNN over 4×4×3 image cells (S=64), each f the
target-class logit as ``benchmarks/quality.py`` composes it.

Tolerances: occlusion and RISE scores to 1e-5 of the largest |score| (the
same f-values summed in another order); LIME to 1e-4, the port's default
hook (the plain Gauss–Jordan sweep) against JAX with its Pallas solve in
interpret mode (the normal equations' sums in another order, amplified by
the solve); f(x), f(x′) to 1e-5 absolute (logits, as the model tests).
Masks, group maps and the cell views exactly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import CONFIG as J_CNN
from repro.configs.vit import reduced_vit as j_reduced_vit
from repro.core import methods as jmethods
from repro.core import perturb as jperturb
from repro.core.api import Explainer as JExplainer
from repro.kernels.lstsq.ops import wls_solve as j_wls_solve
from repro.models import cnn as jcnn
from repro.models import vit as jvit
from repro_torch.configs.paper_cnn import CONFIG as T_CNN
from repro_torch.configs.vit import reduced_vit
from repro_torch.core import ig, methods, perturb, schedule
from repro_torch.core.api import Explainer
from repro_torch.models import cnn as tcnn
from repro_torch.models import vit as tvit

torch.set_num_threads(1)

FWD = ("occlusion", "rise", "lime")
CELL = 4  # benchmarks/quality.py CNN_CELL: 32×32×3 -> 64 cells of 4×4×3
J_SOLVE = functools.partial(j_wls_solve, interpret=True)


def _np(a):
    return np.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


# ------------------------------------------------------------------ models


def _toy_pair():
    def fj(xs, t):
        w = 1.0 + jnp.arange(xs.shape[1], dtype=jnp.float32)[None, :, None]
        return jnp.tanh((w * xs).sum((-2, -1)) / 8.0) + 0.01 * (xs**2).sum((-2, -1))

    def ft(xs, t):
        w = 1.0 + torch.arange(xs.shape[1], dtype=torch.float32)[None, :, None]
        return torch.tanh((w * xs).sum((-2, -1)) / 8.0) + 0.01 * (xs**2).sum((-2, -1))

    return fj, ft


@functools.cache
def _vit():
    jcfg, tcfg = j_reduced_vit(), reduced_vit()
    jp = jvit.init(jcfg, jax.random.PRNGKey(0))
    tp = tvit.params_from_numpy(jp, device="cpu")

    def fj(fe, t):
        logits = jvit.pool_logits(jcfg, jp, jvit.encode(jcfg, jp, jvit.embed_features(jcfg, jp, fe)))
        return jnp.take_along_axis(logits, t[:, None], axis=-1)[:, 0]

    def ft(fe, t):
        logits = tvit.pool_logits(tcfg, tp, tvit.encode(tcfg, tp, tvit.embed_features(tcfg, tp, fe)))
        return logits.gather(1, t[:, None])[:, 0]

    return fj, ft, jcfg, tcfg


@functools.cache
def _cnn():
    jp = jax.jit(jcnn.init, static_argnums=0)(J_CNN, jax.random.PRNGKey(0))
    tp = tcnn.params_from_numpy(jp, device="cpu")
    shape = (J_CNN.image_size, J_CNN.image_size, J_CNN.channels)

    def fj(imgs, t):
        return jnp.take_along_axis(jcnn.forward(J_CNN, jp, imgs), t[:, None], axis=-1)[:, 0]

    def ft(imgs, t):
        return tcnn.forward(T_CNN, tp, imgs).gather(1, t[:, None])[:, 0]

    return jperturb.cell_fn(fj, shape, CELL), perturb.cell_fn(ft, shape, CELL), shape


def _case(name, B=2, seed=0):
    """(f_jax, f_port, x (B, S, E) numpy, targets numpy)."""
    rng = np.random.default_rng(seed)
    if name == "toy":
        fj, ft = _toy_pair()
        return fj, ft, rng.standard_normal((B, 10, 3)).astype(np.float32), np.zeros(B, np.int32)
    if name == "vit":
        fj, ft, jcfg, _ = _vit()
        s = jcfg.image_size
        imgs = rng.uniform(0, 1, (B, s, s, 3)).astype(np.float32)
        return fj, ft, _np(jvit.patchify(jcfg, jnp.asarray(imgs))), rng.integers(0, 10, B).astype(np.int32)
    fj, ft, shape = _cnn()
    imgs = rng.uniform(0, 1, (B,) + shape).astype(np.float32)
    return fj, ft, _np(jperturb.image_to_cells(jnp.asarray(imgs), CELL)), rng.integers(0, 10, B).astype(np.int32)


def _port_masks(pm):
    """JAX's drawn PerturbMasks as the port's, on the CPU."""
    return perturb.PerturbMasks(*(_t(a) for a in pm))


def _close_scores(got, want, method):
    rel = 1e-4 if method == "lime" else 1e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


# ------------------------------------------------------------ registry, refusals


def test_registry_lists_the_forward_only_class():
    assert sorted(methods.METHODS) == sorted(jmethods.METHODS)
    for name in FWD:
        js, ts = jmethods.get(name), methods.get(name)
        for field in ("name", "accum", "forward_only", "grad_linear", "n_masks", "description"):
            assert getattr(ts, field) == getattr(js, field), (name, field)
        assert ts.accum_fn is perturb._FWD[name][1] and ts.finalize is perturb._FWD[name][2]
    assert not any(methods.get(n).forward_only for n in ("ig", "idgi", "noise_tunnel", "expected_grad"))


def test_class_boundaries_fail_loudly():
    """The gradient engine refuses forward-only specs (so does Explainer,
    as JAX's does), and the perturbation entry refuses gradient methods."""
    fj, ft = _toy_pair()
    x = np.random.default_rng(0).standard_normal((1, 6, 3)).astype(np.float32)
    xt, bt = _t(x), torch.zeros(1, 6, 3)
    t = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="forward-only"):
        ig.attribute(ft, xt, bt, schedule.uniform(4, device="cpu"), t, method="rise")
    for name in FWD:
        with pytest.raises(ValueError, match="forward-only"):
            Explainer(ft, method=name, m=4, n_int=2, device="cpu").attribute(xt, bt, t)
        with pytest.raises(ValueError, match="forward-only"):
            JExplainer(fj, method=name, m=4, n_int=2).attribute(jnp.asarray(x), jnp.zeros((1, 6, 3)),
                                                                jnp.zeros(1, jnp.int32))
    pm = perturb.PerturbExplainer(ft, method="rise", n_masks=4, device="cpu").masks_for(1, 6)
    with pytest.raises(ValueError, match="gradient-based"):
        perturb.attribute_from_masks(ft, xt, bt, t, pm, method="ig")
    with pytest.raises(ValueError, match="unknown perturbation method"):
        perturb.draw_masks("saliency", [0], 6, 4, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        perturb.attribute_from_masks(ft, xt, bt, t, pm, method="rise", chunk=3)


# ------------------------------------------------------------------- masks


@pytest.mark.parametrize("S,P", [(7, 4), (16, 16), (5, 8), (196, 64), (64, 64), (10, 3)])
def test_occlusion_masks_equal_jax(S, P):
    got = perturb.occlusion_masks(S, P)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), _np(jperturb.occlusion_masks(S, P)))


@pytest.mark.parametrize("S", [1, 5, 10, 16, 17, 64, 196])
def test_group_maps_equal_jax(S):
    G = perturb.default_n_groups(S)
    assert G == jperturb.default_n_groups(S)
    gids = perturb.lime_group_ids(S, G)
    assert gids.dtype == torch.int32
    np.testing.assert_array_equal(gids.numpy(), _np(jperturb.lime_group_ids(S, G)))
    mask = (np.random.default_rng(S).uniform(size=(3, S)) > 0.6).astype(np.float32)
    mask[0, :] = 0.0
    np.testing.assert_array_equal(perturb.group_real_mask(_t(mask), gids, G).numpy(),
                                  _np(jperturb.group_real_mask(jnp.asarray(mask), jnp.asarray(gids), G)))


def test_lime_weights_match_jax():
    zg = (np.random.default_rng(3).uniform(size=(2, 9, 16)) > 0.5).astype(np.float32)
    for width in (0.25, 0.3):
        np.testing.assert_allclose(perturb.lime_weights(_t(zg), width).numpy(),
                                   _np(jperturb.lime_weights(jnp.asarray(zg), width)), rtol=1e-6, atol=0)


@pytest.mark.parametrize("method", ["rise", "lime"])
def test_mask_replay_is_pure_in_seed_width_and_row(method):
    """A row's masks depend on (seed, S, row index) only: the same in any
    batch and on every call; another row, width or seed draws others."""
    pe = perturb.PerturbExplainer(lambda x, t: x, method=method, n_masks=16, seed=5, device="cpu")
    S = 12
    small, large = pe.masks_for(3, S), pe.masks_for(7, S)
    assert torch.equal(small.z, large.z[:3]) and torch.equal(pe.masks_for(3, S).z, small.z)
    assert not torch.equal(large.z[0], large.z[1])
    assert not torch.equal(dataclasses.replace(pe, seed=6).masks_for(3, S).z, small.z)
    assert not torch.equal(pe.masks_for(3, S + 1).z[..., :S], small.z)
    z = small.z
    assert z.shape == (3, 16, S) and set(z.unique().tolist()) <= {0.0, 1.0}
    if method == "lime":
        G = perturb.default_n_groups(S)
        assert small.groups.shape == (3, 16, G) and torch.equal(small.groups, large.groups[:3])
        assert torch.equal(z, small.groups[..., small.group_ids.long()])
    assert 0.3 < float(z.mean()) < 0.7  # Bernoulli(0.5)


# ---------------------------------------------------- scores against JAX


@pytest.mark.parametrize("case", ["toy", "vit", "cnn"])
@pytest.mark.parametrize("method", FWD)
def test_attribute_from_masks_matches_jax(method, case):
    """The same masks through both packages: JAX's draw for RISE/LIME."""
    fj, ft, x, t = _case(case, seed=1)
    B, S = x.shape[:2]
    P, chunk = (16, 8) if case != "toy" else (8, 4)
    pm = jperturb.PerturbExplainer(fj, method=method, n_masks=P, seed=2).masks_for(B, S)
    bl = np.zeros_like(x)
    kw = dict(method=method, chunk=chunk)
    want = jperturb.attribute_from_masks(fj, jnp.asarray(x), jnp.asarray(bl), jnp.asarray(t), pm,
                                         solve_fn=J_SOLVE, **kw)
    got = perturb.attribute_from_masks(ft, _t(x), _t(bl), _t(t).long(), _port_masks(pm), **kw)
    assert got.attributions.shape == (B, S) and got.attributions.dtype == torch.float32
    _close_scores(got.attributions.numpy(), _np(want.attributions), method)
    for field in ("f_x", "f_baseline"):
        np.testing.assert_allclose(getattr(got, field).numpy(), _np(getattr(want, field)), rtol=0,
                                   atol=1e-5)
    assert bool(torch.isfinite(got.delta).all())


def test_occlusion_explainer_equals_jax():
    """Occlusion is deterministic: the port's PerturbExplainer draws JAX's
    masks exactly and scores within 1e-5."""
    fj, ft, x, t = _case("vit", B=3, seed=4)
    B, S = x.shape[:2]
    jp = jperturb.PerturbExplainer(fj, method="occlusion", n_masks=16, chunk=8)
    tp = perturb.PerturbExplainer(ft, method="occlusion", n_masks=16, chunk=8, device="cpu")
    np.testing.assert_array_equal(tp.masks_for(B, S).z.numpy(), _np(jp.masks_for(B, S).z))
    want = jp.attribute(jnp.asarray(x), jnp.zeros_like(jnp.asarray(x)), jnp.asarray(t))
    got = tp.attribute(_t(x), torch.zeros(x.shape), _t(t).long())
    _close_scores(got.attributions.numpy(), _np(want.attributions), "occlusion")


@pytest.mark.parametrize("method", FWD)
def test_ragged_mask_and_group_valid_match_jax(method):
    """Right-padded rows: pad positions pinned to the baseline and scored
    exactly 0; LIME groups without a real position pinned out of the solve."""
    fj, ft, x, t = _case("toy", B=3, seed=5)
    B, S = x.shape[:2]
    lengths = np.array([S, 7, 3])
    mask = (np.arange(S)[None, :] < lengths[:, None]).astype(np.float32)
    bl = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32) * 0.1
    pm = jperturb.PerturbExplainer(fj, method=method, n_masks=8, seed=1).masks_for(B, S)
    gv = None
    if method == "lime":
        gv = jperturb.group_real_mask(jnp.asarray(mask), pm.group_ids, pm.groups.shape[-1])
        assert not bool(jnp.all(gv))  # some groups lie wholly in the padding
    want = jperturb.attribute_from_masks(fj, jnp.asarray(x), jnp.asarray(bl), jnp.asarray(t), pm,
                                         method=method, mask=jnp.asarray(mask), group_valid=gv,
                                         chunk=4, solve_fn=J_SOLVE)
    got = perturb.attribute_from_masks(ft, _t(x), _t(bl), _t(t), _port_masks(pm), method=method,
                                       mask=_t(mask), group_valid=_t(gv), chunk=4)
    a = got.attributions.numpy()
    assert np.all(a[mask == 0.0] == 0.0)
    _close_scores(a, _np(want.attributions), method)
    # the explainer computes group_valid itself and gives the same scores
    tp = perturb.PerturbExplainer(ft, method=method, n_masks=8, chunk=4, device="cpu")
    tm = tp.masks_for(B, S)
    res = tp.attribute(_t(x), _t(bl), _t(t), mask=_t(mask))
    gv_t = None if method != "lime" else perturb.group_real_mask(_t(mask), tm.group_ids, tm.groups.shape[-1])
    direct = perturb.attribute_from_masks(ft, _t(x), _t(bl), _t(t), tm, method=method, mask=_t(mask),
                                          group_valid=gv_t, chunk=4)
    assert torch.equal(res.attributions, direct.attributions)
    assert np.all(res.attributions.numpy()[mask == 0.0] == 0.0)


# --------------------------------------------------------------- plumbing


@pytest.mark.parametrize("method", FWD)
def test_chunk_is_a_memory_knob(method):
    """Any divisor of P gives the same scores to float tolerance (JAX's own
    test's bands: f32 sums in another order; LIME's through the solve)."""
    _, ft, x, t = _case("toy", seed=0)
    full = perturb.PerturbExplainer(ft, method=method, n_masks=8, seed=3, device="cpu")
    res = full.attribute(_t(x), torch.zeros(x.shape), _t(t))
    rtol = 1e-3 if method == "lime" else 1e-5
    for chunk in (2, 4):
        chunked = dataclasses.replace(full, chunk=chunk).attribute(_t(x), torch.zeros(x.shape), _t(t))
        np.testing.assert_allclose(chunked.attributions.numpy(), res.attributions.numpy(), rtol=rtol,
                                   atol=1e-6)


@pytest.mark.parametrize("method", FWD)
def test_f_x_reuse(method):
    """A known f(x) skips the x-evaluation and changes nothing."""
    _, ft, x, t = _case("toy", seed=2)
    pe = perturb.PerturbExplainer(ft, method=method, n_masks=8, seed=1, device="cpu")
    pm = pe.masks_for(*x.shape[:2])
    xt, bt, tt = _t(x), torch.zeros(x.shape), _t(t)
    base = perturb.attribute_from_masks(ft, xt, bt, tt, pm, method=method)
    reused = perturb.attribute_from_masks(ft, xt, bt, tt, pm, method=method, f_x=ft(xt, tt))
    np.testing.assert_allclose(reused.attributions.numpy(), base.attributions.numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(reused.f_x.numpy(), base.f_x.numpy(), rtol=1e-6, atol=0)


def test_forward_only_keeps_no_tape():
    """The class runs under no_grad: the scores carry no graph even when
    the input asks for gradients."""
    _, ft, x, t = _case("toy")
    xt = _t(x).requires_grad_()
    res = perturb.PerturbExplainer(ft, method="lime", n_masks=8, device="cpu").attribute(
        xt, torch.zeros(x.shape), _t(t))
    assert not res.attributions.requires_grad and res.attributions.grad_fn is None


def test_cell_views_are_exact_and_inverse():
    imgs = np.random.default_rng(0).uniform(size=(2, 8, 8, 3)).astype(np.float32)
    cells = perturb.image_to_cells(_t(imgs), 4)
    np.testing.assert_array_equal(cells.numpy(), _np(jperturb.image_to_cells(jnp.asarray(imgs), 4)))
    assert torch.equal(perturb.cells_to_image(cells, (8, 8, 3), 4), _t(imgs))
    f_img = lambda xs, t: xs.sum((1, 2, 3))
    assert torch.equal(perturb.cell_fn(f_img, (8, 8, 3), 4)(cells, None), f_img(_t(imgs), None))
    scores = np.arange(8, dtype=np.float32).reshape(2, 4)
    px = perturb.cell_scores_to_pixels(_t(scores), (8, 8, 3), 4)
    np.testing.assert_array_equal(px.numpy(),
                                  _np(jperturb.cell_scores_to_pixels(jnp.asarray(scores), (8, 8, 3), 4)))
