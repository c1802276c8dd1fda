"""The port's ViT and its explanations against ``repro.models.vit``, on the CPU.

Weights come from ``repro``'s seeded ``vit.init`` on ``reduced_vit()`` (two
layers, d=64, four heads of 16, 8×8 patches of 4×4×3) through
``params_from_numpy``, drawn once for the file; images from numpy with a
fixed seed. ``attn_impl="flash"`` runs the JAX flash op's Pallas kernels in
interpret mode and the port's flash op through its plain versions.

Tolerances: logits and log-probabilities to 1e-5 absolute (f32 matrix
products summed in another order); attributions to 1e-4 of the largest
|attribution| of their row; f(x), f(x′) to 1e-6 and δ to 1e-6 plus 1e-4 of
|f(x) − f(x′)| (another summation order of the attributions' sum).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.vit import CONFIG as J_CONFIG, reduced_vit as j_reduced_vit
from repro.core.api import Explainer as JExplainer
from repro.models import vit as jvit
from repro_torch.configs.vit import CONFIG, reduced_vit
from repro_torch.core.api import Explainer
from repro_torch.models import vit as tvit

torch.set_num_threads(1)

IMPLS = ["auto", "flash"]
M, N_INT, TARGETS = 16, 4, (1, 2)


def _cfgs(impl="auto"):
    return (dataclasses.replace(j_reduced_vit(), attn_impl=impl),
            dataclasses.replace(reduced_vit(), attn_impl=impl))


@functools.cache
def _jax_params():
    return jvit.init(j_reduced_vit(), jax.random.PRNGKey(0))


@functools.cache
def _port_params():
    return tvit.params_from_numpy(_jax_params(), device="cpu")


def _images(B=3, seed=0):
    s = reduced_vit().image_size
    return np.random.default_rng(seed).uniform(0, 1, (B, s, s, 3)).astype(np.float32)


def test_config_is_a_copy():
    assert dataclasses.asdict(CONFIG) == dataclasses.asdict(J_CONFIG)
    assert dataclasses.asdict(reduced_vit()) == dataclasses.asdict(j_reduced_vit())
    assert (CONFIG.num_patches, CONFIG.patch_dim, CONFIG.resolved_head_dim) == (196, 768, 64)


def test_patchify_is_exact():
    jcfg, tcfg = _cfgs()
    x = _images(seed=3)
    want = np.asarray(jvit.patchify(jcfg, jnp.asarray(x)))
    assert np.array_equal(tvit.patchify(tcfg, torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("impl", IMPLS)
def test_logits_match_jax(impl):
    jcfg, tcfg = _cfgs(impl)
    x = _images()
    want = np.asarray(jax.jit(jvit.forward, static_argnums=0)(jcfg, _jax_params(), jnp.asarray(x)))
    got = tvit.forward(tcfg, _port_params(), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_target_logprob_at_ragged_pos_matches_jax(impl):
    """Bucket-padded patch features (S past the grid, zero pos-embed there)
    with per-row valid lengths."""
    jcfg, tcfg = _cfgs(impl)
    rng = np.random.default_rng(4)
    S = jcfg.num_patches + 5
    feats = rng.uniform(0, 1, (3, S, jcfg.patch_dim)).astype(np.float32)
    pos, target = np.array([S - 1, 40, 9], np.int32), np.array([3, 0, 7], np.int32)
    jm = jvit.VitModel(jcfg)
    je = jm.embed_features(_jax_params(), jnp.asarray(feats))
    want = jax.jit(jm.target_logprob_at_fn(_jax_params()))(
        je, {"pos": jnp.asarray(pos), "target": jnp.asarray(target)})
    tm = tvit.VitModel(tcfg, _port_params())
    te = tm.embed_features(torch.from_numpy(feats))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=0, atol=1e-5)
    got = tm.target_logprob_at_fn()(te, {"pos": torch.from_numpy(pos),
                                         "target": torch.from_numpy(target)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_module_matches_functions():
    _, tcfg = _cfgs("flash")
    model = tvit.VitModel(tcfg, _port_params())
    x, t = torch.from_numpy(_images(seed=5)), torch.tensor([0, 4, 9])
    assert torch.equal(model(x), tvit.forward(tcfg, _port_params(), x))
    assert torch.equal(model.prob(x, t), tvit.prob_fn(tcfg, _port_params(), x, t))
    assert not any(p.requires_grad for p in model.parameters())
    assert model.tree()["layers"]["mixer"]["wq"].shape == (2, 64, 4, 16)


@pytest.mark.parametrize("cfg_name", ["reduced", "full"])
def test_init_params_shapes_and_scale_rule(cfg_name):
    """Shapes are ``vit.param_defs``'; each normal tensor's std is its
    ``ParamDef`` scale or 1/√fan_in with the stacked layers axis counted."""
    from repro.models.common import _fan_in, is_def

    tcfg = reduced_vit() if cfg_name == "reduced" else CONFIG
    jcfg = j_reduced_vit() if cfg_name == "reduced" else J_CONFIG
    params = tvit.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    again = tvit.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    defs = jvit.param_defs(jcfg)
    jleaves = jax.tree_util.tree_leaves_with_path(defs, is_leaf=is_def)
    assert len(jleaves) == len(jax.tree_util.tree_leaves(params))
    for path, d in jleaves:
        keys = [k.key for k in path]
        p = functools.reduce(lambda node, k: node[k], keys, params)
        assert tuple(p.shape) == d.shape, keys
        assert torch.equal(p, functools.reduce(lambda node, k: node[k], keys, again))
        assert tvit.fan_in(d.shape) == _fan_in(d.shape)
        if d.init == "zeros":
            assert not p.any()
        elif d.init == "ones":
            assert bool((p == 1).all())
        elif p.numel() >= 4096:
            want = d.scale if d.scale is not None else 1 / np.sqrt(_fan_in(d.shape))
            assert abs(float(p.std()) / want - 1) < 0.05, keys


@functools.cache
def _explained(fused):
    """JAX's and the port's ``ig``/``paper`` results on the flash ViT."""
    jcfg, tcfg = _cfgs("flash")
    x = _images(B=2, seed=6)
    b, t = np.zeros_like(x), np.array(TARGETS, np.int32)
    fj = lambda xs, tt: jvit.prob_fn(jcfg, _jax_params(), xs, tt)
    rj = JExplainer(fj, method="ig", schedule="paper", m=M, n_int=N_INT, fused=fused).attribute(
        jnp.asarray(x), jnp.asarray(b), jnp.asarray(t))
    ft = lambda xs, tt: tvit.prob_fn(tcfg, _port_params(), xs, tt)
    rt = Explainer(ft, method="ig", schedule="paper", m=M, n_int=N_INT, fused=fused,
                   device="cpu").attribute(x, b, t)
    return tuple(np.asarray(a) for a in rj), tuple(a.numpy() for a in rt)


@pytest.mark.parametrize("fused", [False, True])
def test_flash_vit_explanation_matches_jax(fused):
    (ja, jfx, jfb, jd), (ta, tfx, tfb, td) = _explained(fused)
    assert ta.shape == ja.shape == (2, 32, 32, 3) and np.isfinite(ta).all()
    lim = 1e-4 * np.abs(ja).reshape(2, -1).max(1)
    assert (np.abs(ta - ja).reshape(2, -1).max(1) <= lim).all()
    np.testing.assert_allclose(tfx, jfx, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tfb, jfb, rtol=0, atol=1e-6)
    assert (np.abs(td - jd) <= 1e-6 + 1e-4 * np.abs(jfx - jfb)).all()
