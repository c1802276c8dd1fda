"""The port's paper CNN against ``repro.models.cnn`` on the CPU.

Weights come from ``repro``'s seeded init through ``params_from_numpy``;
images from numpy with a fixed seed. Tolerances: logits to 1e-5 absolute
(f32 convolutions summed in another order); input gradients of the target
probability to 1e-4 of their largest magnitude.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_cnn import CONFIG as J_CONFIG
from repro.models import cnn as jcnn
from repro_torch.configs.paper_cnn import CONFIG
from repro_torch.models import cnn as tcnn

torch.set_num_threads(1)


@functools.cache
def _jax_params():
    # eager ``cnn.init`` takes tens of seconds on the CPU: draw it once per file
    return jcnn.init(J_CONFIG, jax.random.PRNGKey(0))


def _setup(image_size=32, seed=0, B=3):
    jcfg = dataclasses.replace(J_CONFIG, image_size=image_size)
    tcfg = dataclasses.replace(CONFIG, image_size=image_size)
    params = _jax_params()  # the weights do not depend on the image size
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (B, image_size, image_size, 3)).astype(np.float32)
    t = rng.integers(0, 10, B)
    return jcfg, tcfg, params, tcnn.params_from_numpy(params, device="cpu"), x, t


def test_config_is_a_copy():
    assert dataclasses.asdict(CONFIG) == dataclasses.asdict(J_CONFIG)


@pytest.mark.parametrize("image_size", [32, 29])
def test_logits_match_jax(image_size):
    """29 is odd: SAME padding then splits evenly at stride 1 and unevenly
    at stride 2, on the other side than at 32."""
    jcfg, tcfg, params, tparams, x, _ = _setup(image_size)
    lj = np.asarray(jax.jit(jcnn.forward, static_argnums=0)(jcfg, params, jnp.asarray(x)))
    lt = tcnn.forward(tcfg, tparams, torch.from_numpy(x))
    np.testing.assert_allclose(lt.numpy(), lj, rtol=0, atol=1e-5)


def test_prob_input_gradients_match_jax():
    jcfg, tcfg, params, tparams, x, t = _setup(seed=1)
    gj = np.asarray(jax.jit(jax.grad(
        lambda xs: jcnn.prob_fn(jcfg, params, xs, jnp.asarray(t)).sum()))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    (gt,) = torch.autograd.grad(tcnn.prob_fn(tcfg, tparams, xt, torch.from_numpy(t)).sum(), xt)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=1e-4 * np.abs(gj).max())


def test_module_matches_functions():
    _, tcfg, _, tparams, x, t = _setup(seed=2)
    model = tcnn.PaperCNN(tcfg, tparams)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t)
    assert torch.equal(model(xt), tcnn.forward(tcfg, tparams, xt))
    assert torch.equal(model.prob(xt, tt), tcnn.prob_fn(tcfg, tparams, xt, tt))
    assert not any(p.requires_grad for p in model.parameters())


def test_init_params_shapes_scale_and_seed():
    params = tcnn.init_params(CONFIG, torch.Generator().manual_seed(0), device="cpu")
    again = tcnn.init_params(CONFIG, torch.Generator().manual_seed(0), device="cpu")
    converted = tcnn.params_from_numpy(_jax_params(), device="cpu")
    shapes = tcnn.param_shapes(CONFIG)
    for layer, group in shapes.items():
        for name, shape in group.items():
            p = params[layer][name]
            assert tuple(p.shape) == shape == tuple(converted[layer][name].shape)
            assert torch.equal(p, again[layer][name])
            if name == "b":
                assert not p.any()
    w = params["block3"]["t3b"]  # 32·3·3 = 288 fan-in, 18432 draws
    assert abs(float(w.std()) * np.sqrt(288) - 1.0) < 0.05
    logits = tcnn.forward(CONFIG, params, torch.rand(2, 32, 32, 3))
    assert logits.shape == (2, CONFIG.num_classes) and torch.isfinite(logits).all()
