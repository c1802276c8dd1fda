"""The trained-classifier substrate of the port against ``benchmarks/common.py``
on the CPU: the synthetic task, the training step, the npz files, and the
config names ``repro.configs`` resolves.

``benchmarks/common.py`` is loaded read-only from its file as the JAX
reference; nothing is trained to the end and nothing under ``results/`` is
read. Weights come from ``repro``'s seeded init (jitted) through
``params_from_numpy``; batches from JAX's ``synthetic_images``.

Tolerances:
  * images fed JAX's own draws: 1e-6 absolute (``exp`` and ``sin`` of
    XLA and of PyTorch part by an ulp), labels exactly;
  * the training steps: the loss 1e-5 relative (f32 convolutions and
    products summed in another order); after the steps every parameter
    leaf, and each moment, within 2e-5 of its largest |value| (measured:
    1.3e-6 and 3.0e-6 on the CNN, 3.4e-7 and 1.7e-6 on the ViT). AdamW
    normalises each component, so a gradient component near 0 may move its
    parameter by up to that step's lr (1e-4, 2e-4, 3e-4 here) in another
    direction: the share of components whose update went the other way is
    held to 1e-3;
  * the npz files: exact.
"""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import cnn as jcnn, vit as jvit
from repro.optim import AdamWConfig as JAdamWConfig, adamw_init as j_adamw_init, adamw_update as j_adamw_update
from repro_torch import configs
from repro_torch.configs import PAPER_CNN, reduced_vit
from repro_torch.data import render_images, synthetic_images
from repro_torch.models import cnn as tcnn, vit as tvit
from repro_torch.models.common import params_from_numpy, tree_leaves
from repro_torch.models.registry import VitFacade
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train import classifier

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
STEP_TOL = {"cnn": (2e-5, 2e-5), "vit": (2e-5, 2e-5)}  # params, moments: of each leaf's largest |value|


@functools.cache
def _common():
    """``benchmarks/common.py``, loaded from its file (not as a package)."""
    spec = importlib.util.spec_from_file_location("bench_common_reference", ROOT / "benchmarks" / "common.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jcfg(kind):
    return jconfigs.PAPER_CNN if kind == "cnn" else jconfigs.reduced_vit()


def _tcfg(kind):
    return PAPER_CNN if kind == "cnn" else reduced_vit()


# ------------------------------------------------------------------ the task


@pytest.mark.parametrize("frac", [0.0, 0.35])
@pytest.mark.parametrize("kind", ["cnn", "vit"])
def test_render_matches_jax_synthetic_images(kind, frac):
    """``render_images`` fed JAX's draws, redrawn in ``common.py``'s split
    order (labels, noise, background, scale), equals JAX's images."""
    jcfg, tcfg, n = _jcfg(kind), _tcfg(kind), 16
    key = jax.random.PRNGKey(3)
    imgs, labels = _common().synthetic_images(key, n, jcfg, background_frac=frac)
    kx, kn, kb, ks = jax.random.split(key, 4)
    lab = torch.from_numpy(np.array(jax.random.randint(kx, (n,), 1, jcfg.num_classes)))
    noise = torch.from_numpy(np.array(jax.random.normal(kn, (n, jcfg.image_size, jcfg.image_size))))
    bg = scale = None
    if frac > 0:
        bg = torch.from_numpy(np.array(jax.random.uniform(kb, (n,)) < frac))
        scale = torch.from_numpy(np.array(jax.random.uniform(ks, (n,), minval=0.02, maxval=0.25)))
    ti, tl = render_images(tcfg, lab, noise, bg, scale)
    assert ti.shape == imgs.shape and ti.dtype == torch.float32
    np.testing.assert_allclose(ti.numpy(), np.asarray(imgs), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(labels))
    if frac > 0:
        assert bool((tl == 0).any()) and bool((tl > 0).any())


@pytest.mark.parametrize("frac", [0.0, 0.35])
def test_synthetic_images_repeat_from_one_seed(frac):
    a, la = synthetic_images(torch.Generator().manual_seed(5), 32, background_frac=frac, device="cpu")
    b, lb = synthetic_images(torch.Generator().manual_seed(5), 32, background_frac=frac, device="cpu")
    assert torch.equal(a, b) and torch.equal(la, lb)
    assert a.shape == (32, 32, 32, 3) and float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    if frac == 0:
        assert int(la.min()) >= 1 and int(la.max()) <= 9
    else:
        assert int(la.min()) == 0
    c, _ = synthetic_images(torch.Generator().manual_seed(6), 32, background_frac=frac, device="cpu")
    assert not torch.equal(a, c)


def test_eval_batch_and_held_out_sets():
    x, t = classifier.eval_batch(8, device="cpu")
    x2, t2 = synthetic_images(torch.Generator().manual_seed(classifier.EVAL_SEED), 8, device="cpu")
    assert torch.equal(x, x2) and torch.equal(t, t2) and int(t.min()) >= 1
    params = tcnn.init_params(PAPER_CNN, torch.Generator().manual_seed(0), device="cpu")
    acc = classifier.accuracy(params, n=16)
    assert 0.0 <= acc <= 1.0 and acc * 16 == int(acc * 16)
    f = classifier.cnn_prob_fn(params)
    p = f(x, t)
    assert p.shape == (8,) and bool(((p > 0) & (p < 1)).all())


def test_prompt_pool_and_zipf_sample_match_common():
    pj = _common().prompt_pool(np.random.default_rng(1), 100, 7)
    pt = classifier.prompt_pool(np.random.default_rng(1), 100, 7)
    assert all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(pj, pt)) and len(pt) == 7
    np.testing.assert_array_equal(classifier.zipf_sample(np.random.default_rng(2), 9, 50),
                                  _common().zipf_sample(np.random.default_rng(2), 9, 50))


# ------------------------------------------------------------- the training


@functools.cache
def _jax_init(kind):
    mod = jcnn if kind == "cnn" else jvit
    return jax.jit(functools.partial(mod.init, _jcfg(kind)))(jax.random.PRNGKey(0))


@functools.cache
def _jax_steps(kind, n_steps):
    """``n_steps`` of ``train_cnn``'s (``train_vit``'s) step composed from
    ``repro``'s forward and AdamW, on JAX-drawn batches of 8: (the batches,
    the losses, the params, the optimizer state)."""
    jcfg, mod = _jcfg(kind), (jcnn if kind == "cnn" else jvit)
    steps = 300 if kind == "cnn" else 250
    ocfg = JAdamWConfig(lr=2e-3, warmup_steps=20, total_steps=steps, weight_decay=0.0)

    @jax.jit
    def step(params, opt, imgs, labels):
        def loss_fn(p):
            logp = jax.nn.log_softmax(mod.forward(jcfg, p, imgs))
            return -jnp.mean(jnp.take_along_axis(logp, labels[:, None], 1))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, opt, _ = j_adamw_update(ocfg, grads, opt, params)
        return params, opt, loss

    params = _jax_init(kind)
    opt = j_adamw_init(params)
    key = jax.random.PRNGKey(11)
    batches, losses = [], []
    for i in range(n_steps):
        imgs, labels = _common().synthetic_images(jax.random.fold_in(key, i), 8, jcfg, background_frac=0.35)
        batches.append((np.array(imgs), np.array(labels)))
        params, opt, loss = step(params, opt, imgs, labels)
        losses.append(float(loss))
    return batches, losses, params, opt


def _port_params(kind, tree):
    return tcnn.params_from_numpy(tree, device="cpu") if kind == "cnn" else params_from_numpy(tree, device="cpu")


def _as_jax_layout(kind, tparams):
    """Port tensors -> numpy in ``repro``'s layout, leaves in tree order."""
    if kind == "cnn":
        return tree_leaves(tcnn.params_to_numpy(tparams))
    return [t.detach().numpy() for t in tree_leaves(tparams)]


@pytest.mark.parametrize("kind,n_steps", [("cnn", 3), ("vit", 2)])
def test_classifier_steps_match_jax(kind, n_steps):
    batches, jlosses, jparams, jopt = _jax_steps(kind, n_steps)
    tcfg = _tcfg(kind)
    forward = tcnn.forward if kind == "cnn" else tvit.forward
    steps = 300 if kind == "cnn" else 250
    ocfg = AdamWConfig(lr=2e-3, warmup_steps=20, total_steps=steps, weight_decay=0.0)
    params = _port_params(kind, jax.tree.map(np.asarray, _jax_init(kind)))
    start = _as_jax_layout(kind, params)
    opt = adamw_init(params)
    for (imgs, labels), jl in zip(batches, jlosses):
        params, opt, loss = classifier.classifier_step(forward, tcfg, ocfg, params, opt,
                                                       torch.from_numpy(imgs), torch.from_numpy(labels))
        assert abs(float(loss) - jl) <= 1e-5 * abs(jl), (float(loss), jl)
    assert int(opt.step) == n_steps
    ptol, mtol = STEP_TOL[kind]
    got, want = _as_jax_layout(kind, params), [np.asarray(a) for a in jax.tree.leaves(jparams)]
    assert len(got) == len(want)
    flipped = total = 0
    for g, w, s in zip(got, want, start):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= ptol * max(np.abs(w).max(), 1e-30)
        flipped += int((np.sign(g - s) * np.sign(w - s) < 0).sum())
        total += g.size
    assert flipped <= 1e-3 * total, (flipped, total)
    for name, t_tree, j_tree in (("m", opt.m, jopt.m), ("v", opt.v, jopt.v)):
        for g, w in zip(_as_jax_layout(kind, t_tree), jax.tree.leaves(j_tree)):
            w = np.asarray(w)
            assert np.abs(g - w).max() <= mtol * max(np.abs(w).max(), 1e-30), name


def test_train_classifier_stops_inside_its_schedule():
    """``stop`` runs the first steps of the full run's schedule: the same
    losses and weights as the first steps of a longer run."""
    _, a, la = classifier.train_classifier("vit", torch.Generator().manual_seed(1), 250, 4, 2e-3, stop=2,
                                           device="cpu")
    _, b, lb = classifier.train_classifier("vit", torch.Generator().manual_seed(1), 250, 4, 2e-3, stop=3,
                                           device="cpu")
    assert la.shape == (2,) and lb.shape == (3,) and torch.equal(la, lb[:2])
    assert bool(torch.isfinite(lb).all())
    with pytest.raises(ValueError, match="unknown classifier"):
        classifier.train_classifier("mlp", torch.Generator(), 1, 1, 1e-3, device="cpu")


# ------------------------------------------------------------ the npz files


def _random_jax_tree(kind):
    mod, rng = (jcnn if kind == "cnn" else jvit), np.random.default_rng(4)
    defs = mod.param_defs(_jcfg(kind))
    return jax.tree.map(lambda d: rng.standard_normal(d.shape).astype(np.float32), defs,
                        is_leaf=lambda x: hasattr(x, "shape"))


@pytest.mark.parametrize("kind", ["cnn", "vit"])
def test_a_jax_file_loads_into_the_port(kind, tmp_path):
    """A tree saved as ``common.py`` saves it loads through ``load_params``
    as ``params_from_numpy`` converts it."""
    tree = _random_jax_tree(kind)
    path = tmp_path / "jax.npz"
    np.savez(path, **{f"leaf_{i}": np.asarray(p) for i, p in enumerate(jax.tree.leaves(tree))})
    got = classifier.load_params(path, _tcfg(kind), device="cpu")
    want = _port_params(kind, tree)
    assert [tuple(t.shape) for t in tree_leaves(got)] == [tuple(t.shape) for t in tree_leaves(want)]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(want)))


@pytest.mark.parametrize("kind", ["cnn", "vit"])
def test_a_port_file_loads_into_jax(kind, tmp_path):
    """The port's file, unflattened over ``param_defs`` as ``common.py``
    loads it, equals the port's tensors (conv weights HWIO)."""
    tcfg, mod = _tcfg(kind), (jcnn if kind == "cnn" else jvit)
    init = tcnn.init_params if kind == "cnn" else tvit.init_params
    params = init(tcfg, torch.Generator().manual_seed(3), device="cpu")
    path = tmp_path / "port.npz"
    classifier.save_params(path, params)
    data = np.load(path)
    leaves, treedef = jax.tree.flatten(mod.param_defs(_jcfg(kind)), is_leaf=lambda x: hasattr(x, "shape"))
    assert len(data.files) == len(leaves)
    jtree = jax.tree.unflatten(treedef, [jnp.asarray(data[f"leaf_{i}"]) for i in range(len(leaves))])
    for got, want, d in zip(jax.tree.leaves(jtree), _as_jax_layout(kind, params), leaves):
        assert got.shape == tuple(d.shape)
        np.testing.assert_array_equal(np.asarray(got), want)
    again = classifier.load_params(path, tcfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(again), tree_leaves(params)))


def test_load_params_refuses_another_model(tmp_path):
    path = tmp_path / "cnn.npz"
    classifier.save_params(path, tcnn.init_params(PAPER_CNN, torch.Generator().manual_seed(0), device="cpu"))
    with pytest.raises(ValueError, match="leaves"):
        classifier.load_params(path, reduced_vit(), device="cpu")


# ------------------------------------------------------------ config names


@pytest.mark.parametrize("name", ["paper-cnn", "paper_cnn", "vit-s16", "vit"])
def test_get_config_resolves_the_vision_names(name):
    got, want = configs.get_config(name), jconfigs.get_config(name)
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_get_config_refuses_an_unknown_name_as_repro_does():
    with pytest.raises(KeyError) as got:
        configs.get_config("resnet-50")
    with pytest.raises(KeyError) as want:
        jconfigs.get_config("resnet-50")
    assert str(got.value) == str(want.value)


def test_configs_export_repro_names():
    assert set(jconfigs.__all__) <= set(configs.__all__)
    assert dataclasses.asdict(configs.PAPER_CNN) == dataclasses.asdict(jconfigs.PAPER_CNN)
    assert dataclasses.asdict(configs.VIT_S16) == dataclasses.asdict(jconfigs.VIT_S16)
    assert dataclasses.asdict(configs.reduced_vit()) == dataclasses.asdict(jconfigs.reduced_vit())
    assert configs.VitConfig.__name__ == jconfigs.VitConfig.__name__


@pytest.mark.parametrize("name", sorted(jconfigs.ARCHS))
def test_arch_config_properties_match_repro(name):
    got, want = configs.ARCHS[name], jconfigs.ARCHS[name]
    assert (got.attn_free, got.sub_quadratic) == (want.attn_free, want.sub_quadratic)


def test_jamba_layer_specs_match_repro():
    from repro.configs import jamba_v01_52b as jj
    from repro_torch.configs import jamba_v01_52b as tj

    for name in ("M_D", "M_E", "A_E"):
        assert dataclasses.asdict(getattr(tj, name)) == dataclasses.asdict(getattr(jj, name))


def test_vit_refuses_token_embedding_as_repro_does():
    jcfg = jconfigs.reduced_vit()
    with pytest.raises(TypeError) as want:
        jvit.VitModel(jcfg).embed_inputs(None, {"tokens": None})
    tcfg = reduced_vit()
    with pytest.raises(TypeError) as got:
        VitFacade(tcfg).embed_inputs(None, {"tokens": None})
    assert str(got.value) == str(want.value) and "features=patchify" in str(got.value)
    module = tvit.VitModel(tcfg, tvit.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu"))
    with pytest.raises(TypeError) as got:
        module.embed_inputs({"tokens": None})
    assert str(got.value) == str(want.value)
