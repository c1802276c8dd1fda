"""The port's training path against ``repro``'s on the CPU: the data
pipeline, AdamW, gradient compression, the loss and its gradients, three
whole train steps, the CLI, and whisper's missing frames.

Weights come from ``repro``'s seeded ``Model(cfg).init`` (jitted) through
``params_from_numpy``; batches from both packages' ``SyntheticLM``, which
must agree bit for bit; gradients and optimizer inputs from numpy with
fixed seeds. Configs are ``reduced(ARCHS[...])`` (d=64), gemma3-27b cut to
8 layers (one period of LLLLLG and the (L, L) remainder) and jamba to 5
(its remainder M_D M_E M_D M_E A_D), at f32 compute unless a test says
bf16.

Tolerances (f32 products summed in another order, then AdamW, which
normalises each component, so a gradient component near 0 can move its
parameter by up to lr in another direction):
  * batches and the schedule's lr: exact; a 3-step AdamW, functional and
    in place, on the same gradients: 1e-6 relative (measured 0);
    ``compress_grads``: the dequantized values exactly,
    the error 1e-7 of the leaf's largest |value|;
  * the loss 1e-6 relative, its gradient 2e-5 of each leaf's largest
    |value| (measured: 5.7e-6 on jamba, 2.8e-6 on mamba2, ≤ 8.2e-7 else);
  * three f32 train steps: loss and grad-norm 1e-6 relative (measured
    6.1e-7), lr 1e-6 (8.0e-8), params 2e-4 of the leaf's largest |value|
    (1.4e-4), the moments 1e-4 (2.1e-5), the share of components whose
    3-step update went the other way 1e-3 (measured 0);
  * three f32 steps with ``grad_compression`` (a component whose quotient
    lies near a rounding edge quantizes one step apart, and the error
    feedback carries it): params 5e-3 of the leaf's largest |value|
    (measured 1.1e-3), the moments 2e-2 (4.0e-3), the share of components
    whose 3-step update went the other way 1e-3 (measured 0); the error
    buffers are not compared (a component one step apart has its error
    turned round);
  * three bf16 steps (bf16 products rounded in another order): loss and
    grad-norm 2e-3 relative (measured 5.9e-4), params 5e-2 of the leaf's
    largest |value| (1.8e-2), the moments 5e-2 (1.4e-2), the share of
    components whose 3-step update went the other way 2e-2 (7.8e-3; a
    wrong update parts about half of them).
"""
import dataclasses
import functools
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.train as j_train
from repro import optim as joptim
from repro.configs import ARCHS as J_ARCHS, ArchConfig as JArchConfig, LayerSpec as JLayerSpec
from repro.configs import get_config as j_get_config, reduced as j_reduced
from repro.data import DataConfig as JDataConfig, SyntheticLM as JSyntheticLM
from repro.models.registry import Model as JModel
from repro.train import TrainConfig as JTrainConfig, TrainState as JTrainState
from repro.train import make_train_step as j_make_train_step
from repro.train.step import compress_grads as j_compress_grads
from repro_torch import optim
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.data import DataConfig, SyntheticLM, make_pipeline
from repro_torch.launch import train as t_train
from repro_torch.models import lm
from repro_torch.models.common import params_from_numpy, tree_leaves
from repro_torch.models.registry import Model
from repro_torch.train import (TrainConfig, compress_grads, init_train_state, make_grad_fn,
                               make_train_step)

torch.set_num_threads(1)

LAYERS = {"gemma3-27b": 8, "jamba-v0.1-52b": 5}
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)  # past warmup within 3 steps
B, S = 4, 16
# three train steps: params and moments, of each leaf's largest |value|, and
# the share of components whose update went the other way (module docstring)
STEP_TOL = {"float32": (2e-4, 1e-4, 1e-3), "float32, grad_compression": (5e-3, 2e-2, 1e-3),
            "bfloat16": (5e-2, 5e-2, 2e-2)}


def _cfgs(name, dtype="float32"):
    kw = dict(compute_dtype=dtype)
    if name in LAYERS:
        kw["num_layers"] = LAYERS[name]
    return (dataclasses.replace(j_reduced(J_ARCHS[name]), **kw),
            dataclasses.replace(reduced(ARCHS[name]), **kw))


@functools.cache
def _jparams(name, dtype="float32"):
    return jax.jit(JModel(_cfgs(name, dtype)[0]).init)(jax.random.PRNGKey(0))


def _batch(cfg, step=0, b=B, s=S):
    return SyntheticLM(DataConfig(cfg.vocab_size, s, b)).batch_at(step)


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _rel(got, want):
    """max |got − want| over the largest |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if not want.size:  # a stack of zero periods
        return 0.0
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------------------- data


@pytest.mark.parametrize("vocab,seq,batch,seed,hosts", [
    (512, 16, 4, 0, 1), (128_256, 128, 8, 0, 1), (1000, 33, 6, 7, 2), (51_865, 64, 4, 3, 4)])
def test_batches_equal_repro_bit_for_bit(vocab, seq, batch, seed, hosts):
    for host in range(hosts):
        kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed, host_index=host,
                  host_count=hosts)
        got, want = SyntheticLM(DataConfig(**kw)), JSyntheticLM(JDataConfig(**kw))
        assert got.local_batch == want.local_batch == batch // hosts
        for step in (0, 1, 5, 1000):
            g, w = got.batch_at(step), want.batch_at(step)
            assert g.keys() == w.keys() == {"tokens", "labels"}
            for k in g:
                assert g[k].dtype == w[k].dtype == np.int32
                np.testing.assert_array_equal(g[k], w[k])


def test_pipeline_resumes_and_prefetches():
    cfg = DataConfig(512, 16, 4, seed=2)
    ds = SyntheticLM(cfg)
    for prefetch in (0, 2):
        it = make_pipeline(cfg, start_step=3, prefetch=prefetch)
        for step in range(3, 7):
            b = next(it)
            np.testing.assert_array_equal(b["tokens"], ds.batch_at(step)["tokens"])
    first = next(iter(ds))
    np.testing.assert_array_equal(first["labels"], ds.batch_at(0)["labels"])


# -------------------------------------------------------------- optimizer


def _tree(rng, scale=1.0):
    """A mixed tree: a 2-D weight, a 1-D bias, a stacked (P, d) norm scale
    (decayed, as in ``repro``) and a stacked 4-D weight."""
    shapes = {"w": (8, 5), "b": (5,), "layers": ({"norm": {"scale": (3, 7)}, "wq": (3, 4, 2, 6)},)}

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        if isinstance(s, tuple) and isinstance(s[0], dict):
            return tuple(draw(v) for v in s)
        return (rng.normal(size=s) * scale).astype(np.float32)

    return draw(shapes)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to_torch(v) for v in tree)
    return torch.from_numpy(np.array(tree))


@pytest.mark.parametrize("step", [0, 1, 2, 5, 99, 100, 101, 5000, 10_000, 20_000])
def test_cosine_schedule_equals_repro(step):
    cfg, jcfg = optim.AdamWConfig(), joptim.AdamWConfig()
    got = optim.cosine_schedule(cfg, torch.tensor(step, dtype=torch.int32))
    want = joptim.cosine_schedule(jcfg, jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0)


@pytest.mark.parametrize("scale", [0.01, 10.0])  # below and above the clip norm
def test_global_norm_and_clip_equal_repro(scale):
    g = _tree(np.random.default_rng(1), scale)
    gn = optim.global_norm(_to_torch(g))
    np.testing.assert_allclose(float(gn), float(joptim.global_norm(g)), rtol=1e-6)
    got, gn2 = optim.clip_by_global_norm(_to_torch(g), 1.0)
    want, _ = joptim.clip_by_global_norm(g, 1.0)
    assert float(gn2) == float(gn)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_adamw_equals_repro_and_decays_stacked_norms(n_steps):
    rng = np.random.default_rng(2)
    params = _tree(rng, 0.5)
    grads = [_tree(rng, s) for s in (3.0, 0.1, 1.0)[:n_steps]]  # the first above the clip norm
    cfg, jcfg = optim.AdamWConfig(**OPT), joptim.AdamWConfig(**OPT)
    tp, ts = _to_torch(params), optim.adamw_init(_to_torch(params))
    jp, js = params, joptim.adamw_init(params)
    nodecay = dataclasses.replace(cfg, weight_decay=0.0)
    tp0, ts0 = _to_torch(params), optim.adamw_init(_to_torch(params))
    fp, fs = _to_torch(params), optim.adamw_init(_to_torch(params))  # the functional form
    for g in grads:
        fp, fs, fm = optim.adamw_update(cfg, _to_torch(g), fs, fp)
        tp, ts, tm = optim.adamw_update_(cfg, _to_torch(g), ts, tp)
        jp, js, jm = joptim.adamw_update(jcfg, g, js, jp)
        tp0, ts0, _ = optim.adamw_update_(nodecay, _to_torch(g), ts0, tp0)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
            np.testing.assert_allclose(float(fm[k]), float(jm[k]), rtol=1e-6)
    assert int(ts.step) == int(fs.step) == int(js.step) == n_steps and ts.step.dtype == torch.int32
    for got_p, got_s in ((tp, ts), (fp, fs)):
        for name, got, want in (("params", got_p, jp), ("m", got_s.m, js.m), ("v", got_s.v, js.v)):
            for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7, err_msg=name)
    # the stacked (P, d) norm scale decays as a 2-D leaf does; the bias does not
    scale, bias = tp["layers"][0]["norm"]["scale"], tp["b"]
    assert not torch.equal(scale, tp0["layers"][0]["norm"]["scale"])
    assert torch.equal(bias, tp0["b"])


def test_compress_grads_equals_repro():
    rng = np.random.default_rng(3)
    g = {"a": rng.normal(size=(64, 33)).astype(np.float32),
         "b": (rng.normal(size=(7,)) * 1e-3).astype(np.float32),
         "z": np.zeros((4, 4), np.float32)}  # an all-zero leaf: scale 1e-12, no NaN
    e = {k: (rng.normal(size=v.shape) * 0.01).astype(np.float32) for k, v in g.items()}
    want_d, want_e = j_compress_grads(g, e)
    got_d, got_e = compress_grads(_to_torch(g), _to_torch(e))
    for k in g:
        np.testing.assert_array_equal(got_d[k].numpy(), np.asarray(want_d[k]))
        np.testing.assert_allclose(got_e[k].numpy(), np.asarray(want_e[k]), rtol=0,
                                   atol=1e-7 * max(float(np.abs(np.asarray(want_e[k])).max()), 1e-12))
        assert np.isfinite(got_d[k].numpy()).all()


# ------------------------------------------------------------------- loss


@pytest.mark.parametrize("name", ["llama3-8b", "gemma3-27b", "qwen3-moe-30b-a3b", "mamba2-780m",
                                  "jamba-v0.1-52b", "internvl2-26b"])
def test_loss_and_gradients_equal_repro(name):
    jcfg, cfg = _cfgs(name)
    jp = _jparams(name)
    batch = _batch(cfg, b=2)
    jm = JModel(jcfg)
    want_l, want_g = jax.jit(jax.value_and_grad(jm.loss))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    params = params_from_numpy(jp, device="cpu")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    got_l = Model(cfg).loss(params, _t(batch), remat=True)
    got_g = torch.autograd.grad(got_l, leaves, allow_unused=True)
    got_l = got_l.detach()
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-6)
    for i, (g, w) in enumerate(zip(got_g, jax.tree.leaves(want_g))):
        g = torch.zeros(w.shape) if g is None else g  # a frontend projection on text-only batches
        assert _rel(g.numpy(), w) <= 2e-5, (i, _rel(g.numpy(), w))
    if cfg.num_experts:  # the aux loss is in: without it the loss would part by more than 1e-6
        with torch.no_grad():
            _, aux = lm.forward_hidden_train(cfg, params, _t(batch))
        assert float(aux) > 1e-4


def test_remat_changes_no_bit():
    _, cfg = _cfgs("qwen3-moe-30b-a3b")
    params = params_from_numpy(_jparams("qwen3-moe-30b-a3b"), device="cpu")
    batch = _t(_batch(cfg))
    grad_fn = lambda remat: make_grad_fn(cfg, TrainConfig(remat=remat))(params, batch)
    (l0, g0), (l1, g1) = grad_fn(False), grad_fn(True)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g0), tree_leaves(g1)))


def test_whisper_has_no_frames_to_train_on():
    """``SyntheticLM`` yields tokens and labels only, and an encoder-decoder
    reads ``batch["frontend"]``: both packages raise ``KeyError``."""
    jcfg, cfg = _cfgs("whisper-tiny")
    batch = _batch(cfg)
    jp = JModel(jcfg).abstract_params()  # the trace raises before any weight is read
    with pytest.raises(KeyError, match="frontend"):
        jax.eval_shape(j_make_train_step(jcfg, JTrainConfig()), JTrainState(jp, joptim.adamw_init(jp), None),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    state = init_train_state(Model(cfg).init(torch.Generator().manual_seed(0), device="cpu"), TrainConfig())
    with pytest.raises(KeyError, match="frontend"):
        make_train_step(cfg, TrainConfig())(state, _t(batch))


# ---------------------------------------------------------- the whole step


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mb,comp", [(1, False), (2, False), (1, True)],
                         ids=["plain", "microbatches=2", "grad_compression"])
def test_three_train_steps_equal_repro(dtype, mb, comp):
    jcfg, cfg = _cfgs("llama3-8b", dtype)
    jt = JTrainConfig(optimizer=joptim.AdamWConfig(**OPT), microbatches=mb, grad_compression=comp)
    tt = TrainConfig(optimizer=optim.AdamWConfig(**OPT), microbatches=mb, grad_compression=comp)
    jp = _jparams("llama3-8b")  # f32 weights either way
    p0 = [np.asarray(x, np.float64) for x in jax.tree.leaves(jp)]
    js = JTrainState(jp, joptim.adamw_init(jp), jax.tree.map(jnp.zeros_like, jp) if comp else None)
    ts = init_train_state(params_from_numpy(jp, device="cpu"), tt)
    jstep, tstep = jax.jit(j_make_train_step(jcfg, jt)), make_train_step(cfg, tt)
    f32 = dtype == "float32"
    for step in range(3):
        batch = _batch(cfg, step)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in batch.items()})
        ts, tm = tstep(ts, _t(batch))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6 if f32 else 2e-3, err_msg=k)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(ts.opt.step) == 3
    tol_p, tol_mv, tol_flip = STEP_TOL["float32, grad_compression" if f32 and comp else dtype]
    for i, (a, b, z) in enumerate(zip(tree_leaves(ts.params), jax.tree.leaves(js.params), p0)):
        assert _rel(a.numpy(), b) <= tol_p, (i, _rel(a.numpy(), b))
        flip = np.mean(np.sign(a.numpy() - z) != np.sign(np.asarray(b, np.float64) - z)) if z.size else 0.0
        assert flip <= tol_flip, (i, flip)
    for tree, jtree in ((ts.opt.m, js.opt.m), (ts.opt.v, js.opt.v)):
        for a, b in zip(tree_leaves(tree), jax.tree.leaves(jtree)):
            assert _rel(a.numpy(), b) <= tol_mv
    assert (ts.err is None) == (js.err is None)


# -------------------------------------------------------------------- CLI


def _repro_config(cfg) -> JArchConfig:
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["pattern"] = tuple(JLayerSpec(s.mixer, s.ffn) for s in cfg.pattern)
    return JArchConfig(**fields)


DONE = re.compile(r"done: (\d+) steps in [\d.]+s \(\d+ ms/step\) loss ([\d.]+) -> ([\d.]+) stragglers=(\d+)")


def _lines(text):
    """(the params line, resumed-from steps, (steps, first loss, last loss, stragglers))."""
    head = next(line for line in text.splitlines() if line.startswith("arch="))
    resumed = [int(s) for s in re.findall(r"^resumed from step (\d+)$", text, re.M)]
    m = DONE.search(text)
    return head, resumed, (int(m[1]), float(m[2]), float(m[3]), int(m[4]))


def test_cli_equals_repro(capsys, monkeypatch, tmp_path):
    """``--reduced`` at f32 on ``repro``'s weights: the same params= line
    and line shapes, losses within the printed third decimal; the port
    resumes from ``repro``'s checkpoint (written at step 2 of a 3-step
    run) and ends on ``repro``'s last loss."""
    monkeypatch.setattr(j_train, "get_config",
                        lambda n: dataclasses.replace(j_get_config(n), compute_dtype="float32"))
    monkeypatch.setattr(t_train, "get_config",
                        lambda n: dataclasses.replace(get_config(n), compute_dtype="float32"))
    monkeypatch.setattr(t_train, "draw", lambda cfg, args, device="cuda": params_from_numpy(
        JModel(_repro_config(cfg)).init(jax.random.PRNGKey(args.seed)), device=device))
    argv = ["--reduced", "--steps", "3", "--batch", "4", "--seq", "16"]
    ckpt = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv + ckpt)
    assert j_train.main() == 0
    want = _lines(capsys.readouterr().out)
    assert t_train.main(argv + ["--device", "cpu"]) == 0
    got = _lines(capsys.readouterr().out)
    assert got[0] == want[0] == "arch=llama3-8b-reduced params=0.1M steps=3"
    assert got[1] == want[1] == []
    assert got[2][0] == want[2][0] == 3 and got[2][3] == want[2][3]
    np.testing.assert_allclose(got[2][1:3], want[2][1:3], rtol=0, atol=1.1e-3)
    assert t_train.main(argv + ["--device", "cpu", "--ckpt-dir", str(tmp_path)]) == 0
    resumed = _lines(capsys.readouterr().out)
    assert resumed[1] == [2] and resumed[2][0] == 1
    np.testing.assert_allclose(resumed[2][2], want[2][2], rtol=0, atol=1.1e-3)
