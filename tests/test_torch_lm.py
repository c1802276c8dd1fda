"""The port's LM stack and serving batching against ``repro``'s, on the CPU.

Weights come from ``repro``'s seeded init of ``reduced(ARCHS["llama3-8b"])``
(2 layers, d=64, 4 heads on 2 kv heads, head dim 16, vocabulary 512)
through ``lm.params_from_numpy``, drawn once for the file; token ids from
numpy with a fixed seed. The model runs at ``compute_dtype="float32"`` on
both sides (eager PyTorch does not fuse bf16 casts as XLA does).
``attn_impl="flash"`` runs the JAX flash op's Pallas kernels in interpret
mode and the port's flash op through its plain versions.

Tolerances: logits and log-probabilities to 1e-5 absolute (f32 matrix
products summed in another order); rope to 1e-6 (f32 angles, another
``pow``); batching arrays exactly; each initialised tensor's std within 5%
of ``repro``'s rule.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS, reduced as j_reduced
from repro.configs.vit import reduced_vit as j_reduced_vit
from repro.core.probes import repeat_tree as j_repeat_tree
from repro.models import layers as jlayers, lm as jlm
from repro.models.registry import Model as JModel
from repro.serve import batching as jbatch
from repro.serve.autotune import HotpathConfig as JHotpathConfig, bucket_key as j_bucket_key
from repro.serve.explain_engine import ExplainRequest as JRequest
from repro_torch.configs import ARCHS, ArchConfig, LayerSpec, reduced
from repro_torch.configs.vit import reduced_vit
from repro_torch.core.probes import cat_tree, repeat_tree
from repro_torch.models import layers, lm, vit as tvit
from repro_torch.models.common import tree_map
from repro_torch.models.registry import Model, VitFacade, model_for
from repro_torch.serve import autotune, batching
from repro_torch.serve.explain_engine import ExplainRequest

torch.set_num_threads(1)

IMPLS = ["auto", "flash"]


def _cfgs(impl="auto"):
    kw = dict(compute_dtype="float32", attn_impl=impl)
    return (dataclasses.replace(j_reduced(J_ARCHS["llama3-8b"]), **kw),
            dataclasses.replace(reduced(ARCHS["llama3-8b"]), **kw))


@functools.cache
def _jax_params():
    return JModel(_cfgs()[0]).init(jax.random.PRNGKey(0))


@functools.cache
def _port_params():
    return lm.params_from_numpy(_jax_params(), device="cpu")


def _tokens(B=3, S=24, seed=0):
    return np.random.default_rng(seed).integers(1, 512, (B, S)).astype(np.int32)


def test_configs_are_copies():
    assert set(ARCHS) == set(J_ARCHS) - {"whisper-tiny", "internvl2-26b"} == {
        "gemma3-27b", "llama3-8b", "internlm2-20b", "yi-9b", "qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b",
        "mamba2-780m", "jamba-v0.1-52b"}
    for name, cfg in ARCHS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(J_ARCHS[name])
        assert dataclasses.asdict(reduced(cfg)) == dataclasses.asdict(j_reduced(J_ARCHS[name]))
        assert cfg.param_count() == J_ARCHS[name].param_count()
        assert cfg.active_param_count() == J_ARCHS[name].active_param_count()
        assert (cfg.d_inner, cfg.ssm_heads) == (J_ARCHS[name].d_inner, J_ARCHS[name].ssm_heads)
        model_for(cfg)
    cfg = reduced(ARCHS["llama3-8b"])
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim,
            cfg.vocab_size) == (2, 64, 4, 2, 16, 512)


def _port_config(jcfg):
    """A ``repro`` config as the port's ``ArchConfig``, field for field."""
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["pattern"] = tuple(LayerSpec(s.mixer, s.ffn) for s in jcfg.pattern)
    return ArchConfig(**fields)


@pytest.mark.parametrize("case", ["vision frontend", "internvl2-26b", "whisper-tiny"])
def test_model_for_refuses_what_the_lm_cannot_build(case):
    """A stub frontend (internvl2-26b's vision one) or an encoder
    (whisper-tiny's, with its audio frontend) is not ported."""
    if case == "vision frontend":
        cfg = dataclasses.replace(reduced(ARCHS["llama3-8b"]), frontend="vision")
    else:
        cfg = _port_config(j_reduced(J_ARCHS[case]))
    with pytest.raises(NotImplementedError, match="without frontend or encoder"):
        model_for(cfg)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, 4, 16)).astype(np.float32)
    pos = np.stack([np.arange(24), np.arange(24) + 100]).astype(np.int32)
    want = np.asarray(jlayers.rope(jnp.asarray(x), jnp.asarray(pos), theta))
    got = layers.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_embed_and_unembed_match_jax():
    jcfg, tcfg = _cfgs()
    toks = _tokens()
    for tie in (False, True):
        jc, tc = (dataclasses.replace(c, tie_embeddings=tie) for c in (jcfg, tcfg))
        je = jlayers.embed(_jax_params()["embed"], jnp.asarray(toks), jc, jnp.float32)
        te = layers.embed(_port_params()["embed"], torch.from_numpy(toks), tc, torch.float32)
        assert np.array_equal(te.numpy(), np.asarray(je))
        want = np.asarray(jlayers.unembed(_jax_params()["embed"], je, jc))
        np.testing.assert_allclose(layers.unembed(_port_params()["embed"], te, tc).numpy(), want,
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("cfg_name", ["reduced", "full"])
def test_param_defs_match_jax(cfg_name):
    """The same tree, shapes and init kinds as ``repro``'s ``param_defs``
    (the full-width tree is compared without allocating it)."""
    from repro.models.common import is_def

    jcfg = J_ARCHS["llama3-8b"] if cfg_name == "full" else _cfgs()[0]
    tcfg = ARCHS["llama3-8b"] if cfg_name == "full" else _cfgs()[1]
    jleaves = jax.tree_util.tree_leaves_with_path(jlm.param_defs(jcfg), is_leaf=is_def)
    tdefs = lm.param_defs(tcfg)
    for path, d in jleaves:
        node = tdefs
        for k in path:
            node = node[getattr(k, "key", getattr(k, "idx", None))]
        assert (tuple(node.shape), node.init, node.scale) == (tuple(d.shape), d.init, d.scale), path


def test_init_params_shapes_and_rule():
    """Each tensor of ``init_params`` has ``repro``'s shape and init rule:
    zeros/ones exactly, ``embed`` a unit normal, the rest normal with std
    1/√fan_in, the stacked layers axis (and wq's heads) in the fan-in."""
    from repro.models.common import _fan_in, is_def

    jcfg, tcfg = _cfgs()
    params = lm.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    again = lm.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    for path, d in jax.tree_util.tree_leaves_with_path(jlm.param_defs(jcfg), is_leaf=is_def):
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        t, t2 = params, again
        for k in keys:
            t, t2 = t[k], t2[k]
        assert tuple(t.shape) == tuple(d.shape) and t.dtype == torch.float32, keys
        assert torch.equal(t, t2) and not t.requires_grad
        if d.init in ("zeros", "ones"):
            assert torch.equal(t, torch.full_like(t, float(d.init == "ones"))), keys
            continue
        want = (d.scale or 1.0) if d.init == "embed" else 1 / np.sqrt(_fan_in(d.shape))
        assert abs(float(t.std()) / want - 1) < 0.05, (keys, float(t.std()), want)


@pytest.mark.parametrize("impl", IMPLS)
def test_logits_match_jax(impl):
    jcfg, tcfg = _cfgs(impl)
    toks = _tokens()
    jm, tm = JModel(jcfg), Model(tcfg)
    je = jm.embed_inputs(_jax_params(), {"tokens": jnp.asarray(toks)})
    te = tm.embed_inputs(_port_params(), {"tokens": torch.from_numpy(toks)})
    assert np.array_equal(te.numpy(), np.asarray(je))
    h, _ = jlm.hidden_from_embeds(jcfg, _jax_params(), je)
    want = np.asarray(jlm.logits(jcfg, _jax_params(), h))
    got = tm.logits(_port_params(), tm.hidden_from_embeds(_port_params(), te))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    want = jm.target_logprob_fn(_jax_params())(je, jnp.asarray([3, 4, 5]))
    got = tm.target_logprob_fn(_port_params())(te, torch.tensor([3, 4, 5]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_target_logprob_at_ragged_pos_matches_jax(impl):
    """Right-padded rows read their logits at pos = len − 1; the flash path
    passes lengths = pos + 1 as the kernels' kvlen."""
    jcfg, tcfg = _cfgs(impl)
    toks = _tokens(B=4, S=32, seed=2)
    pos, target = np.array([31, 8, 16, 0], np.int32), np.array([5, 7, 9, 11], np.int32)
    je = JModel(jcfg).embed_inputs(_jax_params(), {"tokens": jnp.asarray(toks)})
    want = JModel(jcfg).target_logprob_at_fn(_jax_params())(
        je, {"pos": jnp.asarray(pos), "target": jnp.asarray(target)})
    tm = Model(tcfg)
    te = tm.embed_inputs(_port_params(), {"tokens": torch.from_numpy(toks)})
    aux = {"pos": torch.from_numpy(pos), "target": torch.from_numpy(target)}
    got = tm.target_logprob_at_fn(_port_params())(te, aux)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    # a row's value does not depend on what lies past its last real token
    te2 = te.clone()
    te2[1, 9:] = 0.0
    np.testing.assert_allclose(tm.target_logprob_at_fn(_port_params())(te2, aux).numpy()[1],
                               got.numpy()[1], rtol=0, atol=1e-6)


def test_params_from_numpy_keeps_the_tree():
    tp = _port_params()
    assert isinstance(tp["layers"], tuple) and len(tp["layers"]) == 1 and tp["rem"] == ()
    assert tp["layers"][0]["mixer"]["wq"].shape == (2, 64, 4, 16)
    assert tp["embed"]["unembed"].shape == (64, 512)
    leaves = jax.tree_util.tree_leaves(_jax_params())
    ported = []
    tree_map(lambda _, t: ported.append(t), tp)
    assert len(ported) == len(leaves)
    assert all(np.array_equal(t.numpy(), np.asarray(a)) for t, a in zip(ported, leaves))
    assert not any(t.requires_grad for t in ported)


def test_model_for_vit_is_a_facade_over_the_port_vit():
    from repro.models import vit as jvit

    cfg = reduced_vit()
    facade = model_for(cfg)
    assert isinstance(facade, VitFacade)
    params = tvit.params_from_numpy(jvit.init(j_reduced_vit(), jax.random.PRNGKey(0)), device="cpu")
    feats = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (2, 64, cfg.patch_dim))
                             .astype(np.float32))
    module = tvit.VitModel(cfg, params)
    e = facade.embed_features(params, feats)
    assert torch.equal(e, module.embed_features(feats))
    aux = {"pos": torch.tensor([63, 20]), "target": torch.tensor([1, 2])}
    assert torch.equal(facade.target_logprob_at_fn(params)(e, aux), module.target_logprob_at_fn()(e, aux))


def test_pytree_targets_repeat_and_concatenate_leafwise():
    aux = {"target": np.array([3, 4], np.int32), "pos": np.array([5, 1], np.int32)}
    want = j_repeat_tree({k: jnp.asarray(v) for k, v in aux.items()}, 3)
    taux = {k: torch.from_numpy(v) for k, v in aux.items()}
    got = repeat_tree(taux, 3)
    assert all(np.array_equal(got[k].numpy(), np.asarray(want[k])) for k in aux)
    both = cat_tree(taux, taux)
    assert all(both[k].tolist() == aux[k].tolist() * 2 for k in aux)
    assert repeat_tree(None, 3) is None and torch.equal(repeat_tree(torch.tensor([1, 2]), 2),
                                                        torch.tensor([1, 1, 2, 2]))


# ----------------------------------------------------------------- batching


def test_ladders_and_buckets_match_jax():
    for n, start in ((1000, 8), (5, 1), (64, 64), (65, 8)):
        assert batching.pow2_ladder(n, start=start) == jbatch.pow2_ladder(n, start=start)
    for size in (1, 7, 8, 9, 512, 1024):
        assert batching.bucket_for(size, batching.DEFAULT_SEQ_BUCKETS) == jbatch.bucket_for(
            size, jbatch.DEFAULT_SEQ_BUCKETS)
    with pytest.raises(ValueError):
        batching.bucket_for(1025, batching.DEFAULT_SEQ_BUCKETS)
    assert (batching.DEFAULT_SEQ_BUCKETS, batching.DEFAULT_BATCH_BUCKETS) == (
        jbatch.DEFAULT_SEQ_BUCKETS, jbatch.DEFAULT_BATCH_BUCKETS)
    for rows in ([0], [3, 1, 2], list(range(9))):
        for ladder in (None, (1, 2, 4, 8, 16)):
            for multiple in (1, 4):
                assert batching.pad_rows(rows, ladder, multiple=multiple) == jbatch.pad_rows(
                    rows, ladder, multiple=multiple)


def _plan_requests(kind, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for i, s in enumerate((9, 17, 24, 3, 30, 17, 8, 40, 12, 16, 33)):
        feats = rng.uniform(0, 1, (s, 6)).astype(np.float32) if kind == "features" else None
        fx = float(rng.normal()) if kind == "f_x" and i % 2 else None
        out.append((rng.integers(1, 512, s).astype(np.int32), int(rng.integers(0, 512)), feats, fx))
    return out


@pytest.mark.parametrize("kind", ["tokens", "features", "f_x"])
@pytest.mark.parametrize("kw", [dict(), dict(max_batch=2), dict(batch_buckets=None),
                                dict(batch_buckets=(1, 2, 4), seq_buckets=(16, 64), pad_id=7),
                                dict(batch_multiple=4)])
def test_plan_buckets_matches_jax(kind, kw):
    """Bucket shapes, row order, padding, overflow splitting (``max_batch``
    and a batch ladder smaller than a group) and the f_x grouping."""
    reqs = _plan_requests(kind)
    want = jbatch.plan_buckets([JRequest(*r) for r in reqs], **kw)
    got = batching.plan_buckets([ExplainRequest(*r) for r in reqs], **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.bucket, g.indices) == (w.bucket, w.indices)
        for name in ("tokens", "lens", "targets", "mask", "features", "f_x"):
            a, b = getattr(g, name), getattr(w, name)
            assert (a is None) == (b is None) and (a is None or np.array_equal(a, b)), name


def test_hotpath_config_and_bucket_key_match_jax():
    assert dataclasses.asdict(autotune.HotpathConfig(16)) == dataclasses.asdict(JHotpathConfig(16))
    for args in (((4, 32), "riemann", "paper", 64, 4, False), ((1, 8), "idgi", "warp", 8, 2, True)):
        for attn in ("auto", "flash"):
            assert autotune.bucket_key(*args, attn=attn) == j_bucket_key(*args, attn=attn)
