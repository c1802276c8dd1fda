"""whisper-tiny's encoder-decoder and internvl2-26b's vision frontend against
``repro``'s, on the CPU.

Both configs at ``reduced`` widths (whisper: 2 decoder and 2 encoder layers
over 24 frames of 32 features; internvl2: 2 layers, 8 patches of 32
features; d=64, 4 heads, vocabulary 512) and ``compute_dtype="float32"``,
with ``repro``'s seeded weights through ``lm.params_from_numpy``, drawn
once per config; token ids and frontend features from numpy with a fixed
seed. ``attn_impl="flash"`` runs ``repro``'s Pallas flash op in interpret
mode (non-causal over the encoder) and the port's flash op through its
plain versions.

Tolerances: hidden states, encoder outputs and logits to 1e-5 absolute (f32
products summed in another order); embeddings exactly; greedy tokens
equal; explanations as ``tests/test_torch_engine.py``: token scores to
1e-4 of the request's largest |score|, f(x) and f(x′) to 1e-6, δ to 1e-6
plus 1e-4 of |f(x) − f(x′)|.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS, reduced as j_reduced
from repro.models import lm as jlm
from repro.models.registry import Model as JModel
from repro.serve import ExplainEngine as JEngine, ExplainRequest as JRequest, ServeEngine as JServe
from repro.serve import GenerateRequest as JGen, MixedScheduler as JSched
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import blocks, lm
from repro_torch.models.common import tree_map
from repro_torch.models.registry import Model
from repro_torch.roofline import hotpath_cost
from repro_torch.serve import (ExplainEngine, ExplainRequest, GenerateRequest, MixedScheduler,
                               ServeEngine)

torch.set_num_threads(1)

NAMES = ["whisper-tiny", "internvl2-26b"]
IMPLS = ["auto", "flash"]
TOL = 1e-5
B, S = 2, 12


def _cfgs(name, impl="auto"):
    kw = dict(compute_dtype="float32", attn_impl=impl)
    return (dataclasses.replace(j_reduced(J_ARCHS[name]), **kw),
            dataclasses.replace(reduced(ARCHS[name]), **kw))


@functools.cache
def _jax_params(name):
    return JModel(_cfgs(name)[0]).init(jax.random.PRNGKey(0))


@functools.cache
def _port_params(name):
    return lm.params_from_numpy(_jax_params(name), device="cpu")


def _batch(name, seed=0):
    """(tokens (B, S), frontend features: whisper's encoder frames or
    internvl2's patches) as numpy."""
    cfg = _cfgs(name)[1]
    rng = np.random.default_rng(seed)
    n = cfg.encoder_seq if cfg.frontend == "audio" else cfg.frontend_tokens
    return (rng.integers(1, cfg.vocab_size, (B, S)).astype(np.int32),
            rng.standard_normal((B, n, cfg.frontend_dim)).astype(np.float32))


def _jb(toks, fe):
    return {"tokens": jnp.asarray(toks), "frontend": jnp.asarray(fe)}


def _tb(toks, fe):
    return {"tokens": torch.from_numpy(toks), "frontend": torch.from_numpy(fe)}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=tol)


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("name", NAMES)
def test_every_leaf_is_carried(name):
    """``params_from_numpy`` carries every leaf of ``repro``'s tree (the
    encoder, ``norm_x``, ``cross`` and ``frontend_proj`` among them), and the
    port's own definitions have the same tree, shape for shape."""
    want = dict(_leaves(_jax_params(name)))
    got = dict(_leaves(_port_params(name)))
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_array_equal(got[path].numpy(), np.asarray(w), err_msg=str(path))
    shapes = {}
    tree_map(lambda path, d: shapes.__setitem__(path, tuple(d.shape)), lm.param_defs(_cfgs(name)[1]))
    assert shapes == {path: np.shape(w) for path, w in want.items()}
    assert ("embed", "frontend_proj") in want
    if name == "whisper-tiny":
        assert {p[0] for p in want} >= {"encoder"}
        assert any("cross" in p for p in want) and any("norm_x" in p for p in want)


@pytest.mark.parametrize("impl", IMPLS)
def test_encode_matches_repro(impl):
    jcfg, tcfg = _cfgs("whisper-tiny", impl)
    _, fe = _batch("whisper-tiny")
    want = jlm.encode(jcfg, _jax_params("whisper-tiny"), jnp.asarray(fe))
    got = lm.encode(tcfg, _port_params("whisper-tiny"), torch.from_numpy(fe))
    assert got.shape == (B, tcfg.encoder_seq, tcfg.d_model)
    _close(got, want)


def test_embed_inputs_prepends_the_patches():
    jcfg, tcfg = _cfgs("internvl2-26b")
    toks, fe = _batch("internvl2-26b")
    want = jlm.embed_inputs(jcfg, _jax_params("internvl2-26b"), _jb(toks, fe))
    got = lm.embed_inputs(tcfg, _port_params("internvl2-26b"), _tb(toks, fe))
    assert got.shape == (B, tcfg.frontend_tokens + S, tcfg.d_model)
    _close(got, want, 1e-6)
    # without patches the batch is the token stream, as in repro
    only = lm.embed_inputs(tcfg, _port_params("internvl2-26b"), {"tokens": torch.from_numpy(toks)})
    np.testing.assert_array_equal(only.numpy(), got[:, tcfg.frontend_tokens:].numpy())


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", NAMES)
def test_forward_hidden_and_logits_match_repro(name, impl):
    jcfg, tcfg = _cfgs(name, impl)
    toks, fe = _batch(name)
    jp, tp = _jax_params(name), _port_params(name)
    jh, _ = jlm.forward_hidden(jcfg, jp, _jb(toks, fe))
    th = Model(tcfg).forward_hidden(tp, _tb(toks, fe))
    _close(th, jh)
    _close(lm.logits(tcfg, tp, th), jlm.logits(jcfg, jp, jh))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("name", NAMES)
def test_prefill_and_decode_match_repro(name, impl):
    """The prefill's last logits, then 4 teacher-forced decode steps."""
    jcfg, tcfg = _cfgs(name, impl)
    toks, fe = _batch(name)
    jp, tp = _jax_params(name), _port_params(name)
    max_len = tcfg.frontend_tokens * (tcfg.frontend == "vision") + S + 8
    jl, jc = jlm.prefill(jcfg, jp, _jb(toks, fe), max_len)
    tl, tc = lm.prefill(tcfg, tp, _tb(toks, fe), max_len)
    _close(tl, jl)
    feed = np.random.default_rng(1).integers(1, tcfg.vocab_size, (B, 4)).astype(np.int32)
    for j in range(4):
        jl, jc = jlm.decode_step(jcfg, jp, jc, jnp.asarray(feed[:, j:j + 1]))
        tl, tc = lm.decode_step(tcfg, tp, tc, torch.from_numpy(feed[:, j:j + 1]))
        _close(tl, jl)
    assert int(tc["len"]) == int(jc["len"])


def test_decode_never_writes_the_cross_cache():
    """``xk``/``xv`` hold the prefill's encoder keys and values through every
    decode step, so ``decode_snapshot`` need restore nothing of them."""
    _, tcfg = _cfgs("whisper-tiny")
    toks, fe = _batch("whisper-tiny")
    tp = _port_params("whisper-tiny")
    _, cache = lm.prefill(tcfg, tp, _tb(toks, fe), S + 4)
    xs = [t.clone() for e in cache["layers"] for k, t in e.items() if k in ("xk", "xv")]
    assert len(xs) == 2 and all(bool(x.abs().sum() > 0) for x in xs)
    for _ in range(3):
        _, cache = lm.decode_step(tcfg, tp, cache, torch.ones((B, 1), dtype=torch.int32))
    for x, (k, t) in zip(xs, [(k, t) for e in cache["layers"] for k, t in e.items() if k in ("xk", "xv")]):
        assert torch.equal(x, t), k


@functools.cache
def _repro_generated(name, max_len, n):
    jcfg, _ = _cfgs(name)
    toks, fe = _batch(name)
    return np.asarray(JServe(jcfg, _jax_params(name), max_len=max_len).generate(_jb(toks, fe), n))


@pytest.mark.parametrize("name", NAMES)
def test_greedy_generate_matches_repro(name):
    _, tcfg = _cfgs(name)
    toks, fe = _batch(name)
    n = 10
    max_len = tcfg.frontend_tokens * (tcfg.frontend == "vision") + S + n
    got = ServeEngine(tcfg, _port_params(name), max_len=max_len, device="cpu").generate(_tb(toks, fe), n)
    np.testing.assert_array_equal(got.numpy(), _repro_generated(name, max_len, n))


def test_vision_fit_check_raises_where_repro_clamps():
    """``repro.launch.serve`` sizes the cache as prompt + new tokens; with
    patches prepended the last ``frontend_tokens`` decode writes clamp onto
    its last slot. The port refuses that cache before the prefill; the
    steps before the clamp equal a cache with room."""
    _, tcfg = _cfgs("internvl2-26b")
    toks, fe = _batch("internvl2-26b")
    P, n = tcfg.frontend_tokens, 10
    eng = ServeEngine(tcfg, _port_params("internvl2-26b"), max_len=S + n, device="cpu")
    with pytest.raises(ValueError, match="patches"):
        eng.generate(_tb(toks, fe), n)
    clamped = _repro_generated("internvl2-26b", S + n, n)
    assert clamped.shape == (B, n)  # repro serves it without a word
    roomy = _repro_generated("internvl2-26b", P + S + n, n)
    np.testing.assert_array_equal(clamped[:, :n - P], roomy[:, :n - P])
    fits = ServeEngine(tcfg, _port_params("internvl2-26b"), max_len=P + S + n - 1, device="cpu")
    assert fits.generate(_tb(toks, fe), n).shape == (B, n)  # the last token needs no slot


@pytest.mark.parametrize("name", NAMES)
def test_explain_ig_matches_repro(name):
    """``ig`` over the token stream (no encoder output, no patches) on one
    bucket, against ``repro``'s engine."""
    jcfg, tcfg = _cfgs(name)
    rng = np.random.default_rng(2)
    reqs = [(rng.integers(1, 512, s).astype(np.int32), int(rng.integers(0, 512))) for s in (9, 13)]
    kw = dict(m=8, n_int=4, seq_buckets=(16,))
    want = JEngine(jcfg, _jax_params(name), **kw).explain([JRequest(t, g) for t, g in reqs])
    eng = ExplainEngine(tcfg, _port_params(name), device="cpu", use_kernels=False, **kw)
    got = eng.explain([ExplainRequest(t, g) for t, g in reqs])
    assert sorted(eng.stats.buckets) == [(2, 16)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["token_scores"], w["token_scores"], rtol=0,
                                   atol=1e-4 * np.abs(w["token_scores"]).max())
        for k in ("f_x", "f_baseline"):
            assert abs(g[k] - w[k]) <= 1e-6, (k, g[k], w[k])
        assert abs(g["delta"] - w["delta"]) <= 1e-6 + 1e-4 * abs(w["f_x"] - w["f_baseline"])


@pytest.mark.parametrize("name", ["whisper-tiny", "internvl2-26b", "llama3-8b"])
def test_hotpath_cost_counts_only_what_explanation_runs(name):
    """Explanation runs the decoder over the token stream: no encoder, no
    cross-attention, no frontend projection."""
    cfg = ARCHS[name]
    bare = dataclasses.replace(cfg, encoder_layers=0, frontend=None)
    for bucket, m, chunk in (((4, 64), 64, 16), ((1, 512), 32, 32)):
        got = hotpath_cost(cfg, bucket, m, chunk, "bfloat16", probe_forwards=6, fused=True)
        assert got == hotpath_cost(bare, bucket, m, chunk, "bfloat16", probe_forwards=6, fused=True)
    if name == "whisper-tiny":  # 4 decoder layers of 2.36 M weights, of 21.39 M non-embedding
        embeddings = 2 * cfg.vocab_size * cfg.d_model
        assert bare.param_count() - embeddings == 4 * 2_360_064
        assert cfg.param_count() - embeddings == 21_387_264


def test_schedulers_fail_on_a_whisper_generate_request():
    """A generate request carries no encoder frames: ``repro``'s scheduler
    raises ``KeyError: 'frontend'`` building the prefill, the port's
    refuses the request at submission."""
    jcfg, tcfg = _cfgs("whisper-tiny")
    prompt = np.arange(1, 9, dtype=np.int32)
    jsched = JSched(JEngine(jcfg, _jax_params("whisper-tiny"), m=8, seq_buckets=(8, 16)), max_len=16)
    jsched.submit(JGen(tokens=prompt, num_tokens=2))
    with pytest.raises(KeyError, match="frontend"):
        jsched.run_until_idle()
    sched = MixedScheduler(ExplainEngine(tcfg, _port_params("whisper-tiny"), m=8, seq_buckets=(8, 16),
                                         device="cpu"), max_len=16)
    with pytest.raises(ValueError, match="encoder-decoder"):
        sched.submit(GenerateRequest(tokens=prompt, num_tokens=2))
    sched.submit(ExplainRequest(tokens=prompt, target=3))  # explain-only traffic is served
    sched.run_until_idle()
    assert [t.status for t in sched.tickets] == ["done"]


def test_layer_cache_holds_the_cross_keys():
    _, tcfg = _cfgs("whisper-tiny")
    c = blocks.layer_cache(tcfg, tcfg.pattern[0], 3, 20, torch.float32, device="cpu")
    assert set(c) == {"k", "v", "xk", "xv"}
    assert c["xk"].shape == (3, tcfg.encoder_seq, tcfg.num_kv_heads, tcfg.resolved_head_dim)
    with pytest.raises(ValueError, match="encoder frames"):
        toks, fe = _batch("whisper-tiny")
        lm.prefill(tcfg, _port_params("whisper-tiny"), _tb(toks, fe[:, :-1]), S + 2)
