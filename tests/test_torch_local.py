"""Local (sliding-window) attention, the ring KV cache and gemma3-27b in the
port, against ``repro`` on the CPU.

The model is ``reduced(ARCHS["gemma3-27b"], seq=16)`` at f32 compute: a
window of w = 8 tokens, 4 query heads on 2, head dim 16, d=64, at 12 layers
(two periods of 5 local + 1 global) and at 8 (one period and the (L, L)
remainder). Weights come from ``repro``'s seeded ``Model(cfg).init``
through ``params_from_numpy``, inputs from numpy with fixed seeds. Each
depth's ``repro`` reference (prefill, teacher-forced decode across the
ring's wrap, ``ServeEngine`` greedy, ``make_decode_chunk``, ``ExplainEngine``
``ig`` at buckets 16 = 2w and 32 > 2w) runs once, in a module fixture.

Tolerances (f32 products summed in another order): attention outputs,
cache leaves, log-probabilities, f(x) and f(x′) within 1e-5 absolute (the
largest errors measured here: 9.5e-7, 9.5e-7, 0 and 7.6e-6); logits and
token scores within 1e-5 of the larger of 1 and the array's largest
|value| (measured: 2.3e-5 on logits up to 76 in size, three f32 ulps
there, and 4.7e-5 on scores up to 44); δ within 1e-6 plus 1e-4 of
|f(x) − f(x′)| (the engine tests' δ rule); token ids exactly.

The scheduler's retry of a fault raised inside a decode chunk past the wrap
is the port's own (``repro``'s chunk donates its cache and cannot retry):
it must give the clean run's tokens and rings, and with the ring snapshot
disabled it must not.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS, reduced as j_reduced
from repro.models import attention as jattn
from repro.models.registry import Model as JModel
from repro.serve import ExplainEngine as JEngine, ExplainRequest as JRequest
from repro.serve import engine as jengine
from repro_torch.configs import ARCHS, LayerSpec, get_config, reduced
from repro_torch.models import attention as attn, blocks, lm
from repro_torch.models.registry import Model
from repro_torch.serve import ExplainEngine, ExplainRequest, GenerateRequest, MixedScheduler
from repro_torch.serve import engine
from repro_torch.runtime import FaultConfig

torch.set_num_threads(1)

W = 8  # the reduced window: reduced(..., seq=16)
B, MAX_LEN, N_GEN, CHUNK = 2, 40, 24, 6
TOL = 1e-5
# (layers, prompt length) of the prefill and the teacher-forced decode after it: below w
# (the ring wraps twice in decode), at w, between w and 2w, above 2w (the blocked path)
DECODES = ((12, 5), (12, 24), (8, 8), (8, 12))
LENS = (11, 16, 21, 32)  # explain traffic: buckets 16 (the masked path) and 32 (the blocked one)
EXPLAIN_KW = dict(method="ig", m=8, n_int=4, seq_buckets=(16, 32))


def _cfgs(layers=12):
    kw = dict(num_layers=layers, compute_dtype="float32")
    return (dataclasses.replace(j_reduced(J_ARCHS["gemma3-27b"], seq=16), **kw),
            dataclasses.replace(reduced(ARCHS["gemma3-27b"], seq=16), **kw))


@functools.cache
def _params(layers):
    jparams = JModel(_cfgs(layers)[0]).init(jax.random.PRNGKey(0))
    return jparams, lm.params_from_numpy(jparams, device="cpu")


def _leaves(tree):
    """A cache tree's arrays in a fixed order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def _close(got, want, scaled=False):
    """Within ``TOL`` absolute or, ``scaled``, within ``TOL`` of the larger
    of 1 and ``want``'s largest |value| (logits and token scores, whose
    values reach tens)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if scaled and want.size else 1.0
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), want, rtol=0, atol=TOL * scale)


def _tokens(S, seed=1, n=B):
    return np.random.default_rng(seed).integers(1, 512, (n, S)).astype(np.int32)


class _Ref:
    """One depth's ``repro`` serving reference, run once."""

    def __init__(self, layers):
        self.jcfg, self.cfg = _cfgs(layers)
        jparams, self.params = _params(layers)
        jm = JModel(self.jcfg)
        prefill = jax.jit(jm.prefill, static_argnums=(2,))
        step = jax.jit(jm.decode_step)
        self.prompts, self.decode = {}, {}
        for L, S in DECODES:
            if L != layers:
                continue
            toks = _tokens(4 * W + 4, seed=S)  # the prompt, then teacher-forced to past 4w
            self.prompts[S] = toks
            logits, cache = prefill(jparams, {"tokens": jnp.asarray(toks[:, :S])}, MAX_LEN)
            out = [(np.asarray(logits), _leaves(cache))]
            for j in range(S, toks.shape[1]):
                logits, cache = step(jparams, cache, jnp.asarray(toks[:, j:j + 1]))
                out.append((np.asarray(logits), _leaves(cache)))
            self.decode[S] = out
        self.gen_prompt = _tokens(12, seed=3)
        eng = jengine.ServeEngine(self.jcfg, jparams, MAX_LEN)
        batch = {"tokens": jnp.asarray(self.gen_prompt)}
        self.greedy = np.asarray(eng.generate(batch, N_GEN))
        chunk = jax.jit(jengine.make_decode_chunk(self.jcfg), static_argnums=(5,))
        _, cache = eng._prefill(jparams, batch)
        toks, lps, cache = chunk(jparams, cache, jnp.asarray(self.greedy[:, :1]), jax.random.PRNGKey(7),
                                 jnp.float32(0.0), CHUNK)
        self.chunk = (np.asarray(toks), np.asarray(lps), _leaves(cache))


@pytest.fixture(scope="module", params=[12, 8], ids=["12 layers", "8 layers"])
def ref(request):
    return _Ref(request.param)


# ------------------------------------------------------------------- config


def test_config_is_repro_s():
    from repro.configs import get_config as j_get_config

    cfg = get_config("gemma3-27b")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_get_config("gemma3-27b"))
    for seq in (16, 64):
        assert (dataclasses.asdict(reduced(cfg, seq=seq))
                == dataclasses.asdict(j_reduced(J_ARCHS["gemma3-27b"], seq=seq)))
    assert cfg.param_count() == J_ARCHS["gemma3-27b"].param_count()
    assert (cfg.sliding_window, cfg.tie_embeddings, cfg.num_periods, cfg.remainder_specs) == (
        1024, True, 10, (LayerSpec("local", "dense"),) * 2)
    assert set(lm.param_defs(cfg)["embed"]) == {"embedding"}  # tied: no unembedding
    Model(cfg)


def test_init_tree_matches_repro_s():
    jcfg, cfg = _cfgs(8)
    got = lm.param_defs(cfg)
    want = JModel(jcfg).param_defs()
    flat = lambda t: sorted((tuple(str(k) for k in path), tuple(x.shape))
                            for path, x in jax.tree_util.tree_flatten_with_path(
                                t, is_leaf=lambda x: hasattr(x, "shape"))[0])
    assert flat(got) == flat(want)


# ---------------------------------------------------------------- attention


def _qkv(S, nq, nkv=2, D=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((2, S, h, D)).astype(np.float32) for h in (nq, nkv, nkv))


@pytest.mark.parametrize("nq", [4, 8], ids=["group 2", "group 4"])
@pytest.mark.parametrize("S", [5, 8, 12, 16, 24, 40])
def test_local_attention_matches_repro(S, nq):
    """S < w, w ≤ S ≤ 2w (the masked full path) and S > 2w (the blocked one)."""
    q, k, v = _qkv(S, nq)
    want = np.asarray(jax.jit(jattn.local_attention, static_argnames="window")(
        *map(jnp.asarray, (q, k, v)), window=W))
    got = attn.local_attention(*map(torch.from_numpy, (q, k, v)), window=W)
    _close(got, want)
    full = attn.full_attention(*map(torch.from_numpy, (q, k, v)), causal=True, window=W)
    _close(got, full.numpy())  # the blocked path is the masked full one


def test_local_attention_refuses_a_ragged_last_block():
    q, k, v = _qkv(20, 4)  # 20 > 2w and not a multiple of w: repro asserts
    with pytest.raises(AssertionError):
        jattn.local_attention(*map(jnp.asarray, (q, k, v)), window=W)
    with pytest.raises(ValueError, match="multiple of the window"):
        attn.local_attention(*map(torch.from_numpy, (q, k, v)), window=W)


@pytest.mark.parametrize("q_offset,window", [(0, 0), (5, 0), (5, 4), (0, 3)])
def test_full_attention_offset_and_window_match_repro(q_offset, window):
    q, k, v = _qkv(9, 4)
    kf = np.concatenate([k, k[:, :5]], 1)  # Sk = 14 keys for 9 queries
    vf = np.concatenate([v, v[:, :5]], 1)
    want = jax.jit(jattn.full_attention, static_argnames=("q_offset", "window"))(
        *map(jnp.asarray, (q, kf, vf)), q_offset=q_offset, window=window)
    got = attn.full_attention(*map(torch.from_numpy, (q, kf, vf)), q_offset=q_offset, window=window)
    _close(got, np.asarray(want))


@pytest.mark.parametrize("cache_len", [3, 8, 13, 29])
def test_ring_decode_attention_matches_repro(cache_len):
    """Below w only the written slots, from w on the whole ring."""
    rng = np.random.default_rng(cache_len)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, W, 2, 16)).astype(np.float32) for _ in range(2))
    want = jax.jit(jattn.decode_attention, static_argnames="ring")(
        *map(jnp.asarray, (q, kc, vc)), jnp.int32(cache_len), ring=True)
    got = attn.decode_attention(*map(torch.from_numpy, (q, kc, vc)), cache_len, ring=True)
    _close(got, np.asarray(want))


def test_local_layers_never_take_the_flash_op(monkeypatch):
    """``repro``'s dispatch order: the local branch first, whatever
    ``attn_impl`` and ``kv_len`` say; the global layers take flash."""
    cfg = dataclasses.replace(_cfgs()[1], attn_impl="flash")
    calls = []
    monkeypatch.setattr(attn, "flash_attention", lambda *a, **kw: calls.append("flash"))
    monkeypatch.setattr(attn, "local_attention", lambda *a, **kw: calls.append("local"))
    q, k, v = map(torch.from_numpy, _qkv(24, 4))
    kv_len = torch.tensor([24, 17])
    attn.dispatch_attention(cfg, q, k, v, mixer="local", causal=True, kv_len=kv_len)
    attn.dispatch_attention(cfg, q, k, v, mixer="attn", causal=True, kv_len=kv_len)
    assert calls == ["local", "flash"]


# ------------------------------------------------------------------ serving


def test_prefill_cache_matches_repro(ref):
    """Below w the first S slots, from w on the last w keys rolled to slot =
    pos mod w, every leaf as ``repro`` leaves it (S = 5, 24 at 12 layers;
    8, 12 at 8, whose (L, L) remainder holds rings too)."""
    for S, ((want_lg, want), *_) in ref.decode.items():
        toks = torch.from_numpy(ref.prompts[S][:, :S])
        lg, cache = Model(ref.cfg).prefill(ref.params, {"tokens": toks}, MAX_LEN)
        _close(lg, want_lg, scaled=True)
        got = _leaves(cache)
        assert [g.shape for g in got] == [w.shape for w in want]
        assert cache["layers"][0]["k"].shape[2] == W and cache["layers"][5]["k"].shape[2] == MAX_LEN
        for g, w in zip(got, want):
            _close(g, w)


def test_teacher_forced_decode_across_the_wrap_matches_repro(ref):
    """Logits and every cache leaf at every step, decoding past position w
    (and 2w, 4w) with ``max_len`` > w: the cap comes from a global layer."""
    model = Model(ref.cfg)
    for S, want in ref.decode.items():
        toks = ref.prompts[S]
        lg, cache = model.prefill(ref.params, {"tokens": torch.from_numpy(toks[:, :S])}, MAX_LEN)
        for j, (want_lg, want_cache) in enumerate(want):
            if j:
                lg, cache = model.decode_step(ref.params, cache, torch.from_numpy(toks[:, S + j - 1:S + j]))
            _close(lg, want_lg, scaled=True)
            for g, w in zip(_leaves(cache), want_cache):
                _close(g, w)
        assert int(cache["len"]) == toks.shape[1] > 4 * W


@pytest.mark.parametrize("case", ["global layers", "local layers only", "2 layers"])
def test_decode_cap_comes_from_a_global_layer(case):
    """A full global cache raises. A model without a global layer that runs
    has no cap: local layers only, and gemma3 at 2 layers, the (L, L)
    remainder alone (its pattern, global layer included, runs no period),
    which decodes past ``max_len`` round the ring as ``repro`` does."""
    prompt, steps = _tokens(10 + W + 3, seed=4), range(10, 10 + W + 3)  # past max_len, round the ring
    if case == "global layers":
        _, cfg = _cfgs(8)
        params = _params(8)[1]
        _, cache = Model(cfg).prefill(params, {"tokens": torch.from_numpy(prompt[:, :10])}, 10)
        with pytest.raises(ValueError, match="holds 10 tokens"):
            Model(cfg).decode_step(params, cache, torch.ones((B, 1), dtype=torch.int32))
        return
    if case == "local layers only":
        cfg = dataclasses.replace(_cfgs(8)[1], pattern=(LayerSpec("local", "dense"),), num_layers=2)
        params, want = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu"), None
    else:
        jcfg, cfg = _cfgs(2)
        jparams, params = _params(2)
        assert cfg.num_periods == 0 and cfg.remainder_specs == (LayerSpec("local", "dense"),) * 2
        jm = JModel(jcfg)
        _, jcache = jax.jit(jm.prefill, static_argnums=(2,))(jparams, {"tokens": jnp.asarray(prompt[:, :10])}, 10)
        step, want = jax.jit(jm.decode_step), []
        for j in steps:
            lg, jcache = step(jparams, jcache, jnp.asarray(prompt[:, j:j + 1]))
            want.append(np.asarray(lg))
    model = Model(cfg)
    _, cache = model.prefill(params, {"tokens": torch.from_numpy(prompt[:, :10])}, 10)
    for i, j in enumerate(steps):
        lg, cache = model.decode_step(params, cache, torch.from_numpy(prompt[:, j:j + 1]))
        if want is not None:
            _close(lg, want[i], scaled=True)
    assert int(cache["len"]) == 10 + W + 3 and bool(torch.isfinite(lg).all())


def test_greedy_generate_matches_repro(ref):
    eng = engine.ServeEngine(ref.cfg, ref.params, MAX_LEN, device="cpu")
    got = eng.generate({"tokens": torch.from_numpy(ref.gen_prompt)}, N_GEN)
    np.testing.assert_array_equal(got.numpy(), ref.greedy)


def test_decode_chunk_matches_repro(ref):
    model = Model(ref.cfg)
    _, cache = model.prefill(ref.params, {"tokens": torch.from_numpy(ref.gen_prompt)}, MAX_LEN)
    chunk = engine.make_decode_chunk(ref.cfg)
    toks, lps, cache = chunk(ref.params, cache, torch.from_numpy(ref.greedy[:, :1]), torch.Generator(),
                             0.0, CHUNK)
    want_toks, want_lps, want_cache = ref.chunk
    np.testing.assert_array_equal(toks.numpy(), want_toks)
    _close(lps, want_lps)
    for g, w in zip(_leaves(cache), want_cache):
        _close(g, w)


# ----------------------------------------------------------------- explaining


@functools.cache
def _explained(fused: bool):
    """``repro``'s engine on the traffic, once per ``fused``."""
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(1, 512, s).astype(np.int32), int(rng.integers(0, 512))) for s in LENS]
    jeng = JEngine(_cfgs(8)[0], _params(8)[0], fused=fused, **EXPLAIN_KW)
    return reqs, jeng.explain([JRequest(t, g) for t, g in reqs])


@pytest.mark.parametrize("kw", [dict(fused=False), dict(fused=True), dict(attn="flash")],
                         ids=["unfused", "fused", "flash"])
def test_explain_engine_matches_repro(kw, monkeypatch):
    """``ig`` at bucket 16 (the windowed full path) and 32 (the blocked
    path); with ``attn="flash"`` the global layers take the flash op (its
    plain version here) and the local layers do not."""
    reqs, want = _explained(kw.get("fused", False))
    calls = []
    flash = attn.flash_attention
    monkeypatch.setattr(attn, "flash_attention", lambda *a, **k: calls.append(1) or flash(*a, **k))
    _, cfg = _cfgs(8)
    eng = ExplainEngine(cfg, _params(8)[1], device="cpu", **EXPLAIN_KW, **kw)
    got = eng.explain([ExplainRequest(t, g) for t, g in reqs])
    assert sorted(eng.stats.buckets) == [(2, 16), (2, 32)]
    for g, w in zip(got, want):
        assert g["bucket"] == w["bucket"] and g["token_scores"].shape == w["token_scores"].shape
        _close(g["token_scores"], w["token_scores"], scaled=True)
        for k in ("f_x", "f_baseline"):
            assert abs(g[k] - w[k]) <= TOL, (k, g[k], w[k])
        assert abs(g["delta"] - w["delta"]) <= 1e-6 + 1e-4 * abs(w["f_x"] - w["f_baseline"])
    if kw.get("attn") == "flash":
        assert calls  # the global layer, never the 7 local ones
    else:
        assert not calls


# ---------------------------------------------------------------- scheduler


def _final_cache(monkeypatch):
    """Record the cache ``lm.decode_step`` returns last (its tensors are the
    scheduler's, written in place)."""
    seen, real = {}, lm.decode_step

    def step(*a, **kw):
        out = real(*a, **kw)
        seen["cache"] = out[1]
        return out

    monkeypatch.setattr(lm, "decode_step", step)
    return seen


def _retried_run(monkeypatch, fault: bool):
    """One greedy generate of 6 + 14 tokens through a scheduler with chunks
    of 3 (the chunk from position 9 starts past the wrap); with ``fault``,
    that chunk raises at its third ``decode_step``, once, after two steps
    wrote slots 1 and 2 of every ring. Returns (tokens, ring leaves)."""
    _, cfg = _cfgs(8)
    eng = ExplainEngine(cfg, _params(8)[1], device="cpu", method="ig", m=4, n_int=2, seq_buckets=(16,))
    sched = MixedScheduler(eng, max_len=32, decode_chunk=3,
                           fault_cfg=FaultConfig(max_retries=1, backoff_base_s=0.0))
    seen = _final_cache(monkeypatch)
    state = {"calls": None, "fired": 0}
    step = lm.decode_step

    def faulty(*a, **kw):
        if state["calls"] is not None:
            state["calls"] += 1
            if state["calls"] == 3:
                state["calls"] = None
                state["fired"] += 1
                raise RuntimeError("injected fault inside a decode chunk")
        return step(*a, **kw)

    def hook(kind, payload):
        if fault and kind == "decode" and int(payload.cache["len"]) >= W + 1 and not state["fired"] \
                and state["calls"] is None:
            state["calls"] = 0

    monkeypatch.setattr(lm, "decode_step", faulty)
    sched.fault_hook = hook
    t = sched.submit(GenerateRequest(tokens=_tokens(6, seed=9, n=1)[0], num_tokens=14))
    sched.run_until_idle()
    assert t.status == "done" and not t.degraded and eng.stats.degraded == 0
    assert state["fired"] == int(fault)
    rings = [np.asarray(x) for spec, lc in lm._per_layer(cfg, seen["cache"])
             if spec.mixer == "local" for x in (lc["k"], lc["v"])]
    return t.tokens, rings


def test_scheduler_retry_inside_a_chunk_is_exact_on_the_ring(monkeypatch):
    clean_toks, clean_rings = _retried_run(monkeypatch, fault=False)
    monkeypatch.undo()
    toks, rings = _retried_run(monkeypatch, fault=True)
    np.testing.assert_array_equal(toks, clean_toks)
    for g, w in zip(rings, clean_rings):
        np.testing.assert_array_equal(g, w)


def test_scheduler_retry_without_the_ring_snapshot_is_not_exact(monkeypatch):
    """The same fault with the rings' snapshot saving nothing (the length
    is still restored): the retried steps attend to keys of later positions,
    so the rings come out other."""
    clean_toks, clean_rings = _retried_run(monkeypatch, fault=False)
    monkeypatch.undo()
    monkeypatch.setattr(blocks, "decode_snapshot", lambda *a, **kw: lambda: None)
    toks, rings = _retried_run(monkeypatch, fault=True)
    assert not all(np.array_equal(g, w) for g, w in zip(rings, clean_rings))
