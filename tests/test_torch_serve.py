"""The port's generation serving against ``repro``'s, on the CPU.

Five configs at f32 compute: ``reduced(...)`` of llama3-8b, internlm2-20b
and yi-9b (4 heads on 2), and two narrow ones with the real GQA groups of
the new archs: 12 heads on 2 (6 a group, d=96) and 8 on 1 (8 a group,
d=64), head dim 16, 2 layers. Weights come from ``repro``'s seeded
``Model(cfg).init`` through ``params_from_numpy``; prompts from numpy with
a fixed seed. Each config's ``repro`` reference runs once, in a
module-scoped fixture, through its own jitted entry points (``ServeEngine``,
``Model.decode_step``, ``make_decode_chunk``).

Sampling: ``repro`` folds its key per step, the port draws from one
generator, so the sampled tests hand the port ``repro``'s own Gumbel noise
(``jax.random.gumbel`` of each step's folded key, through numpy) in the
order the port draws it: the prefill token's, then step 0, 1, ….

Tolerances: logits, cache leaves and log-probabilities 1e-5 absolute (f32
products summed in another order); token ids exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS, get_config as j_get_config, reduced as j_reduced
from repro.models import attention as jattn
from repro.models.registry import Model as JModel
from repro.serve import engine as jengine
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.models import attention as attn, lm
from repro_torch.models.registry import Model
from repro_torch.serve import engine

torch.set_num_threads(1)

B, S, MAX_LEN, N_NEW, N_FORCED, TEMP = 2, 12, 16, 5, 4, 0.8  # S + N_NEW − 1 == MAX_LEN
# name -> (arch, changes to its reduced form)
CONFIGS = {
    "llama3-8b": ("llama3-8b", {}),
    "internlm2-20b": ("internlm2-20b", {}),
    "yi-9b": ("yi-9b", {}),
    "gqa6": ("internlm2-20b", dict(num_heads=12, num_kv_heads=2, d_model=96)),
    "gqa8": ("yi-9b", dict(num_heads=8, num_kv_heads=1, d_model=64)),
}
NAMES = list(CONFIGS)


def _cfgs(name):
    arch, changes = CONFIGS[name]
    kw = dict(changes, compute_dtype="float32")
    return (dataclasses.replace(j_reduced(J_ARCHS[arch]), **kw),
            dataclasses.replace(reduced(ARCHS[arch]), **kw))


def _leaves(tree):
    """A cache tree's arrays in a fixed order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def _noise(key, n_steps, vocab, prefill=True):
    """``repro``'s Gumbel noise in the port's draw order."""
    folds = ([2**32 - 1] if prefill else []) + list(range(n_steps))
    return [np.asarray(jax.random.gumbel(jax.random.fold_in(key, k), (B, vocab), jnp.float32))
            for k in folds]


class _Ref:
    """One config's ``repro`` reference, run once."""

    def __init__(self, name):
        self.jcfg, self.cfg = _cfgs(name)
        jparams = JModel(self.jcfg).init(jax.random.PRNGKey(0))
        self.params = lm.params_from_numpy(jparams, device="cpu")
        rng = np.random.default_rng(1)
        V = self.jcfg.vocab_size
        self.tokens = rng.integers(1, V, (B, S)).astype(np.int32)
        self.forced = rng.integers(1, V, (B, N_FORCED)).astype(np.int32)
        batch = {"tokens": jnp.asarray(self.tokens)}
        eng = jengine.ServeEngine(self.jcfg, jparams, MAX_LEN)
        logits, cache = eng._prefill(jparams, batch)
        self.prefill = (np.asarray(logits), _leaves(cache))
        step = jax.jit(JModel(self.jcfg).decode_step)
        self.decode = []
        for j in range(N_FORCED):
            logits, cache = step(jparams, cache, jnp.asarray(self.forced[:, j:j + 1]))
            self.decode.append((np.asarray(logits), _leaves(cache)))
        self.greedy = {n: np.asarray(eng.generate(batch, n)) for n in (0, 1, N_NEW)}
        key = jax.random.PRNGKey(7)
        self.sampled = np.asarray(eng.generate(batch, N_NEW, key=key, temperature=TEMP))
        self.sample_noise = _noise(key, N_NEW - 1, V)
        chunk = jax.jit(jengine.make_decode_chunk(self.jcfg), static_argnums=(5,))
        first = jnp.asarray(self.greedy[1])
        self.chunk = {}
        for temp in (0.0, TEMP):
            _, cache = eng._prefill(jparams, batch)
            toks, lps, _ = chunk(jparams, cache, first, key, jnp.float32(temp), N_FORCED)
            self.chunk[temp] = (np.asarray(toks), np.asarray(lps))
        self.chunk_noise = _noise(key, N_FORCED, V, prefill=False)


@pytest.fixture(scope="module", params=NAMES)
def ref(request):
    return _Ref(request.param)


@pytest.fixture
def shared_noise(monkeypatch):
    """Make the port's ``engine.gumbel`` return the given arrays in turn."""

    def use(arrays):
        queue = list(arrays)

        def draw(generator, shape, device):
            a = torch.from_numpy(np.array(queue.pop(0))).to(device)
            assert tuple(a.shape) == tuple(shape)
            return a

        monkeypatch.setattr(engine, "gumbel", draw)
        return queue

    return use


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), want, rtol=0, atol=tol)


def test_prefill_matches_repro(ref):
    logits, cache = Model(ref.cfg).prefill(ref.params, {"tokens": torch.from_numpy(ref.tokens)},
                                           MAX_LEN)
    want_logits, want_cache = ref.prefill
    assert logits.shape == want_logits.shape
    _close(logits, want_logits)
    got = _leaves(cache)
    assert [g.shape for g in got] == [w.shape for w in want_cache]
    for g, w in zip(got, want_cache):
        _close(g, w)


def test_flash_prefill_matches_repro(ref):
    """The flash op's plain version in the prefill against ``repro``'s
    full attention."""
    cfg = dataclasses.replace(ref.cfg, attn_impl="flash")
    logits, cache = Model(cfg).prefill(ref.params, {"tokens": torch.from_numpy(ref.tokens)},
                                       MAX_LEN)
    _close(logits, ref.prefill[0])
    for g, w in zip(_leaves(cache), ref.prefill[1]):
        _close(g, w)


def test_teacher_forced_decode_matches_repro(ref):
    model = Model(ref.cfg)
    _, cache = model.prefill(ref.params, {"tokens": torch.from_numpy(ref.tokens)}, MAX_LEN)
    for j, (want_logits, want_cache) in enumerate(ref.decode):
        logits, cache = model.decode_step(ref.params, cache,
                                          torch.from_numpy(ref.forced[:, j:j + 1]))
        _close(logits, want_logits)
        for g, w in zip(_leaves(cache), want_cache):
            _close(g, w)
    assert int(cache["len"]) == S + N_FORCED


@pytest.mark.parametrize("n", [0, 1, N_NEW])
def test_greedy_generate_matches_repro(ref, n):
    eng = engine.ServeEngine(ref.cfg, ref.params, MAX_LEN, device="cpu")
    got = eng.generate({"tokens": torch.from_numpy(ref.tokens)}, n)
    assert got.dtype == torch.int32 and got.shape == (B, max(n, 0))
    np.testing.assert_array_equal(got.numpy(), ref.greedy[n])


def test_sampled_generate_matches_repro_on_shared_noise(ref, shared_noise):
    left = shared_noise(ref.sample_noise)
    eng = engine.ServeEngine(ref.cfg, ref.params, MAX_LEN, device="cpu")
    got = eng.generate({"tokens": torch.from_numpy(ref.tokens)}, N_NEW,
                       generator=torch.Generator(), temperature=TEMP)
    assert not left  # one draw for the prefill token and one a step
    np.testing.assert_array_equal(got.numpy(), ref.sampled)
    assert not np.array_equal(ref.sampled, ref.greedy[N_NEW])  # the noise mattered


@pytest.mark.parametrize("temp", [0.0, TEMP])
def test_decode_chunk_matches_repro(ref, shared_noise, temp):
    shared_noise(ref.chunk_noise)
    model = Model(ref.cfg)
    _, cache = model.prefill(ref.params, {"tokens": torch.from_numpy(ref.tokens)}, MAX_LEN)
    chunk = engine.make_decode_chunk(ref.cfg)
    toks, lps, cache = chunk(ref.params, cache, torch.from_numpy(ref.greedy[1]),
                             torch.Generator(), temp, N_FORCED)
    want_toks, want_lps = ref.chunk[temp]
    assert toks.dtype == torch.int32 and lps.dtype == torch.float32
    np.testing.assert_array_equal(toks.numpy(), want_toks)
    _close(lps, want_lps)
    assert int(cache["len"]) == S + N_FORCED


# ------------------------------------------------------------ port-only semantics


@pytest.fixture(scope="module")
def small():
    cfg = dataclasses.replace(reduced(ARCHS["llama3-8b"]), compute_dtype="float32")
    params = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(1, 512, (B, S)).astype(np.int32))
    return cfg, params, tokens


def test_sampling_follows_the_generator_seed(small):
    cfg, params, tokens = small
    eng = engine.ServeEngine(cfg, params, 40, device="cpu")
    draw = lambda seed: eng.generate({"tokens": tokens}, 24,
                                     generator=torch.Generator().manual_seed(seed), temperature=TEMP)
    a, b, c = draw(1234), draw(1234), draw(1235)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size


@pytest.mark.parametrize("what", ["prefill", "generate", "decode_step", "temperature"])
def test_limits_raise(small, what):
    cfg, params, tokens = small
    model = Model(cfg)
    eng = engine.ServeEngine(cfg, params, MAX_LEN, device="cpu")
    with pytest.raises(ValueError):
        if what == "prefill":
            model.prefill(params, {"tokens": tokens}, S - 1)
        elif what == "generate":
            eng.generate({"tokens": tokens}, MAX_LEN - S + 2)
        elif what == "decode_step":
            _, cache = model.prefill(params, {"tokens": tokens}, S)
            model.decode_step(params, cache, tokens[:, :1])
        else:
            eng.generate({"tokens": tokens}, 2, generator=torch.Generator(), temperature=0.0)


def test_cache_is_written_in_place(small):
    cfg, params, tokens = small
    model = Model(cfg)
    _, cache = model.prefill(params, {"tokens": tokens}, MAX_LEN)
    k = cache["layers"][0]["k"]
    assert k.shape == (cfg.num_periods, B, MAX_LEN, cfg.num_kv_heads, cfg.resolved_head_dim)
    assert not k[:, :, S:].any()
    _, new = model.decode_step(params, cache, tokens[:, :1])
    assert new["layers"][0]["k"] is k and k[:, :, S].any() and not k[:, :, S + 1:].any()
    assert cache["len"].dtype == torch.int32 and int(new["len"]) == S + 1


# ------------------------------------------------------------------- attention


def _qkv(rng, Bq, Sq, Sk, NQ, NKV, D):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(Bq, Sq, NQ, D), f(Bq, Sk, NKV, D), f(Bq, Sk, NKV, D)


@pytest.mark.parametrize("cache_len", [1, 7, 16])
@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("NQ,NKV", [(4, 2), (6, 1), (8, 1)])
def test_decode_attention_matches_repro(cache_len, window, NQ, NKV):
    q, k, v = _qkv(np.random.default_rng(cache_len), 2, 1, 16, NQ, NKV, 16)
    want = jattn.decode_attention(q, k, v, jnp.int32(cache_len), window=window)
    got = attn.decode_attention(*map(torch.from_numpy, (q, k, v)), cache_len, window=window)
    _close(got, np.asarray(want))
    got_t = attn.decode_attention(*map(torch.from_numpy, (q, k, v)), torch.tensor(cache_len),
                                  window=window)
    assert torch.equal(got_t, got)


def test_decode_attention_ring_is_not_ported():
    """The ring branch (a local layer's cache of 8 slots) against ``repro``'s:
    below 8 only the written slots are valid, from 8 on the whole ring."""
    q, k, v = _qkv(np.random.default_rng(0), 1, 1, 8, 4, 2, 16)
    for cache_len in (4, 8, 21):
        want = jattn.decode_attention(q, k, v, jnp.int32(cache_len), ring=True)
        got = attn.decode_attention(*map(torch.from_numpy, (q, k, v)), cache_len, ring=True)
        _close(got, np.asarray(want))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("NQ,NKV", [(4, 2), (8, 1)])
def test_blocked_attention_matches_repro_and_full(causal, NQ, NKV):
    q, k, v = _qkv(np.random.default_rng(3), 2, 64, 64, NQ, NKV, 16)
    want = jattn.blocked_attention(q, k, v, causal=causal, block_q=16, block_k=16)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = attn.blocked_attention(tq, tk, tv, causal=causal, block_q=16, block_k=16)
    _close(got, np.asarray(want))
    _close(got, attn.full_attention(tq, tk, tv, causal=causal).numpy())


def test_dispatch_takes_the_blocked_branch_as_repro(monkeypatch):
    """Above 4096 unmasked tokens both packages take their blocked path."""
    S = attn.BLOCK_THRESHOLD + 1024
    q, k, v = _qkv(np.random.default_rng(4), 1, S, S, 4, 2, 8)
    jcfg, cfg = _cfgs("llama3-8b")
    want = jattn.dispatch_attention(jcfg, q, k, v, mixer="attn", causal=True)
    calls = []
    blocked = attn.blocked_attention
    monkeypatch.setattr(attn, "blocked_attention", lambda *a, **kw: calls.append(1) or blocked(*a, **kw))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = attn.dispatch_attention(cfg, tq, tk, tv, mixer="attn", causal=True)
    assert calls == [1]
    _close(got, np.asarray(want))
    with pytest.raises(ValueError):  # repro asserts whole blocks
        attn.blocked_attention(tq, tk, tv, block_q=24, block_k=24)


# --------------------------------------------------------------------- configs


@pytest.mark.parametrize("name", ["llama3-8b", "internlm2-20b", "yi-9b", "gemma3-27b"])
def test_get_config_is_repro_s(name):
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(j_get_config(name))
    assert get_config(name) is ARCHS[name]
    Model(get_config(name))  # the LM builds it


def test_get_config_knows_only_the_port_s_archs():
    assert set(ARCHS) == {"llama3-8b", "internlm2-20b", "yi-9b", "gemma3-27b", "qwen3-moe-30b-a3b",
                          "qwen3-moe-235b-a22b", "mamba2-780m", "jamba-v0.1-52b"}
    for name in ("paper-cnn", "vit-s16", "whisper-tiny", "internvl2-26b", "nope"):
        with pytest.raises(KeyError):
            get_config(name)
