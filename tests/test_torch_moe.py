"""The port's mixture-of-experts FFN and the MoE LMs (qwen3-moe-30b-a3b,
qwen3-moe-235b-a22b) against ``repro`` on the CPU.

Configs are ``reduced(ARCHS[...])`` at f32 compute: 8 experts top-2 of
width 32, d=64, 4 query heads on 2, 2 layers. Weights come from
``repro``'s seeded ``Model(cfg).init`` (jitted) through ``params_from_numpy``,
inputs from numpy with fixed seeds. Each config's ``repro`` serving
reference (prefill, teacher-forced decode, ``ServeEngine`` greedy) and the
``ExplainEngine`` ``ig`` reference run once, in module fixtures.

Tolerances (f32 products summed in another order): the MoE output, its
input gradient and the aux loss within 1e-5 absolute (the largest errors
measured here: 1.5e-8 on outputs up to 0.095, 2.2e-8 on gradients, 0);
logits, cache leaves, f(x), f(x′) and token scores within 1e-5 of the
larger of 1 and the largest |value| (measured: 9.5e-7 on logits up to
3.9, 9.5e-7 on f(x) up to 8.0, 9.2e-6 on jamba's scores up to 9.0); δ
within 1e-6 plus 1e-4 of |f(x) − f(x′)| (measured: 1.2e-5); the dropped
set and token ids exactly.

Capacity is sized from all the tokens of a call, as in ``repro``
(``models/moe.py`` ``capacity``): the packages are compared at the same
bucket composition and chunk only.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS, reduced as j_reduced
from repro.models import moe as jmoe
from repro.models.common import init_params as j_init_params
from repro.models.registry import Model as JModel
from repro.serve import ExplainEngine as JEngine, ExplainRequest as JRequest
from repro.serve import engine as jengine
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.models import lm, moe
from repro_torch.models.common import params_from_numpy
from repro_torch.models.registry import Model
from repro_torch.serve import ExplainEngine, ExplainRequest
from repro_torch.serve import engine

torch.set_num_threads(1)

NAMES = ("qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b")
B, PROMPT, MAX_LEN, N_GEN = 2, 12, 32, 8
TOL = 1e-5
LENS = (11, 16, 21, 32)  # explain traffic: buckets 16 and 32
EXPLAIN_KW = dict(method="ig", m=8, n_int=4, seq_buckets=(16, 32))


def _cfgs(name="qwen3-moe-30b-a3b", **kw):
    kw = dict(compute_dtype="float32", **kw)
    return (dataclasses.replace(j_reduced(J_ARCHS[name]), **kw),
            dataclasses.replace(reduced(ARCHS[name]), **kw))


@functools.cache
def _params(name, layers=2):
    jparams = jax.jit(JModel(_cfgs(name, num_layers=layers)[0]).init)(jax.random.PRNGKey(0))
    return jparams, lm.params_from_numpy(jparams, device="cpu")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def _close(got, want, scaled=False):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if scaled and want.size else 1.0
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), want, rtol=0, atol=TOL * scale)


def _tokens(S, seed=1, n=B):
    return np.random.default_rng(seed).integers(1, 512, (n, S)).astype(np.int32)


# --------------------------------------------------------------- the layer


@functools.cache
def _layer(capacity_factor):
    """A reduced qwen3 MoE layer's weights (``repro``'s init) and an input."""
    jcfg, cfg = _cfgs(capacity_factor=capacity_factor)
    jp = j_init_params(jax.random.PRNGKey(3), jmoe.moe_def(jcfg))
    x = np.random.default_rng(4).standard_normal((3, 24, jcfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, params_from_numpy(jp, device="cpu"), x


def _repro_dropped(jp, x, cfg):
    """The (token, choice) pairs ``repro``'s ``moe`` drops, by its own
    routing steps (``src/repro/models/moe.py:41-64``) in JAX."""
    T, k = x.shape[0] * x.shape[1], cfg.experts_per_tok
    xt = jnp.asarray(x).reshape(T, -1)
    probs = jax.nn.softmax(xt @ jp["router"], axis=-1)
    _, eid = jax.lax.top_k(probs, k)
    flat_e = eid.reshape(-1)
    order = jnp.argsort(flat_e)
    se = flat_e[order]
    counts = jnp.zeros((cfg.num_experts,), jnp.int32).at[flat_e].add(1)
    starts = jnp.cumsum(counts) - counts
    rank = jnp.arange(T * k) - starts[se]
    keep = np.zeros(T * k, bool)
    keep[np.asarray(order)] = np.asarray(rank < jmoe.capacity(T, cfg))
    return ~keep.reshape(T, k)


@pytest.mark.parametrize("factor", [1.25, 0.25], ids=["factor 1.25", "factor 0.25 (drops)"])
def test_moe_matches_repro(factor):
    jcfg, cfg, jp, p, x = _layer(factor)
    want_y, want_aux = jax.jit(jmoe.moe, static_argnums=2)(jp, jnp.asarray(x), jcfg)
    y, aux = moe.moe(p, torch.from_numpy(x), cfg)
    _close(y, want_y)
    _close(aux, want_aux)
    T = x.shape[0] * x.shape[1]
    r = moe.route(p["router"], torch.from_numpy(x).reshape(T, -1), cfg)
    dropped = _repro_dropped(jp, x, jcfg)
    np.testing.assert_array_equal(~r.keep.numpy(), dropped)
    assert r.C == jmoe.capacity(T, jcfg)
    if factor < 1:
        assert 0.3 < dropped.mean() < 1  # the capacity drops a good share
    # each kept choice sits in its own slot, and that slot names it back
    slots = r.slot[r.keep]
    assert len(set(slots.tolist())) == len(slots) == int(r.filled.sum())
    assert torch.equal(r.slot_choice[slots], torch.nonzero(r.keep.reshape(-1))[:, 0])


@pytest.mark.parametrize("factor", [1.25, 0.25], ids=["factor 1.25", "factor 0.25 (drops)"])
def test_moe_input_gradient_matches_jax(factor):
    """Through the router's gates and the gathers of dispatch and combine."""
    jcfg, cfg, jp, p, x = _layer(factor)
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jmoe.moe(jp, v, jcfg)[0] * w))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (moe.moe(p, xt, cfg)[0] * torch.from_numpy(w)).sum().backward()
    _close(xt.grad, want)


def test_moe_repeats_bit_for_bit():
    jcfg, cfg, jp, p, x = _layer(0.25)
    outs = []
    for _ in range(2):
        xt = torch.from_numpy(x).requires_grad_()
        y, _ = moe.moe(p, xt, cfg)
        y.square().sum().backward()
        outs.append((y.detach(), xt.grad))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_capacity_matches_repro():
    jcfg, cfg = _cfgs()
    for T in (1, 7, 64, 100, 1000):
        assert moe.capacity(T, cfg) == jmoe.capacity(T, jcfg)
    full = get_config("qwen3-moe-30b-a3b")
    assert moe.capacity(16 * 16 * 128, full) == jmoe.capacity(16 * 16 * 128, J_ARCHS[full.name]) == 2560


# ---------------------------------------------------------------- serving


class _Ref:
    """One config's ``repro`` serving reference, run once."""

    def __init__(self, name):
        self.jcfg, self.cfg = _cfgs(name)
        jparams, self.params = _params(name)
        jm = JModel(self.jcfg)
        self.toks = _tokens(PROMPT + 6, seed=2)
        logits, cache = jax.jit(jm.prefill, static_argnums=(2,))(
            jparams, {"tokens": jnp.asarray(self.toks[:, :PROMPT])}, MAX_LEN)
        self.decode = [(np.asarray(logits), _leaves(cache))]
        step = jax.jit(jm.decode_step)
        for j in range(PROMPT, self.toks.shape[1]):
            logits, cache = step(jparams, cache, jnp.asarray(self.toks[:, j:j + 1]))
            self.decode.append((np.asarray(logits), _leaves(cache)))
        eng = jengine.ServeEngine(self.jcfg, jparams, MAX_LEN)
        self.greedy = np.asarray(eng.generate({"tokens": jnp.asarray(self.toks[:, :PROMPT])}, N_GEN))


@pytest.fixture(scope="module", params=NAMES)
def ref(request):
    return _Ref(request.param)


def test_teacher_forced_decode_matches_repro(ref):
    """Prefill's logits and cache, then six decode steps (one token a row:
    no choice is dropped there), logits and every cache leaf each step."""
    model = Model(ref.cfg)
    lg, cache = model.prefill(ref.params, {"tokens": torch.from_numpy(ref.toks[:, :PROMPT])}, MAX_LEN)
    for j, (want_lg, want_cache) in enumerate(ref.decode):
        if j:
            lg, cache = model.decode_step(ref.params, cache,
                                          torch.from_numpy(ref.toks[:, PROMPT + j - 1:PROMPT + j]))
        _close(lg, want_lg, scaled=True)
        got = _leaves(cache)
        assert [g.shape for g in got] == [w.shape for w in want_cache]
        for g, w in zip(got, want_cache):
            _close(g, w)


def test_greedy_generate_matches_repro(ref):
    eng = engine.ServeEngine(ref.cfg, ref.params, MAX_LEN, device="cpu")
    got = eng.generate({"tokens": torch.from_numpy(ref.toks[:, :PROMPT])}, N_GEN)
    np.testing.assert_array_equal(got.numpy(), ref.greedy)


# ----------------------------------------------------------------- explaining


# (config, layers, fused, request lengths), buckets: qwen3 at 16 and 32; jamba at 5 layers
# (no whole period: M_D M_E M_D M_E A_D) at 32, two SSD chunks. The fused path is held to
# repro's on mamba2 (test_torch_ssm.py).
EXPLAINED = {"qwen3": (("qwen3-moe-30b-a3b", 2, False, LENS), [(2, 16), (2, 32)]),
             "jamba 5 layers": (("jamba-v0.1-52b", 5, False, (21, 32)), [(2, 32)])}


@functools.cache
def _explained(name, layers, fused, lens):
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(1, 512, s).astype(np.int32), int(rng.integers(0, 512))) for s in lens]
    jeng = JEngine(_cfgs(name, num_layers=layers)[0], _params(name, layers)[0], fused=fused, **EXPLAIN_KW)
    return reqs, jeng.explain([JRequest(t, g) for t, g in reqs])


@pytest.mark.parametrize("case", EXPLAINED)
def test_explain_engine_matches_repro(case):
    """``ig``: each bucket call routes its B·m·S interpolant tokens together,
    on both sides."""
    (name, layers, fused, lens), buckets = EXPLAINED[case]
    reqs, want = _explained(name, layers, fused, lens)
    eng = ExplainEngine(_cfgs(name, num_layers=layers)[1], _params(name, layers)[1], device="cpu", fused=fused,
                        **EXPLAIN_KW)
    got = eng.explain([ExplainRequest(t, g) for t, g in reqs])
    assert sorted(eng.stats.buckets) == buckets
    for g, w in zip(got, want):
        assert g["bucket"] == w["bucket"] and g["token_scores"].shape == w["token_scores"].shape
        _close(g["token_scores"], w["token_scores"], scaled=True)
        for k in ("f_x", "f_baseline"):
            assert abs(g[k] - w[k]) <= TOL * max(1.0, abs(w[k])), (k, g[k], w[k])
        assert abs(g["delta"] - w["delta"]) <= 1e-6 + 1e-4 * abs(w["f_x"] - w["f_baseline"])
