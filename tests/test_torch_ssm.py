"""The port's Mamba-2 SSD mixer and the SSM LMs (mamba2-780m,
jamba-v0.1-52b) against ``repro`` on the CPU.

Configs are ``reduced(ARCHS[...])`` at f32 compute: d=64, d_inner 128 in 8
SSD heads of 16, state 16, conv 4, chunk 16; mamba2 at 2 layers, jamba at
5 (8 experts top-2; no whole period: the remainder M_D M_E M_D M_E A_D
alone, every layer kind). Jamba's engine is held to ``repro``'s in
``test_torch_moe.py``. Weights come from ``repro``'s seeded (jitted) init
through ``params_from_numpy``, inputs from numpy with fixed seeds. Each config's ``repro`` serving reference and the
``ExplainEngine`` ``ig`` references run once, in module fixtures.

Tolerances (f32, summed in another order: the chunk scan, the matrix
products): SSD outputs within 1e-5 absolute (the largest error measured
here: 4.1e-6 on outputs up to 3.9); states, conv tails, cache leaves,
gradients, logits, f(x), f(x′) and token scores within 1e-5 of the larger
of 1 and the largest |value| (measured: 3.8e-6 on decode states up to 9.8,
1.6e-5 on gradients up to 8.9 at chunk 96 and 7.8e-5 on gradients up to 22
at chunk 256 against chunk 16, 1.6e-5 on logits up to 43, 1.1e-5 on f(x)
up to 66, 1.3e-5 on scores up to 40); δ within 1e-6 plus 1e-4 of
|f(x) − f(x′)| (measured: 1.9e-5); token ids exactly.

``repro``'s SSD gradient is NaN from chunks of about 110 tokens on (it
takes ``where(causal, exp(L), 0)``, whose discarded entries overflow);
the port masks before the exponential. SSD is exact for any chunking, so
its gradient at chunk 256 is held to ``repro``'s at chunk 16.

The scheduler's retry of a fault raised inside a decode chunk is the
port's own (``repro``'s chunk donates its cache): it must give the clean
run's tokens and SSM state, and with the SSM snapshot disabled it must not.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS, reduced as j_reduced
from repro.models import ssm as jssm
from repro.models.common import init_params as j_init_params
from repro.models.registry import Model as JModel
from repro.serve import ExplainEngine as JEngine, ExplainRequest as JRequest
from repro.serve import engine as jengine
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import blocks, lm, ssm
from repro_torch.models.common import params_from_numpy
from repro_torch.models.registry import Model
from repro_torch.runtime import FaultConfig
from repro_torch.serve import ExplainEngine, ExplainRequest, GenerateRequest, MixedScheduler
from repro_torch.serve import engine

torch.set_num_threads(1)

B, MAX_LEN, N_GEN = 2, 48, 8
TOL = 1e-5
# (name, layers, prompt lengths): prefill chunks 12 and 1 (37 is prime)
MODELS = (("mamba2-780m", 2, (12, 37)), ("jamba-v0.1-52b", 5, (37,)))
LENS = (11, 16, 21, 32)  # explain traffic: buckets 16 (one chunk) and 32 (two)
EXPLAIN_KW = dict(method="ig", m=8, n_int=4, seq_buckets=(16, 32))


def _cfgs(name="mamba2-780m", layers=2, **kw):
    kw = dict(compute_dtype="float32", num_layers=layers, **kw)
    return (dataclasses.replace(j_reduced(J_ARCHS[name]), **kw),
            dataclasses.replace(reduced(ARCHS[name]), **kw))


@functools.cache
def _params(name, layers):
    jparams = jax.jit(JModel(_cfgs(name, layers)[0]).init)(jax.random.PRNGKey(0))
    return jparams, lm.params_from_numpy(jparams, device="cpu")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


def _close(got, want, scaled=False):
    """Within ``TOL`` absolute or, ``scaled``, within ``TOL`` of the larger
    of 1 and ``want``'s largest |value|."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if scaled and want.size else 1.0
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), want, rtol=0, atol=TOL * scale)


def _tokens(S, seed=1, n=B):
    return np.random.default_rng(seed).integers(1, 512, (n, S)).astype(np.int32)


# ------------------------------------------------------------------ the mixer


@functools.cache
def _mixer(chunk=16, spread=True):
    """A reduced mamba2 SSD mixer's weights (``repro``'s init; with
    ``spread``, A_log, dt_bias and D moved off their constant init) and
    the configs."""
    jcfg, cfg = _cfgs(ssm_chunk=chunk)
    jp = dict(j_init_params(jax.random.PRNGKey(3), jssm.ssm_def(jcfg)))
    rng = np.random.default_rng(6)
    for k in ("A_log", "dt_bias", "D") if spread else ():
        jp[k] = jnp.asarray(rng.normal(0, 0.5, jp[k].shape).astype(np.float32))
    return jcfg, cfg, jp, params_from_numpy(jp, device="cpu")


def _u(S, seed=4, n=B):
    return np.random.default_rng(seed).standard_normal((n, S, 64)).astype(np.float32)


@pytest.mark.parametrize("S", [2, 16, 24, 37], ids=lambda s: f"S={s}")
def test_ssd_and_its_state_match_repro(S):
    """Chunks 2, 16 (one), 12 (two) and 1 (37 is prime); the prefill's
    state and conv tail (left-padded when S < W − 1)."""
    jcfg, cfg, jp, p = _mixer()
    u = _u(S)
    want, want_c = jax.jit(jssm.ssm_forward_with_state, static_argnums=2)(jp, jnp.asarray(u), jcfg)
    got = ssm.ssm_forward(p, torch.from_numpy(u), cfg)
    _close(got, want)
    out, cache = ssm.ssm_forward_with_state(p, torch.from_numpy(u), cfg)
    assert torch.equal(out, got)
    for k in ("state", "conv"):
        assert cache[k].shape == want_c[k].shape
        _close(cache[k], want_c[k], scaled=True)


def test_teacher_forced_decode_steps_match_repro():
    """Four ``ssm_decode_step``s from a 24-token prefill, each writing the
    cache it is given in place."""
    jcfg, cfg, jp, p = _mixer()
    u = _u(28, seed=7)
    _, jc = jax.jit(jssm.ssm_forward_with_state, static_argnums=2)(jp, jnp.asarray(u[:, :24]), jcfg)
    _, cache = ssm.ssm_forward_with_state(p, torch.from_numpy(u[:, :24]), cfg)
    step = jax.jit(jssm.ssm_decode_step, static_argnums=3)
    for j in range(24, 28):
        want, jc = step(jp, jnp.asarray(u[:, j:j + 1]), jc, jcfg)
        state = cache["state"]
        got, cache2 = ssm.ssm_decode_step(p, torch.from_numpy(u[:, j:j + 1]), cache, cfg)
        assert cache2 is cache and cache["state"] is state
        _close(got, want)
        for k in ("state", "conv"):
            _close(cache[k], jc[k], scaled=True)


def _grads(chunk, S, port=True, seed=8):
    """d Σ w·ssm_forward(u) / du on one row, at ``repro``'s init (A = −1)."""
    jcfg, cfg, jp, p = _mixer(chunk, spread=False)
    u = _u(S, seed=seed, n=1)
    w = np.random.default_rng(seed + 1).standard_normal(u.shape).astype(np.float32)
    if not port:
        f = jax.jit(jax.grad(lambda v: jnp.sum(jssm.ssm_forward(jp, v, jcfg) * w)))
        return np.asarray(f(jnp.asarray(u)))
    ut = torch.from_numpy(u).requires_grad_()
    (ssm.ssm_forward(p, ut, cfg) * torch.from_numpy(w)).sum().backward()
    return ut.grad.numpy()


def test_ssd_gradient_matches_jax_at_chunk_96():
    _close(_grads(96, 96), _grads(96, 96, port=False), scaled=True)


def test_ssd_gradient_is_finite_at_chunk_256():
    """Where ``repro``'s is NaN; held to ``repro``'s finite gradient of the
    same function at chunk 16."""
    got = _grads(256, 256)
    assert np.isfinite(got).all()
    _close(got, _grads(16, 256, port=False), scaled=True)


# ---------------------------------------------------------------- serving


class _Ref:
    """One config's ``repro`` serving reference, run once."""

    def __init__(self, name, layers, prompts):
        self.jcfg, self.cfg = _cfgs(name, layers)
        jparams, self.params = _params(name, layers)
        jm = JModel(self.jcfg)
        prefill, step = jax.jit(jm.prefill, static_argnums=(2,)), jax.jit(jm.decode_step)
        self.toks, self.decode = _tokens(max(prompts) + 6, seed=2), {}
        for S in prompts:
            logits, cache = prefill(jparams, {"tokens": jnp.asarray(self.toks[:, :S])}, MAX_LEN)
            out = [(np.asarray(logits), _leaves(cache))]
            for j in range(S, S + 6):
                logits, cache = step(jparams, cache, jnp.asarray(self.toks[:, j:j + 1]))
                out.append((np.asarray(logits), _leaves(cache)))
            self.decode[S] = out
        eng = jengine.ServeEngine(self.jcfg, jparams, MAX_LEN)
        self.greedy = np.asarray(eng.generate({"tokens": jnp.asarray(self.toks[:, :prompts[0]])}, N_GEN))


@pytest.fixture(scope="module", params=MODELS, ids=lambda m: f"{m[0]} {m[1]} layers")
def ref(request):
    return _Ref(*request.param)


def test_teacher_forced_decode_matches_repro(ref):
    """Prefill (mamba2 at 12 and 37 tokens, jamba at 37: chunk 1), then
    six decode steps: logits and every cache leaf (SSM states, conv tails,
    jamba's KV) each step. Jamba at 5 layers runs no period: every layer
    is a remainder layer."""
    model = Model(ref.cfg)
    for S, want in ref.decode.items():
        lg, cache = model.prefill(ref.params, {"tokens": torch.from_numpy(ref.toks[:, :S])}, MAX_LEN)
        for j, (want_lg, want_cache) in enumerate(want):
            if j:
                lg, cache = model.decode_step(ref.params, cache, torch.from_numpy(ref.toks[:, S + j - 1:S + j]))
            _close(lg, want_lg, scaled=True)
            got = _leaves(cache)
            assert [g.shape for g in got] == [w.shape for w in want_cache]
            for g, w in zip(got, want_cache):
                _close(g, w, scaled=True)


def test_greedy_generate_matches_repro(ref):
    eng = engine.ServeEngine(ref.cfg, ref.params, MAX_LEN, device="cpu")
    got = eng.generate({"tokens": torch.from_numpy(ref.toks[:, :min(ref.decode)])}, N_GEN)
    np.testing.assert_array_equal(got.numpy(), ref.greedy)


def test_mamba2_decodes_without_a_cap():
    """No full-attention layer: decoding past ``max_len`` goes on, as the
    state carries the past."""
    _, cfg = _cfgs()
    params = _params("mamba2-780m", 2)[1]
    model = Model(cfg)
    toks = _tokens(12, seed=5)
    _, cache = model.prefill(params, {"tokens": torch.from_numpy(toks[:, :8])}, 8)
    for j in range(8, 12):
        lg, cache = model.decode_step(params, cache, torch.from_numpy(toks[:, j:j + 1]))
    assert int(cache["len"]) == 12 and bool(torch.isfinite(lg).all())
    assert cfg.num_periods == 2 and lm.init_cache(cfg, 1, 8, device="cpu")["layers"][0]["state"].shape == (
        2, 1, 8, 16, 16)


def test_jamba_builds_with_no_whole_period():
    _, cfg = _cfgs("jamba-v0.1-52b", 5)
    assert cfg.num_periods == 0 and [(s.mixer, s.ffn) for s in cfg.remainder_specs] == [
        ("mamba", "dense"), ("mamba", "moe"), ("mamba", "dense"), ("mamba", "moe"), ("attn", "dense")]
    defs = lm.param_defs(cfg)
    assert all(len(d["norm1"]["scale"].shape) == 2 and d["norm1"]["scale"].shape[0] == 0
               for d in defs["layers"])


# ----------------------------------------------------------------- explaining


@functools.cache
def _explained(name, layers, fused):
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(1, 512, s).astype(np.int32), int(rng.integers(0, 512))) for s in LENS]
    jeng = JEngine(_cfgs(name, layers)[0], _params(name, layers)[0], fused=fused, **EXPLAIN_KW)
    return reqs, jeng.explain([JRequest(t, g) for t, g in reqs])


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_explain_engine_matches_repro(fused):
    """``ig`` on reduced mamba2 at buckets 16 (one SSD chunk) and 32 (two)."""
    reqs, want = _explained("mamba2-780m", 2, fused)
    eng = ExplainEngine(_cfgs()[1], _params("mamba2-780m", 2)[1], device="cpu", fused=fused, **EXPLAIN_KW)
    got = eng.explain([ExplainRequest(t, g) for t, g in reqs])
    assert sorted(eng.stats.buckets) == [(2, 16), (2, 32)]
    for g, w in zip(got, want):
        assert g["bucket"] == w["bucket"] and g["token_scores"].shape == w["token_scores"].shape
        _close(g["token_scores"], w["token_scores"], scaled=True)
        for k in ("f_x", "f_baseline"):
            assert abs(g[k] - w[k]) <= TOL * max(1.0, abs(w[k])), (k, g[k], w[k])
        assert abs(g["delta"] - w["delta"]) <= 1e-6 + 1e-4 * abs(w["f_x"] - w["f_baseline"])


# ---------------------------------------------------------------- scheduler


def _retried_run(monkeypatch, fault: bool):
    """One greedy generate of 6 + 14 tokens on reduced mamba2 through a
    scheduler with chunks of 3; with ``fault``, the chunk from position 9
    raises at its third ``decode_step``, once, after two steps advanced
    every SSM state. Returns (tokens, the final states and conv tails)."""
    _, cfg = _cfgs()
    eng = ExplainEngine(cfg, _params("mamba2-780m", 2)[1], device="cpu", method="ig", m=4, n_int=2,
                        seq_buckets=(16,))
    sched = MixedScheduler(eng, max_len=32, decode_chunk=3,
                           fault_cfg=FaultConfig(max_retries=1, backoff_base_s=0.0))
    seen, state, real = {}, {"calls": None, "fired": 0}, lm.decode_step

    def faulty(*a, **kw):
        if state["calls"] is not None:
            state["calls"] += 1
            if state["calls"] == 3:
                state["calls"] = None
                state["fired"] += 1
                raise RuntimeError("injected fault inside a decode chunk")
        out = real(*a, **kw)
        seen["cache"] = out[1]
        return out

    def hook(kind, payload):
        if fault and kind == "decode" and int(payload.cache["len"]) >= 9 and not state["fired"] \
                and state["calls"] is None:
            state["calls"] = 0

    monkeypatch.setattr(lm, "decode_step", faulty)
    sched.fault_hook = hook
    t = sched.submit(GenerateRequest(tokens=_tokens(6, seed=9, n=1)[0], num_tokens=14))
    sched.run_until_idle()
    assert t.status == "done" and not t.degraded and eng.stats.degraded == 0
    assert state["fired"] == int(fault)
    return t.tokens, [x.clone() for x in _leaves_t(seen["cache"])]


def _leaves_t(cache):
    return [lc[k] for _, lc in lm._per_layer(_cfgs()[1], cache) for k in ("state", "conv")]


def test_scheduler_retry_inside_a_chunk_is_exact_on_the_state(monkeypatch):
    clean_toks, clean = _retried_run(monkeypatch, fault=False)
    monkeypatch.undo()
    toks, got = _retried_run(monkeypatch, fault=True)
    np.testing.assert_array_equal(toks, clean_toks)
    assert all(torch.equal(g, w) for g, w in zip(got, clean))


def test_scheduler_retry_without_the_ssm_snapshot_is_not_exact(monkeypatch):
    """The same fault with the SSM snapshot saving nothing (the length is
    still restored): the retried steps start from the advanced state."""
    clean_toks, clean = _retried_run(monkeypatch, fault=False)
    monkeypatch.undo()
    monkeypatch.setattr(blocks, "decode_snapshot", lambda *a, **kw: lambda: None)
    toks, got = _retried_run(monkeypatch, fault=True)
    assert not all(torch.equal(g, w) for g, w in zip(got, clean))
