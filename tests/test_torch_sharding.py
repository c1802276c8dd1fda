"""The port's sharding rules against ``repro``'s, on shape-only meshes.

Every rule of ``repro_torch.sharding`` reads a mesh through
``partition.mesh_axes``, so both packages take the same stand-in
(``FakeMesh``, as ``tests/test_sharding.py``'s): axis names and a
``devices`` array of the mesh's shape, no process group. The specs must be
equal entry for entry: ``logical_to_spec``; ``param_specs`` of every
architecture in ``ARCHS`` at full width under the DEFAULT, FSDP and SP rule
tables on (data, model), (pod, data, model) and small meshes;
``cache_specs`` of reduced caches with and without ``seq_sharded`` and
``kv_slots``; ``train_state_specs``; ``spec_for_batch_tree``,
``batch_spec``, ``activation_specs``, ``explain_specs``,
``explain_reduce_specs``, ``explain_arg_shardings`` (``repro``'s
``NamedSharding`` is read back to its spec), ``dp_size`` and
``mesh_cache_key``. Also ``ElasticMesh``'s ``after_loss`` and
``rescale_batch``, ``parse_mesh_arg``, and ``kv_slots`` in the generation
engine: ``ServeEngine(kv_slots=…)`` on reduced llama3-8b at f32 against
``repro``'s (cache shapes and leaves, logits at 1e-4, greedy tokens).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import repro.sharding as jsh
from repro.configs import ARCHS as J_ARCHS, reduced as j_reduced
from repro.launch.mesh import parse_mesh_arg as j_parse_mesh_arg
from repro.models import lm as jlm
from repro.models.registry import Model as JModel
from repro.runtime.fault import ElasticMesh as JElasticMesh
from repro.serve.engine import ServeEngine as JServeEngine
from repro.train.step import TrainState as JTrainState
from repro.optim.adamw import OptState as JOptState
import repro_torch.sharding as sh
from repro_torch.configs import ARCHS, reduced
from repro_torch.launch.mesh import parse_mesh_arg
from repro_torch.models import lm
from repro_torch.optim.adamw import OptState
from repro_torch.runtime import ElasticMesh
from repro_torch.serve import ServeEngine
from repro_torch.train.step import TrainState

torch.set_num_threads(1)


class FakeMesh:
    """Duck-typed mesh for spec construction (no devices needed)."""

    def __init__(self, sizes: dict):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()), dtype=object)


MESHES = {
    "16x16": FakeMesh({"data": 16, "model": 16}),
    "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16}),
    "4x2": FakeMesh({"data": 4, "model": 2}),
    "2x1": FakeMesh({"data": 2, "model": 1}),
}
RULES = {"default": (jsh.DEFAULT_RULES, sh.DEFAULT_RULES), "fsdp": (jsh.FSDP_RULES, sh.FSDP_RULES),
         "sp": (jsh.SP_RULES, sh.SP_RULES)}


def _flat(tree, path=()):
    """{path: spec as a plain tuple} of a spec tree of either package: dict
    keys sorted, sequences in order, either package's spec a leaf."""
    if isinstance(tree, (JP, sh.PartitionSpec)):
        return {path: tuple(tree)}
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _flat(tree[key], path + (key,)).items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, x in enumerate(tree) for k, v in _flat(x, path + (i,)).items()}
    if tree is None:
        return {path: None}
    raise TypeError(type(tree))


def _same(got, want):
    g, w = _flat(got), _flat(want)
    assert g == w, {k: (g.get(k), w.get(k)) for k in set(g) | set(w) if g.get(k) != w.get(k)}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("axes, shape", [
    (("embed", "mlp"), (4096, 14336)), (("embed", "heads", "head_dim"), (384, 6, 64)),
    (("experts", "embed", "mlp"), (128, 2048, 768)), (("batch", None), (256, 10)), (("batch",), (1,)),
    (("vocab", "embed"), (128256, 4096)), (("layers", "embed", "kv_heads", "head_dim"), (32, 4096, 8, 128)),
    (("seq", "kv_seq"), (4096, 4096)), ((None, "inner"), (4, 8192)),
])
@pytest.mark.parametrize("rules", sorted(RULES))
def test_logical_to_spec_matches_repro(axes, shape, mesh, rules):
    jr, tr = RULES[rules]
    assert tuple(sh.logical_to_spec(axes, shape, MESHES[mesh], tr)) == \
        tuple(jsh.logical_to_spec(axes, shape, MESHES[mesh], jr))


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16", "4x2"])
@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_repro(arch, rules, mesh):
    """Every parameter of every FULL config: the same spec as ``repro``'s."""
    jr, tr = RULES[rules]
    _same(sh.param_specs(lm.param_defs(ARCHS[arch]), MESHES[mesh], tr),
          jsh.param_specs(jlm.param_defs(J_ARCHS[arch]), MESHES[mesh], jr))


@pytest.mark.parametrize("seq_sharded", [False, True])
@pytest.mark.parametrize("kv_slots", [0, 4])
@pytest.mark.parametrize("arch", ["llama3-8b", "gemma3-27b", "mamba2-780m", "jamba-v0.1-52b", "whisper-tiny"])
def test_cache_specs_match_repro(arch, kv_slots, seq_sharded):
    """Caches of reduced configs (batch 4, 16 slots) on a (data=2, model=2)
    and a (pod, data, model) mesh, by leaf name."""
    jcfg, cfg = j_reduced(J_ARCHS[arch]), reduced(ARCHS[arch])
    cache = lm.init_cache(cfg, 4, 16, device="cpu", kv_slots=kv_slots)
    jcache = jax.eval_shape(lambda: jlm.init_cache(jcfg, 4, 16, kv_slots=kv_slots))
    for mesh in (FakeMesh({"data": 2, "model": 2}), FakeMesh({"pod": 2, "data": 2, "model": 2})):
        got = sh.cache_specs(cache, mesh, sh.DEFAULT_RULES, seq_sharded=seq_sharded)
        want = jsh.cache_specs(jcache, mesh, jsh.DEFAULT_RULES, seq_sharded=seq_sharded)
        if cfg.is_encdec:  # repro's cache holds no cross keys before the prefill writes them
            got = {**got, "layers": tuple({k: v for k, v in lc.items() if k not in ("xk", "xv")}
                                          for lc in got["layers"]),
                   "rem": tuple({k: v for k, v in lc.items() if k not in ("xk", "xv")} for lc in got["rem"])}
        _same(got, want)


def test_cache_specs_cross_keys_by_name():
    """A decoder layer's cross keys ``xk``/``xv`` take the k/v rule."""
    cache = lm.init_cache(reduced(ARCHS["whisper-tiny"]), 4, 16, device="cpu")
    specs = sh.cache_specs(cache, FakeMesh({"data": 2, "model": 2}))
    lc = specs["layers"][0]
    assert lc["xk"] == lc["xv"] == sh.P(None, "data", None, "model", None)


@pytest.mark.parametrize("with_err", [False, True])
@pytest.mark.parametrize("rules", ["default", "fsdp"])
def test_train_state_specs_match_repro(rules, with_err):
    jr, tr = RULES[rules]
    mesh = MESHES["16x16"]
    like = TrainState(params=None, opt=OptState(None, None, None), err=0 if with_err else None)
    jlike = JTrainState(params=None, opt=JOptState(None, None, None), err=0 if with_err else None)
    got = sh.train_state_specs(lm.param_defs(ARCHS["llama3-8b"]), mesh, tr, like)
    want = jsh.train_state_specs(jlm.param_defs(J_ARCHS["llama3-8b"]), mesh, jr, jlike)
    assert type(got) is TrainState and type(got.opt) is OptState
    _same(tuple(got), tuple(want))


@pytest.mark.parametrize("seq_sharded", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_tree_and_activation_specs_match_repro(mesh, seq_sharded):
    m = MESHES[mesh]
    shapes = {"tokens": (256, 4096), "labels": (256, 4096), "token": (1, 524_288), "odd": (3, 5), "s": ()}
    batch = {k: torch.empty(s, device="meta") for k, s in shapes.items()}
    jbatch = {k: jax.ShapeDtypeStruct(s, jnp.int32) for k, s in shapes.items()}
    _same(sh.spec_for_batch_tree(batch, m, seq_sharded=seq_sharded),
          jsh.spec_for_batch_tree(jbatch, m, seq_sharded=seq_sharded))
    _same(sh.activation_specs(m, seq_sharded=seq_sharded), jsh.activation_specs(m, seq_sharded=seq_sharded))
    _same(sh.batch_spec(m), jsh.batch_spec(m))
    _same(sh.explain_specs(m), jsh.explain_specs(m))
    _same(sh.explain_reduce_specs(m), jsh.explain_reduce_specs(m))
    assert sh.dp_size(m) == jsh.dp_size(m)
    assert sh.mesh_cache_key(m) == jsh.mesh_cache_key(m)


def test_no_mesh():
    assert sh.dp_size(None) == jsh.dp_size(None) == 1
    assert sh.mesh_cache_key(None) == jsh.mesh_cache_key(None) == ()


@pytest.mark.parametrize("batch", [8, 3, 1, 16])
@pytest.mark.parametrize("mesh", ["2x1", "4x2", "2x16x16"])
def test_explain_arg_shardings_match_repro(mesh, batch, monkeypatch):
    """The per-leaf rule on an adaptive hop's argument tree (a Schedule and
    an IGState beyond the 4-tuple); ``repro``'s NamedSharding read back to
    its spec."""
    from repro.core.ig import IGState as JIGState
    from repro.core.schedule import Schedule as JSchedule
    from repro_torch.core.ig import IGState
    from repro_torch.core.schedule import Schedule

    monkeypatch.setattr("repro.sharding.partition.NamedSharding", lambda mesh, spec: spec)
    m = MESHES[mesh]
    shapes = [(batch, 16, 8), (batch, 16, 8), {"target": (batch,), "pos": (batch,)}, (batch, 16),
              ("sched", (batch, 4), (batch, 4)), ("state", (batch, 16, 8), (batch,), (batch,)), (4,), ()]

    def build(mk, sched, state):
        def one(s):
            if isinstance(s, dict):
                return {k: mk(v) for k, v in s.items()}
            if s and s[0] == "sched":
                return sched(mk(s[1]), mk(s[2]))
            if s and s[0] == "state":
                return state(mk(s[1]), mk(s[2]), mk(s[3]))
            return mk(s)
        return tuple(one(s) for s in shapes)

    args = build(torch.zeros, Schedule, IGState)
    jargs = build(lambda s: np.zeros(s, np.float32), JSchedule, JIGState)
    got, want = sh.explain_arg_shardings(m, args), jsh.explain_arg_shardings(m, jargs)
    assert (got is None) == (want is None)
    if got is not None:
        _same(got, want)
    got_e = sh.explain_shardings(m, batch=batch)
    want_e = jsh.explain_shardings(m, batch=batch)
    assert (got_e is None) == (want_e is None)


@pytest.mark.parametrize("spec", ["1", "4", "2,1", "4,2", "1,1", "0,1", "2,0", "a", "1,2,3", ""])
def test_parse_mesh_arg_matches_repro(spec):
    try:
        want = j_parse_mesh_arg(spec)
    except ValueError:
        with pytest.raises(ValueError):
            parse_mesh_arg(spec)
        return
    assert parse_mesh_arg(spec) == want


@pytest.mark.parametrize("sizes, surviving", [
    ((16, 16, 2), 400), ((16, 4, 2), 20), ((16, 2, 1), 8), ((1, 4, 1), 2), ((2, 8, 1), 15),
    ((4, 4, 4), 64), ((4, 4, 4), 63), ((1, 1, 1), 1), ((8, 2, 3), 17),
])
def test_elastic_mesh_matches_repro(sizes, surviving):
    em, jem = ElasticMesh(*sizes), JElasticMesh(*sizes)
    assert em.device_count == jem.device_count
    try:
        want = jem.after_loss(surviving)
    except RuntimeError:
        with pytest.raises(RuntimeError):
            em.after_loss(surviving)
        return
    got = em.after_loss(surviving)
    assert (got.model_size, got.data_size, got.pod_size) == (want.model_size, want.data_size, want.pod_size)
    for gb in (1, 7, 64, 256, 1000):
        assert got.rescale_batch(gb, em) == want.rescale_batch(gb, jem)


# ---------------------------------------------------------------- kv_slots

B, S, N_NEW = 2, 12, 5


@pytest.fixture(scope="module")
def llama():
    jcfg = dataclasses.replace(j_reduced(J_ARCHS["llama3-8b"]), compute_dtype="float32")
    cfg = dataclasses.replace(reduced(ARCHS["llama3-8b"]), compute_dtype="float32")
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    prompts = np.random.default_rng(0).integers(1, cfg.vocab_size, (B, S)).astype(np.int32)
    return jcfg, cfg, jparams, lm.params_from_numpy(jparams, device="cpu"), prompts


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [np.asarray(tree)]


@pytest.mark.parametrize("kv_slots", [0, 2, 4])
def test_kv_slots_serve_engine_matches_repro(llama, kv_slots):
    """The TP-expanded cache (``kh = max(NKV, kv_slots)``): the prefill
    writes every expanded head, decode reads them as they lie; the cache's
    shapes and leaves, the logits and the greedy tokens are ``repro``'s."""
    jcfg, cfg, jparams, params, prompts = llama
    max_len = S + N_NEW - 1
    jeng = JServeEngine(jcfg, jparams, max_len, kv_slots=kv_slots)
    eng = ServeEngine(cfg, params, max_len, device="cpu", kv_slots=kv_slots)
    jlogits, jcache = jeng._prefill(jparams, {"tokens": jnp.asarray(prompts)})
    logits, cache = eng._prefill(eng.params, {"tokens": torch.as_tensor(prompts)})
    kh = max(cfg.num_kv_heads, kv_slots or cfg.num_kv_heads)
    assert cache["layers"][0]["k"].shape[-2] == kh
    got, want = _leaves(cache), _leaves(jcache)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=1e-4)
    toks = eng.generate({"tokens": prompts}, N_NEW)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jeng.generate({"tokens": jnp.asarray(prompts)}, N_NEW)))
    plain = ServeEngine(cfg, params, max_len, device="cpu").generate({"tokens": prompts}, N_NEW)
    assert torch.equal(toks, plain)


def test_kv_slots_decode_step_matches_repro(llama):
    """Decode on an expanded cache: each step's logits within 1e-4 of
    ``repro``'s ``decode_step`` on its own expanded cache."""
    jcfg, cfg, jparams, params, prompts = llama
    max_len = S + N_NEW
    jm, m = JModel(jcfg), lm
    jlog, jcache = jm.prefill(jparams, {"tokens": jnp.asarray(prompts)}, max_len, kv_slots=4)
    log, cache = m.prefill(cfg, params, {"tokens": torch.as_tensor(prompts)}, max_len, kv_slots=4)
    tok = np.argmax(np.asarray(jlog)[:, -1], -1).astype(np.int32)[:, None]
    for _ in range(3):
        jlog, jcache = jm.decode_step(jparams, jcache, jnp.asarray(tok))
        log, cache = m.decode_step(cfg, params, cache, torch.as_tensor(tok))
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog), rtol=0, atol=1e-4)
        tok = np.argmax(np.asarray(jlog)[:, -1], -1).astype(np.int32)[:, None]
