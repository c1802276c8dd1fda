"""The port's mesh-sharded ``ExplainEngine`` in gloo worlds of 2 and 4 on the CPU.

The cases of ``tests/test_mesh_explain.py`` (which skips in tier-1 for want
of 4 XLA devices) on the port: a module fixture starts each world once —
this process is rank 0, the controller, and spawns ranks 1…N−1, which build
the same model from a saved copy and run ``serve_worker`` — over a
``FileStore`` under the test's temporary directory, with a finite group
timeout; the workers are stopped (and killed if they linger) on teardown.

The model is ``reduced(ARCHS["llama3-8b"])`` at f32 compute on
``repro``'s seeded weights (``lm.params_from_numpy``), m=8 (adaptive m=4 up
to 16), n_int=4. The sharded engine is held to ``repro``'s single-device
engine for the gradient class (the ensembles on ``repro``'s per-row normals
through ``draw=``) and to the port's unsharded engine for every method and
schedule, at ``repro``'s own tolerance, atol = 2e-4 on token scores and δ.
Adaptive traces (m_used, hops, converged) must be equal, replayed traffic
adds no miss and gives the same bits, buckets are padded to the dp
multiple and no fallback is taken; a hand-built indivisible bucket warns
and counts one. The command line runs once under ``torch.distributed.run``
with ``--mesh 2,1`` against ``--mesh 1,1``.
"""
import dataclasses
import functools
import os
import re
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCHS as J_ARCHS, reduced as j_reduced
from repro.models.registry import Model as JModel
from repro.serve import ExplainEngine as JEngine, ExplainRequest as JRequest
from repro_torch.configs import ARCHS, reduced
from repro_torch.core import schedule
from repro_torch.core.api import Explainer
from repro_torch.core.fingerprint import params_digest, reachable_tensors
from repro_torch.core.baselines import pad_embedding
from repro_torch.core.methods import METHODS
from repro_torch.launch.mesh import make_explain_mesh
from repro_torch.models import lm
from repro_torch.models.registry import Model
from repro_torch.runtime import ElasticMesh
from repro_torch.serve import ExplainEngine, ExplainRequest, MixedScheduler
from repro_torch.serve.batching import BucketBatch
from repro_torch.sharding import dispatch, dp_size, mesh_cache_key, to_placements, P

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
MIXED_LENS = (9, 12, 17)
KW = dict(schedule="paper", m=8, n_int=4)
ADAPTIVE = dict(m=4, adaptive=True, tol=1e-2, m_max=16)
ATOL = 2e-4  # repro's tests/test_mesh_explain.py
GROUP_TIMEOUT_S = 120

WORKER = """
import sys
from datetime import timedelta
import torch, torch.distributed as dist
rank, world, store, saved = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world,
                        timeout=timedelta(seconds=int(sys.argv[5])))
from repro_torch.launch.mesh import make_explain_mesh
from repro_torch.models.registry import Model
from repro_torch.serve.explain_engine import serve_worker
cfg, params = torch.load(saved, weights_only=False)
make_explain_mesh(world, 1, device="cpu")
serve_worker(cfg, params, device="cpu", f=Model(cfg).target_logprob_fn(params))
dist.destroy_process_group()
"""


def _cfgs():
    return (dataclasses.replace(j_reduced(J_ARCHS["llama3-8b"]), compute_dtype="float32"),
            dataclasses.replace(reduced(ARCHS["llama3-8b"]), compute_dtype="float32"))


@functools.cache
def _jax_params():
    return JModel(_cfgs()[0]).init(jax.random.PRNGKey(0))


@functools.cache
def _params():
    return lm.params_from_numpy(_jax_params(), device="cpu")


def _traffic(lens, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(1, 512, s).astype(np.int32), int(rng.integers(0, 512))) for s in lens]


def jax_normals(seed: int):
    """``repro``'s per-row ensemble draw, as the port's ``draw=`` hook."""

    def draw(S, rows, shape):
        base = jax.random.fold_in(jax.random.PRNGKey(seed), S)
        return np.stack([np.asarray(jax.random.normal(jax.random.fold_in(base, jnp.uint32(i)),
                                                      (1,) + tuple(shape)))[0] for i in rows])

    return draw


@functools.cache
def _repro(lens, seed, **kw):
    """``repro``'s single-device engine on the traffic, once per config."""
    jeng = JEngine(_cfgs()[0], _jax_params(), **{**KW, **kw})
    return jeng.explain([JRequest(t, g) for t, g in _traffic(lens, seed)])


def _engine(mesh=None, **kw):
    return ExplainEngine(_cfgs()[1], _params(), device="cpu", mesh=mesh, draw=jax_normals(0), **{**KW, **kw})


def _requests(lens, seed):
    return [ExplainRequest(t, g) for t, g in _traffic(lens, seed)]


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def world(request, tmp_path_factory):
    """A gloo world of ``request.param`` ranks: this process is rank 0 inside
    ``dispatch.controller()``; yields the (data=N, model=1) mesh."""
    n = request.param
    tmp = tmp_path_factory.mktemp(f"world{n}")
    saved, store = tmp / "model.pt", tmp / "store"
    torch.save((_cfgs()[1], _params()), saved)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(1, n)]
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(n), str(store), str(saved),
                               str(GROUP_TIMEOUT_S)], env=env, stdout=log, stderr=subprocess.STDOUT)
             for r, log in zip(range(1, n), logs)]
    try:
        dist.init_process_group("gloo", store=dist.FileStore(str(store), n), rank=0, world_size=n,
                                timeout=timedelta(seconds=GROUP_TIMEOUT_S))
        mesh = make_explain_mesh(n, 1, device="cpu")
        with dispatch.controller():
            yield mesh
        dist.destroy_process_group()
        for p in procs:
            assert p.wait(timeout=60) == 0, (tmp / "rank1.log").read_text()[-4000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for log in logs:
            log.close()
        if dist.is_initialized():
            dist.destroy_process_group()


def _close(got, want, atol=ATOL):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a["token_scores"], b["token_scores"], rtol=0, atol=atol)
        np.testing.assert_allclose(a["delta"], b["delta"], rtol=0, atol=atol)


def _all_buckets_divide(eng):
    return all(b[0] % eng.dp == 0 for b in list(eng.stats.buckets) + list(eng.stats.hop_buckets))


# ---------------------------------------------------- fixed-m parity


@pytest.mark.parametrize("method", sorted(METHODS))
def test_fixed_m_per_method(world, method):
    kw = dict(method=method, n_samples=2) if METHODS[method].expand is not None else dict(method=method)
    sharded = _engine(world, **kw)
    assert sharded.dp == dp_size(world) == world.mesh.shape[0]
    calls = dispatch.STATS.calls
    got = sharded.explain(_requests(MIXED_LENS, 1))
    assert dispatch.STATS.calls > calls, "no call went through the mesh"
    _close(got, _engine(**kw).explain(_requests(MIXED_LENS, 1)))
    if not METHODS[method].forward_only:
        _close(got, _repro(MIXED_LENS, 1, **kw))
    # zero steady-state misses against the mesh-keyed cache
    misses = sharded.stats.misses
    again = sharded.explain(_requests(MIXED_LENS, 2))
    assert sharded.stats.misses == misses, f"{method} rebuilt under the mesh"
    assert sharded.stats.mesh_fallbacks == 0 and _all_buckets_divide(sharded)
    assert all(np.isfinite(o["token_scores"]).all() for o in again)


@pytest.mark.parametrize("sched", sorted(schedule.SCHEDULES))
def test_fixed_m_per_schedule(world, sched):
    sharded = _engine(world, schedule=sched)
    _close(sharded.explain(_requests((9, 17), 3)), _engine(schedule=sched).explain(_requests((9, 17), 3)))
    assert sharded.stats.mesh_fallbacks == 0 and _all_buckets_divide(sharded)


# ------------------------------------------------ adaptive traces


@pytest.mark.parametrize("method", sorted(n for n in METHODS if not METHODS[n].forward_only))
def test_adaptive_traces_per_method(world, method):
    kw = dict(ADAPTIVE, method=method, n_samples=2) if METHODS[method].expand is not None \
        else dict(ADAPTIVE, method=method)
    lens = (9, 17, 12, 24)
    sharded = _engine(world, **kw)
    got = sharded.explain(_requests(lens, 4))
    for want in (_engine(**kw).explain(_requests(lens, 4)), _repro(lens, 4, **kw)):
        for a, b in zip(got, want):
            # the serving DECISIONS match exactly: exit rung, hops, verdict
            assert (a["m_used"], a["hops"], a["converged"]) == (b["m_used"], b["hops"], b["converged"]), \
                f"{method} escalation trace diverged under the mesh"
        _close(got, want)
    assert sharded.stats.adaptive.hop_calls > 0
    misses = sharded.stats.misses
    again = sharded.explain(_requests(lens, 4))
    assert sharded.stats.misses == misses, f"{method} adaptive replay rebuilt"
    assert sharded.stats.mesh_fallbacks == 0 and _all_buckets_divide(sharded)
    for a, b in zip(got, again):
        np.testing.assert_array_equal(a["token_scores"], b["token_scores"])


# ------------------------------ mesh-divisible padding, fallback counter


def test_buckets_padded_to_dp_multiple(world):
    eng = _engine(world, m=4, n_int=2)
    n = dp_size(world)
    eng.explain(_requests((9,), 5))  # 1 request: B pads up to dp
    assert set(eng.stats.buckets) == {(n, 16)} and eng.stats.mesh_fallbacks == 0


def test_indivisible_bucket_counts_fallback(world):
    """A hand-built B=3 bucket (bypassing plan-time padding) is served
    correctly on rank 0 alone: counted and warned of, never silent."""
    eng = _engine(world, m=4, n_int=2)
    reqs = _traffic((5, 5, 5), 6)
    tokens = np.stack([np.pad(t, (0, 3)) for t, _ in reqs]).astype(np.int32)
    bb = BucketBatch(bucket=(3, 8), indices=(0, 1, 2), tokens=tokens, lens=np.full((3,), 5, np.int32),
                     targets=np.asarray([g for _, g in reqs], np.int32), mask=(tokens != 0).astype(np.float32))
    calls = dispatch.STATS.calls
    with pytest.warns(UserWarning, match="does not divide dp"):
        res = eng._run_bucket(bb)
    assert eng.stats.mesh_fallbacks == 1 and dispatch.STATS.calls == calls
    assert torch.isfinite(res.attributions).all()


# --------------------------------- one cache, mesh-keyed, entries coexist


def test_adaptive_cache_coexists_across_meshes(world):
    """``Explainer.attribute_adaptive``: one shared cache serves an
    unsharded and a sharded explainer without collisions."""
    cfg, params = _cfgs()[1], _params()
    model = Model(cfg)
    f = model.target_logprob_fn(params)
    reqs = _traffic((8, 8, 8, 8), 7)
    e = model.embed_inputs(params, {"tokens": torch.as_tensor(np.stack([t for t, _ in reqs]))})
    bl = pad_embedding(params["embed"]["embedding"], e, pad_id=0)
    tgt = torch.as_tensor([g for _, g in reqs])
    cache = {}
    kw = dict(schedule="paper", m=4, n_int=4, device="cpu")
    res1, info1 = Explainer(f, **kw).attribute_adaptive(e, bl, tgt, m_max=8, cache=cache)
    n1 = len(cache)
    assert n1 == info1["compiles"] > 0
    calls = dispatch.STATS.calls
    res2, info2 = Explainer(f, mesh=world, **kw).attribute_adaptive(e, bl, tgt, m_max=8, cache=cache)
    assert len(cache) == n1 + info2["compiles"] > n1, "mesh entries must not collide"
    assert dispatch.STATS.calls > calls
    # B=4 divides dp and hops pad survivors to dp multiples: everything shards
    assert info2["mesh_fallbacks"] == 0
    np.testing.assert_allclose(res1.attributions.numpy(), res2.attributions.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(info1["m_used"], info2["m_used"])
    _, i1 = Explainer(f, **kw).attribute_adaptive(e, bl, tgt, m_max=8, cache=cache)
    _, i2 = Explainer(f, mesh=world, **kw).attribute_adaptive(e, bl, tgt, m_max=8, cache=cache)
    assert i1["compiles"] == i2["compiles"] == 0


# ------------------------------------- every rank serves rank 0's weights


def _other_weights():
    """The model's weights with one element of the embedding moved."""
    params = dict(_params())
    emb = params["embed"]["embedding"].clone()
    emb.view(-1)[7] += 1e-3
    params["embed"] = {**params["embed"], "embedding": emb}
    return params


def test_worker_refuses_other_weights(world):
    """Rank 0 holding other weights than the workers fails the sharded call
    with the workers' refusal (the digest in the recipe), and the world
    serves on after it."""
    other = _other_weights()
    eng = ExplainEngine(_cfgs()[1], other, device="cpu", mesh=world, **KW)
    with pytest.raises(RuntimeError, match="other weights than rank 0"):
        eng.explain(_requests((9, 12), 11))
    f = Model(_cfgs()[1]).target_logprob_fn(other)
    e = torch.randn(dp_size(world), 8, _cfgs()[1].d_model, generator=torch.Generator().manual_seed(0))
    tgt = torch.arange(dp_size(world))
    with pytest.raises(RuntimeError, match="other weights than rank 0"):
        Explainer(f, mesh=world, schedule="paper", m=4, n_int=2, device="cpu").attribute_adaptive(
            e, torch.zeros_like(e), tgt, m_max=8)
    _close(_engine(world).explain(_requests((9, 12), 11)), _engine().explain(_requests((9, 12), 11)))


def test_params_digest_sees_one_element():
    params, other = _params(), _other_weights()
    assert params_digest(params) == params_digest({k: params[k] for k in reversed(list(params))})
    assert params_digest(params) != params_digest(other)
    bf16 = {"w": torch.ones(4, dtype=torch.bfloat16)}
    assert params_digest(bf16) != params_digest({"w": torch.ones(4)})
    swapped = {"w": torch.tensor([1.0, 2.0])}
    assert params_digest(swapped) != params_digest({"w": torch.tensor([2.0, 1.0])})
    f = Model(_cfgs()[1]).target_logprob_fn(params)
    assert params_digest(reachable_tensors(f)) == params_digest(reachable_tensors(
        Model(_cfgs()[1]).target_logprob_fn(params)))
    assert params_digest(reachable_tensors(f)) != params_digest(reachable_tensors(
        Model(_cfgs()[1]).target_logprob_fn(other)))


def test_a_result_that_is_not_per_row_is_refused():
    """The gather's rule: every tensor leaf of a stage-2 output is per row."""
    assert len(dispatch._row_leaves((torch.zeros(2, 3), {"d": torch.zeros(2)}, 5), 2)) == 2
    for out in ((torch.zeros(2, 3), torch.zeros(())), (torch.zeros(2, 3), torch.zeros(3, 2))):
        with pytest.raises(ValueError, match="not per-row"):
            dispatch._row_leaves(out, 2)


# ------------------------------------------ the scheduler, ElasticMesh, layouts


def test_scheduler_round_pads_to_dp(world):
    eng = _engine(world, **ADAPTIVE)
    sched = MixedScheduler(eng, max_len=32, decode_chunk=4)
    reqs = _requests((9, 12, 17, 24, 30), 8)
    tickets = [sched.submit(r) for r in reqs]
    sched.run_until_idle()
    assert all(t.status == "done" for t in tickets), [t.status for t in tickets]
    assert _all_buckets_divide(eng) and eng.stats.mesh_fallbacks == 0
    want = _engine(**ADAPTIVE).explain(reqs)
    for t, w in zip(tickets, want):
        assert (t.result["m_used"], t.result["hops"]) == (w["m_used"], w["hops"])
    _close([t.result for t in tickets], want)


def test_elastic_mesh_make_mesh(world):
    """After losing ranks the data axis shrinks; the rebuilt mesh serves."""
    n = dp_size(world)
    em = ElasticMesh(model_size=1, data_size=2 * n).after_loss(2)
    assert (em.model_size, em.data_size, em.device_count) == (1, 2, 2)
    mesh = em.make_mesh(device_type="cpu")
    assert mesh_cache_key(mesh) == (("data", 2), ("model", 1))
    eng = _engine(mesh)
    calls = dispatch.STATS.calls
    _close(eng.explain(_requests(MIXED_LENS, 9)), _engine().explain(_requests(MIXED_LENS, 9)))
    assert dispatch.STATS.calls > calls and eng.stats.mesh_fallbacks == 0


def test_mesh_keys_and_layouts(world):
    n = dp_size(world)
    assert mesh_cache_key(world) == (("data", n), ("model", 1))
    eng = _engine(world, m=4, n_int=2)
    eng.explain(_requests(MIXED_LENS, 10))
    assert all(k[-2] == mesh_cache_key(world) for k in eng._cache)
    from torch.distributed.tensor import Replicate, Shard

    assert to_placements(P("data", None, None), world) == (Shard(0), Replicate())
    assert to_placements(P(None, "model"), world) == (Replicate(), Shard(1))
    local = torch.arange(6.0).reshape(2, 3)
    from repro_torch.launch.distributed import assemble_global

    g = assemble_global(world, P("data", None), local)
    assert tuple(g.shape) == (2 * n, 3) and torch.equal(g.to_local(), local)


# --------------------------------------------------------- the command line


def _cli(cmd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_cli_mesh_2_matches_mesh_1():
    """``--mesh 2,1`` under the launcher over gloo serves and prints the mesh
    line; its mean δ equals a ``--mesh 1,1`` run's to the printed precision."""
    args = ["-m", "repro_torch.launch.explain", "--device", "cpu", "--m", "8", "--requests", "6",
            "--rounds", "2", "--max-seq", "20"]
    port = 29400 + (os.getpid() % 500)
    two = _cli([sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
                f"--master-port={port}"] + args + ["--mesh", "2,1", "--dist-backend", "gloo"])
    one = _cli([sys.executable] + args + ["--mesh", "1,1", "--dist-backend", "gloo"])
    assert "mesh: data=2 model=1 over 2 devices" in two and "mesh: data=1 model=1 over 1 devices" in one
    deltas = lambda out: re.findall(r"mean_delta=(\S+)", out)
    assert deltas(two) == deltas(one) and len(deltas(one)) == 4
    assert two.count("method=ig") == 2  # the workers printed nothing
