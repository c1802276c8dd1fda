"""The dry run's sharded code paths compute the right values: a real gloo
world of 4 CPU ranks as a (data=2, model=2) DeviceMesh.

The dry run counts DTensor programs on ``meta`` shards and never looks at a
value. Here the same code runs on real shards: four child processes (one a
rank) build the mesh over a ``FileStore``, place f32 parameters of
``reduced`` configs by the dry run's rules (``FSDP_RULES``), run under
``activation_sharding(mesh)`` as the cells do, and rank 0 saves the whole
results (``full_tensor()``). This process compares them with the port on
one device and with ``repro``:

  * ``moe`` of qwen3-moe-30b-a3b (capacity factor 0.25: most choices are
    dropped) and of jamba-v0.1-52b: the output, the aux loss and the
    gradients of a seeded cotangent with respect to x, the router and the
    expert weights, within rtol = atol = 1e-5 of the port on one device and
    of ``repro.models.moe.moe``; the routing's ``keep`` and ``slot`` equal
    the one-device routing's exactly (one sort of all the call's tokens);
  * ``vocab_xent`` on logits sharded over rows and vocab: the summed loss
    within 1e-6 relative of ``F.cross_entropy`` and its gradient within
    1e-5; ``softmax_xent_chunked`` through the sharded unembedding within
    1e-6 relative of ``repro``'s and of the one-device port's;
  * one mamba2-780m ``ssm_decode_step``: the output and the new state and
    conv tail within 1e-5 of the unsharded step.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import ARCHS as J_ARCHS, reduced as j_reduced
from repro.models import layers as jlayers, moe as jmoe, ssm as jssm
from repro.models.common import init_params as j_init_params
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import moe, ssm
from repro_torch.models.layers import softmax_xent_chunked

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WORLD, GROUP_TIMEOUT_S = 4, 120
TOL = 1e-5
MOE = {"qwen3-moe-30b-a3b": 0.25, "jamba-v0.1-52b": 1.25}  # capacity factors
MOE_SHAPE = (4, 16)  # B, S: 64 tokens in one routing
XENT = (4, 24)  # B, S of the chunked loss (chunks of 16 and a remainder of 8)
DECODE_B = 4

RANK = r"""
import sys
from datetime import timedelta
import numpy as np
import torch
import torch.distributed as dist
rank, world, store, src, dst, timeout = sys.argv[1:7]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank, world_size=world,
                        timeout=timedelta(seconds=int(timeout)))
import dataclasses
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.configs import ARCHS, reduced
from repro_torch.models import moe, ssm
from repro_torch.models.layers import embed_def, softmax_xent_chunked, vocab_xent
from repro_torch.sharding import FSDP_RULES, cache_specs, param_specs, to_placements
from repro_torch.sharding.context import activation_sharding, gathered

mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
D = dict(np.load(src))
res = {}


def place(arr, pl, grad=False):
    t = distribute_tensor(torch.from_numpy(np.ascontiguousarray(arr)), mesh, pl)
    return t.requires_grad_() if grad else t


def params(prefix, defs, grad):
    specs = param_specs(defs, mesh, FSDP_RULES)
    return {k: place(D[prefix + k], to_placements(specs[k], mesh), grad) for k in defs}


ROWS = (Shard(0), Replicate())
for name, factor in (("qwen3-moe-30b-a3b", 0.25), ("jamba-v0.1-52b", 1.25)):
    cfg = dataclasses.replace(reduced(ARCHS[name]), compute_dtype="float32", capacity_factor=factor)
    p = params(name + "/", moe.moe_def(cfg), True)
    x = place(D[name + "/x"], ROWS, True)
    with activation_sharding(mesh):
        g = gathered(p)
        y, aux = moe.moe(g, x, cfg)
        loss = (y * place(D[name + "/w"], tuple(y.placements))).sum() + aux
        loss.backward()
        r = moe.route(g["router"], x.reshape(-1, x.shape[-1]), cfg)
    res[name + "/y"], res[name + "/aux"] = y.full_tensor(), aux.full_tensor()
    res[name + "/dx"] = x.grad.full_tensor()
    for k in p:
        res[name + "/d" + k] = p[k].grad.full_tensor()
    res[name + "/keep"], res[name + "/slot"] = r.keep.full_tensor(), r.slot.full_tensor()

logits = place(D["xent/logits"], (Shard(0), Shard(1)), True)
loss = vocab_xent(logits, place(D["xent/labels"], ROWS))
loss.backward()
res["xent/loss"], res["xent/dlogits"] = loss.full_tensor(), logits.grad.full_tensor()

cfg = dataclasses.replace(reduced(ARCHS["llama3-8b"]), compute_dtype="float32")
ue = params("chunked/", {"unembed": embed_def(cfg)["unembed"]}, False)
with activation_sharding(mesh):
    res["chunked/loss"] = softmax_xent_chunked(ue, place(D["chunked/h"], ROWS), place(D["chunked/labels"], ROWS),
                                               cfg, chunk=16).full_tensor()

cfg = dataclasses.replace(reduced(ARCHS["mamba2-780m"]), compute_dtype="float32")
p = params("ssm/", ssm.ssm_def(cfg), False)
cache = {k: D["ssm/" + k] for k in ("state", "conv")}
specs = cache_specs({k: torch.empty(v.shape, device="meta") for k, v in cache.items()}, mesh, FSDP_RULES)
cache = {k: place(v, to_placements(specs[k], mesh)) for k, v in cache.items()}
with activation_sharding(mesh), torch.no_grad():
    out, cache = ssm.ssm_decode_step(gathered(p), place(D["ssm/u"], ROWS), cache, cfg)
res["ssm/out"] = out.full_tensor()
res["ssm/state"], res["ssm/conv"] = cache["state"].full_tensor(), cache["conv"].full_tensor()
if rank == 0:
    np.savez(dst, **{k: v.detach().numpy() for k, v in res.items()})
dist.destroy_process_group()
"""


def _cfgs(name, **kw):
    kw = dict(compute_dtype="float32", **kw)
    return (dataclasses.replace(j_reduced(J_ARCHS[name]), **kw), dataclasses.replace(reduced(ARCHS[name]), **kw))


def _inputs() -> dict:
    """Every input, from fixed seeds: ``repro``'s initialisers for the
    weights, numpy for the activations."""
    D = {}
    for i, (name, factor) in enumerate(MOE.items()):
        jcfg, _ = _cfgs(name, capacity_factor=factor)
        for k, v in j_init_params(jax.random.PRNGKey(10 + i), jmoe.moe_def(jcfg)).items():
            D[f"{name}/{k}"] = np.array(v, np.float32)  # a writable copy
        rng = np.random.default_rng(20 + i)
        D[f"{name}/x"] = rng.standard_normal((*MOE_SHAPE, jcfg.d_model)).astype(np.float32)
        D[f"{name}/w"] = rng.standard_normal((*MOE_SHAPE, jcfg.d_model)).astype(np.float32)
    rng = np.random.default_rng(30)
    D["xent/logits"] = (3 * rng.standard_normal((48, 512))).astype(np.float32)
    D["xent/labels"] = rng.integers(0, 512, 48)
    jcfg, _ = _cfgs("llama3-8b")
    D["chunked/unembed"] = np.array(j_init_params(jax.random.PRNGKey(31), jlayers.embed_def(jcfg))["unembed"])
    D["chunked/h"] = rng.standard_normal((*XENT, jcfg.d_model)).astype(np.float32)
    D["chunked/labels"] = rng.integers(0, jcfg.vocab_size, XENT)
    jcfg, cfg = _cfgs("mamba2-780m")
    for k, v in j_init_params(jax.random.PRNGKey(32), jssm.ssm_def(jcfg)).items():  # A, D, dt_bias off their inits
        D[f"ssm/{k}"] = (np.asarray(v) + 0.1 * rng.standard_normal(v.shape)).astype(np.float32)
    D["ssm/u"] = rng.standard_normal((DECODE_B, 1, cfg.d_model)).astype(np.float32)
    ch = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    D["ssm/state"] = rng.standard_normal((DECODE_B, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state)
                                         ).astype(np.float32)
    D["ssm/conv"] = rng.standard_normal((DECODE_B, cfg.ssm_conv - 1, ch)).astype(np.float32)
    return D


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(inputs, the sharded results): one run of the four ranks."""
    tmp = tmp_path_factory.mktemp("sharded")
    D = _inputs()
    np.savez(tmp / "in.npz", **D)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r), str(WORLD), str(tmp / "store"),
                               str(tmp / "in.npz"), str(tmp / "out.npz"), str(GROUP_TIMEOUT_S)],
                              env=env, stdout=log, stderr=subprocess.STDOUT) for r, log in enumerate(logs)]
    try:
        codes = [p.wait(timeout=3 * GROUP_TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    assert codes == [0] * WORLD, "\n".join((tmp / f"rank{r}.log").read_text()[-3000:] for r in range(WORLD))
    return D, dict(np.load(tmp / "out.npz"))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=tol, atol=tol)


def _moe_one_device(D, name):
    """The port on one device: (y, aux, grads by name, routing)."""
    _, cfg = _cfgs(name, capacity_factor=MOE[name])
    p = {k: torch.from_numpy(D[f"{name}/{k}"]).requires_grad_() for k in moe.moe_def(cfg)}
    x = torch.from_numpy(D[f"{name}/x"]).requires_grad_()
    y, aux = moe.moe(p, x, cfg)
    ((y * torch.from_numpy(D[f"{name}/w"])).sum() + aux).backward()
    grads = {"dx": x.grad, **{"d" + k: v.grad for k, v in p.items()}}
    r = moe.route(p["router"].detach(), x.detach().reshape(-1, x.shape[-1]), cfg)
    return y.detach(), aux.detach(), grads, r


def _moe_repro(D, name):
    jcfg, _ = _cfgs(name, capacity_factor=MOE[name])
    jp = {k: jnp.asarray(D[f"{name}/{k}"]) for k in jmoe.moe_def(jcfg)}
    w = jnp.asarray(D[f"{name}/w"])

    def loss(jp, x):
        y, aux = jmoe.moe(jp, x, jcfg)
        return jnp.sum(y * w) + aux

    y, aux = jmoe.moe(jp, jnp.asarray(D[f"{name}/x"]), jcfg)
    gp, gx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(D[f"{name}/x"]))
    return y, aux, {"dx": gx, **{"d" + k: v for k, v in gp.items()}}


@pytest.mark.parametrize("name", list(MOE))
def test_sharded_moe_equals_one_device_and_repro(world, name):
    D, got = world
    y, aux, grads, _ = _moe_one_device(D, name)
    jy, jaux, jgrads = _moe_repro(D, name)
    for want in ((y, aux, grads), (jy, jaux, jgrads)):
        _close(got[f"{name}/y"], want[0])
        _close(got[f"{name}/aux"], want[1])
        for k in ("dx", "drouter", "dwi_gate", "dwi_up", "dwo"):
            _close(got[f"{name}/{k}"], want[2][k])


@pytest.mark.parametrize("name", list(MOE))
def test_sharded_routing_is_the_one_device_routing(world, name):
    D, got = world
    r = _moe_one_device(D, name)[3]
    np.testing.assert_array_equal(got[f"{name}/keep"], r.keep.numpy())
    np.testing.assert_array_equal(got[f"{name}/slot"], r.slot.numpy())
    if MOE[name] < 1:
        assert 0.3 < 1 - r.keep.float().mean() < 1  # the one sort drops a good share of the choices


def test_vocab_xent_equals_cross_entropy(world):
    D, got = world
    logits = torch.from_numpy(D["xent/logits"]).requires_grad_()
    want = F.cross_entropy(logits, torch.from_numpy(D["xent/labels"]), reduction="sum")
    want.backward()
    np.testing.assert_allclose(float(got["xent/loss"]), want.item(), rtol=1e-6)
    _close(got["xent/dlogits"], logits.grad)


def test_sharded_chunked_loss_equals_repro(world):
    D, got = world
    jcfg, cfg = _cfgs("llama3-8b")
    want = jlayers.softmax_xent_chunked({"unembed": jnp.asarray(D["chunked/unembed"])}, jnp.asarray(D["chunked/h"]),
                                        jnp.asarray(D["chunked/labels"]), jcfg, chunk=16)
    mine = softmax_xent_chunked({"unembed": torch.from_numpy(D["chunked/unembed"])}, torch.from_numpy(D["chunked/h"]),
                                torch.from_numpy(D["chunked/labels"]), cfg, chunk=16)
    np.testing.assert_allclose(float(got["chunked/loss"]), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(got["chunked/loss"]), float(mine), rtol=1e-6)


def test_sharded_ssm_decode_step_equals_unsharded(world):
    D, got = world
    _, cfg = _cfgs("mamba2-780m")
    p = {k: torch.from_numpy(D[f"ssm/{k}"]) for k in ssm.ssm_def(cfg)}
    cache = {k: torch.from_numpy(D[f"ssm/{k}"].copy()) for k in ("state", "conv")}
    with torch.no_grad():
        out, cache = ssm.ssm_decode_step(p, torch.from_numpy(D["ssm/u"]), cache, cfg)
    _close(got["ssm/out"], out)
    _close(got["ssm/state"], cache["state"])
    _close(got["ssm/conv"], cache["conv"])
