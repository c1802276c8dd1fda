"""The port's sharded checkpoints and ``run_with_recovery`` against
``repro``'s on the CPU.

Both packages write the same files (npz shards, a manifest numbering the
leaves in ``jax.tree_util``'s order, bf16 as its 16-bit words), so each
restores what the other wrote, bit for bit: a ``TrainState`` of reduced
llama3-8b (``repro``'s seeded weights through ``params_from_numpy``, f32
moments, int32 step, error buffers) and a tree with bf16, int32 and a
``None``, in one shard and spread over many. ``repro``'s checkpoint
contracts (``tests/test_checkpoint.py``) run on the port: atomicity,
integrity with a fallback past a corrupted shard, ``.tmp`` directories
ignored, retention and async saves; the async save copies the tree before
it returns, so a step updating it in place cannot reach the files. The
recovering loop gives ``repro``'s history, final state and restored step
after injected failures; a failure inside the in-place AdamW update, which
leaves the state half updated, resumes only from a checkpoint.
"""
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.checkpoint import manager as jmanager
from repro.configs import ARCHS as J_ARCHS, reduced as j_reduced
from repro.models.registry import Model as JModel
from repro.optim import adamw_init as j_adamw_init
from repro.runtime import FaultConfig as JFaultConfig, run_with_recovery as j_run_with_recovery
from repro.train import TrainState as JTrainState
from repro_torch import checkpoint as ckpt
from repro_torch.checkpoint import manager
from repro_torch.configs import ARCHS, reduced
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.models.common import params_from_numpy, tree_leaves
from repro_torch.models.registry import Model
from repro_torch.optim import OptState, adamw
from repro_torch.runtime import FaultConfig, StateSpoiled, run_with_recovery
from repro_torch.train import TrainConfig, TrainState, init_train_state, make_train_step

torch.set_num_threads(1)


@functools.cache
def _jstate():
    """``repro``'s TrainState of reduced llama3-8b with non-zero moments,
    step 3 and error buffers."""
    jp = jax.jit(JModel(j_reduced(J_ARCHS["llama3-8b"])).init)(jax.random.PRNGKey(0))
    bump = lambda x, c: x * c + 0.25
    opt = j_adamw_init(jp)
    opt = opt._replace(step=jnp.asarray(3, jnp.int32), m=jax.tree.map(lambda x: bump(x, 0.1), jp),
                       v=jax.tree.map(lambda x: bump(x, 0.01) ** 2, jp))
    return JTrainState(jp, opt, jax.tree.map(lambda x: bump(x, -0.5), jp))


def _like(jstate):
    """A port TrainState of zeros with ``jstate``'s structure."""
    params = jax.tree.map(np.zeros_like, jstate.params)
    return init_train_state(params_from_numpy(params, device="cpu"), TrainConfig(grad_compression=True))


def _small():
    """A tree of both packages' kinds of leaf: f32, int32, bf16, a NamedTuple
    and a None."""
    g = torch.Generator().manual_seed(0)
    return {"a": torch.randn(16, 8, generator=g),
            "nested": {"b": torch.arange(10, dtype=torch.int32),
                       "c": torch.randn(3, 5, generator=g).to(torch.bfloat16)},
            "opt": OptState(torch.tensor(7, dtype=torch.int32), (torch.ones(2),), (torch.zeros(2),)),
            "none": None}


def _jleaf(t):
    """A port leaf as the jax array ``repro`` would hold."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.fixture(params=[None, 2048], ids=["one shard", "many shards"])
def shard_bytes(request, monkeypatch):
    """Both packages' shard size: their default, or 2 KiB (a shard a leaf)."""
    if request.param:
        monkeypatch.setattr(manager, "_SHARD_BYTES", request.param)
        monkeypatch.setattr(jmanager, "_SHARD_BYTES", request.param)
    return request.param


def test_repro_writes_the_port_restores_a_train_state(tmp_path, shard_bytes):
    js = _jstate()
    jckpt.save_checkpoint(str(tmp_path), 3, js)
    got = ckpt.restore_checkpoint(str(tmp_path), 3, _like(js))
    assert isinstance(got, TrainState) and isinstance(got.opt, OptState)
    assert int(got.opt.step) == 3 and got.opt.step.dtype == torch.int32
    for g, w in zip(tree_leaves(got), jax.tree.leaves(js)):
        assert g.dtype == torch.float32 or g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if shard_bytes:
        with open(tmp_path / "step_00000003" / "manifest.json") as f:
            assert len(json.load(f)["shard_hashes"]) > 10


def test_the_port_writes_repro_restores_a_train_state(tmp_path, shard_bytes):
    js = _jstate()
    state = params_from_numpy(js, device="cpu")  # the same values as port tensors
    state = TrainState(state[0], OptState(*state[1]), state[2])
    ckpt.save_checkpoint(str(tmp_path), 3, state)
    got = jckpt.restore_checkpoint(str(tmp_path), 3, jax.tree.map(jnp.zeros_like, js))
    for g, w in zip(jax.tree.leaves(got), tree_leaves(state)):
        assert np.dtype(g.dtype).name == str(w.dtype).removeprefix("torch.")
        np.testing.assert_array_equal(np.asarray(g), w.numpy())


def test_bf16_int32_and_none_cross_restore_bit_for_bit(tmp_path, shard_bytes):
    tree = _small()
    ckpt.save_checkpoint(str(tmp_path / "port"), 1, tree)
    jlike = jax.tree.map(lambda x: jnp.zeros(x.shape, _jleaf(x).dtype), tree_leaves(tree))
    got = jckpt.restore_checkpoint(str(tmp_path / "port"), 1, jlike)
    for g, t in zip(got, tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(_jleaf(t)))
        assert g.dtype == _jleaf(t).dtype
    jckpt.save_checkpoint(str(tmp_path / "repro"), 1, [_jleaf(t) for t in tree_leaves(tree)])
    back = ckpt.restore_checkpoint(str(tmp_path / "repro"), 1, tree)
    assert back["none"] is None and isinstance(back["opt"], OptState)
    for b, t in zip(tree_leaves(back), tree_leaves(tree)):
        assert b.dtype == t.dtype and torch.equal(b, t)
    # bf16 is stored as its 16-bit words under the name bfloat16, as repro stores it
    for d in ("port", "repro"):
        with open(tmp_path / d / "step_00000001" / "manifest.json") as f:
            assert json.load(f)["leaf_dtypes"]["leaf_00002"] == "bfloat16"


def test_restore_onto_another_device_and_dtype(tmp_path):
    tree = {"w": torch.randn(4, 4)}
    ckpt.save_checkpoint(str(tmp_path), 2, tree)
    got = ckpt.restore_checkpoint(str(tmp_path), 2, {"w": torch.zeros(4, 4, dtype=torch.float64)})
    assert got["w"].dtype == torch.float64 and torch.equal(got["w"], tree["w"].double())


# ---------------------------------------------------- repro's contracts


def test_latest_step_picks_newest_valid(tmp_path):
    t = _small()
    ckpt.save_checkpoint(str(tmp_path), 1, t)
    ckpt.save_checkpoint(str(tmp_path), 5, t)
    assert ckpt.latest_step(str(tmp_path)) == jckpt.latest_step(str(tmp_path)) == 5


def test_corrupted_shard_falls_back(tmp_path):
    t = _small()
    ckpt.save_checkpoint(str(tmp_path), 1, t)
    ckpt.save_checkpoint(str(tmp_path), 2, t)
    shard = os.path.join(str(tmp_path), "step_00000002", "shard_00000.npz")
    with open(shard, "r+b") as f:
        f.seek(10)
        f.write(b"\xde\xad\xbe\xef")
    assert ckpt.latest_step(str(tmp_path)) == jckpt.latest_step(str(tmp_path)) == 1
    with pytest.raises(ValueError, match="corrupt"):
        ckpt.restore_checkpoint(str(tmp_path), 2, t)
    step, out = ckpt.CheckpointManager(str(tmp_path)).restore_latest(t)
    assert step == 1 and torch.equal(out["a"], t["a"])


def test_a_compressed_shard_is_refused(tmp_path):
    """A leaf is read straight from its stored npz member; a shard written
    compressed (by neither package) raises instead of giving its bytes."""
    t = _small()
    path = ckpt.save_checkpoint(str(tmp_path), 1, t)
    shard = os.path.join(path, "shard_00000.npz")
    with np.load(shard) as z:
        arrays = {k: z[k] for k in z.files}
    np.savez_compressed(shard, **arrays)
    mpath = os.path.join(path, "manifest.json")
    with open(mpath) as f:
        m = json.load(f)
    m["shard_hashes"]["shard_00000.npz"] = manager.sha256_file(shard)
    with open(mpath, "w") as f:
        json.dump(m, f)
    with pytest.raises(ValueError, match="compressed"):
        ckpt.restore_checkpoint(str(tmp_path), 1, t)


def test_tmp_dirs_ignored(tmp_path):
    t = _small()
    ckpt.save_checkpoint(str(tmp_path), 1, t)
    os.makedirs(os.path.join(str(tmp_path), "step_00000009.tmp-abc"))
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_a_failed_write_leaves_no_step_dir(tmp_path):
    with pytest.raises(TypeError):  # numpy holds no complex32
        ckpt.save_checkpoint(str(tmp_path), 4, {"ok": torch.ones(3), "bad": torch.zeros(2, dtype=torch.complex32)})
    assert os.listdir(tmp_path) == [] and ckpt.latest_step(str(tmp_path)) is None


def test_manager_retention_and_async(tmp_path):
    t = _small()
    cm = ckpt.CheckpointManager(str(tmp_path), keep_n=2, save_async=True)
    for s in (1, 2, 3, 4):
        cm.save(s, t)
    cm.wait()
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(str(tmp_path)) if d.startswith("step_"))
    assert steps == [3, 4]


def test_async_save_is_a_snapshot(tmp_path):
    """A step that updates the state in place right after ``save`` returns
    does not reach the checkpoint being written."""
    w = torch.arange(1 << 20, dtype=torch.float32)
    cm = ckpt.CheckpointManager(str(tmp_path), save_async=True)
    cm.save(1, {"w": w})
    w.add_(1.0)
    cm.wait()
    got = ckpt.restore_checkpoint(str(tmp_path), 1, {"w": torch.zeros_like(w)})
    assert torch.equal(got["w"], w - 1.0)


def test_manager_restore_latest_empty(tmp_path):
    like = {"x": torch.zeros(3)}
    step, tree = ckpt.CheckpointManager(str(tmp_path)).restore_latest(like)
    assert step is None and tree is like


def test_structure_mismatch_rejected(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 1, _small())
    with pytest.raises(AssertionError):
        ckpt.restore_checkpoint(str(tmp_path), 1, {"only_one_leaf": torch.zeros(3)})


# ------------------------------------------------------------- recovery


class FlakyStep:
    """Fails at given step indices, once each (``tests/test_fault.py``'s);
    ``xp`` makes the state's arrays (jnp or torch)."""

    def __init__(self, fail_at, xp):
        self.fail_at, self.xp, self.calls = set(fail_at), xp, 0

    def __call__(self, state, batch):
        self.calls += 1
        step = int(state["step"])
        if step in self.fail_at:
            self.fail_at.discard(step)
            raise RuntimeError(f"injected failure at step {step}")
        return {"step": state["step"] + 1, "w": state["w"] + self.xp(float(batch))}, {"loss": float(step)}


class Batches:
    def batch_at(self, i):
        return np.float32(i)


@pytest.mark.parametrize("fail_at,start,ckpt_every", [((7,), 0, 2), ((3, 8), 0, 3), ((6,), 5, 0)],
                         ids=["one failure", "two failures", "a checkpoint before start_step"])
def test_run_with_recovery_equals_repro(tmp_path, fail_at, start, ckpt_every):
    runs = {}
    for name, xp, mod, mgr, fault in (
            ("repro", jnp.asarray, j_run_with_recovery, jckpt.CheckpointManager, JFaultConfig),
            ("port", torch.tensor, run_with_recovery, ckpt.CheckpointManager, FaultConfig)):
        cm = mgr(str(tmp_path / name), keep_n=3)
        if not ckpt_every:  # a manager shared across runs: its checkpoint predates start_step
            cm.save(2, {"step": xp(2), "w": xp(1.0)})
        state = {"step": xp(start), "w": xp(float(sum(range(start))))}
        step_fn = FlakyStep(fail_at, xp)
        final, hist = mod(step_fn, state, Batches(), num_steps=10, ckpt_manager=cm, ckpt_every=ckpt_every,
                          fault_cfg=fault(max_retries=2, backoff_base_s=0.0), start_step=start)
        runs[name] = (int(final["step"]), float(final["w"]), [h["loss"] for h in hist], step_fn.calls)
    assert runs["port"] == runs["repro"]
    assert runs["port"][0] == 10 and runs["port"][1] == sum(range(10))


def test_run_with_recovery_raises_after_max_retries():
    def always(state, batch):
        raise RuntimeError("down")

    with pytest.raises(RuntimeError, match="down"):
        run_with_recovery(always, {}, Batches(), num_steps=2, fault_cfg=FaultConfig(max_retries=1,
                                                                                      backoff_base_s=0.0))


class FailInsideUpdate:
    """``adamw._leaf_`` that raises once, at the second leaf of the update
    of step ``at``: the first leaf is already overwritten."""

    def __init__(self, at: int, n_leaves: int):
        self.call, self.fail_call = 0, at * n_leaves + 1

    def __call__(self, *args):
        self.call += 1
        if self.call - 1 == self.fail_call:
            raise RuntimeError("injected failure between two leaves")
        return LEAF_(*args)


LEAF_ = adamw._leaf_


class TorchBatches:
    def __init__(self, cfg):
        self.data = SyntheticLM(DataConfig(cfg.vocab_size, 8, 2))

    def batch_at(self, i):
        return {k: torch.from_numpy(np.array(v)) for k, v in self.data.batch_at(i).items()}


def _train_run(tmp_path, monkeypatch, fail_at, ckpt_every):
    """Four train steps of reduced llama3-8b (1 layer, f32, B=2, S=8) under
    ``run_with_recovery``, the update of step ``fail_at`` failing between
    two leaves (None: no failure); ``ckpt_every`` 0 runs with no manager."""
    cfg = dataclasses.replace(reduced(ARCHS["llama3-8b"]), num_layers=1, compute_dtype="float32")
    state = init_train_state(Model(cfg).init(torch.Generator().manual_seed(0), device="cpu"), TrainConfig())
    if fail_at is not None:
        monkeypatch.setattr(adamw, "_leaf_", FailInsideUpdate(fail_at, len(tree_leaves(state.params))))
    cm = ckpt.CheckpointManager(str(tmp_path), keep_n=2) if ckpt_every else None
    return run_with_recovery(make_train_step(cfg, TrainConfig()), state, TorchBatches(cfg), num_steps=4,
                             ckpt_manager=cm, ckpt_every=ckpt_every, fault_cfg=FaultConfig(backoff_base_s=0.0))


@pytest.mark.parametrize("fail_at,ckpt_every", [(1, 0), (1, 2), (2, 2)],
                         ids=["no manager", "no checkpoint yet", "after a checkpoint"])
def test_a_failure_inside_the_update_resumes_only_from_a_checkpoint(tmp_path, monkeypatch, fail_at, ckpt_every):
    """The half-updated state is never replayed: with no checkpoint to
    restore the failure raises; after one, the run restores it and ends
    with the clean run's history and state, bit for bit."""
    if not ckpt_every or fail_at < ckpt_every:  # nothing saved before the failure
        with pytest.raises(StateSpoiled) as err:
            _train_run(tmp_path, monkeypatch, fail_at, ckpt_every)
        assert "between two leaves" in str(err.value.__cause__)
        return
    got_state, got_hist = _train_run(tmp_path / "faulty", monkeypatch, fail_at, ckpt_every)
    monkeypatch.setattr(adamw, "_leaf_", LEAF_)
    want_state, want_hist = _train_run(tmp_path / "clean", monkeypatch, None, ckpt_every)
    assert [{k: float(v) for k, v in h.items()} for h in got_hist] == \
        [{k: float(v) for k, v in h.items()} for h in want_hist]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got_state), tree_leaves(want_state)))
