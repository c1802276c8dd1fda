"""The dry run's cells on a sharded world: ``tests/test_cells.py``'s five
cases on the port, and the reduced cells whose counts ``chip_smoke.py``
holds on the card's host.

Runs in a SUBPROCESS: the world is a fake process group of 8 ranks
(``torch.testing``'s ``FakeStore``) on a (data=2, model=4) DeviceMesh,
which is process-global, and pytest-xdist reuses its workers across files.
The reduced cells are counted on ``meta`` local shards
(``launch.cells.count_cell``): each counts FLOPs, the MoE and hybrid cells
too (their routing sorts all of a call's tokens on every rank); the train
cells move bytes through collectives; llama3-8b's step counts the same
FLOPs at microbatches 2 and 1 (a microbatch is a slice of each rank's
rows); the seven cells of ``chip_smoke.py``'s phase 27 (qwen3-moe train
and decode, jamba prefill, jamba decode at B=1 below the data size, so
sequence-sharded, mamba2 decode, llama3-8b train, gemma3 prefill, whose
local layers roll their rings) count exactly the FLOPs,
matrix-product FLOPs and collective bytes by kind of its
``DRYRUN_REDUCED``, which the card's host (another torch version) must
count too, and so do its tools phase's two knob cells (llama3-8b train
through ``tools.perf_iterate`` under ``--grad-compression`` and under
``--no-remat``, ``TOOLS_KNOB_CELLS``); ``launch.op_trace`` logs what
``OpCounter`` counts; and one
sharded matrix product, (B/dp·S, D) @ (D, F/tp), counts 2·B/dp·S·D·F/tp
FLOPs on a rank, the rank's share and not the global product's.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
CASES = ("llama3-8b:train:64:8:2", "qwen3-moe-30b-a3b:train:64:8:1", "mamba2-780m:decode:256:8:0",
         "gemma3-27b:prefill:256:8:0", "whisper-tiny:decode:256:8:0", "llama3-8b:train:64:8:1",
         "qwen3-moe-30b-a3b:decode:256:8:0", "jamba-v0.1-52b:prefill:256:8:0", "jamba-v0.1-52b:decode:256:1:0")

_SCRIPT = r"""
import json
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.configs import ARCHS, ShapeConfig, reduced
from repro_torch.launch.cells import build_cell, count_cell
from repro_torch.roofline.op_counts import OpCounter

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
out = {}
for key in CASES:
    arch, kind, S, B, mb = key.split(":")
    kw = {"microbatches": int(mb)} if kind == "train" else {}
    c = count_cell(build_cell(reduced(ARCHS[arch]), ShapeConfig(kind, int(S), int(B), kind), mesh, **kw))
    out[key] = {"flops": c["flops"], "dots": c["dots"]["total_dot_flops"], "peak": c["peak_bytes"],
                "args": c["argument_bytes"], "collectives": c["collectives"]["total"],
                "by_kind": {k: v for k, v in c["collectives"].items() if v and k != "total"}}

from repro_torch.tools import perf_iterate as pi
shape = ShapeConfig("train", 64, 8, "train")
for flag in KNOBS:
    args = pi.parser().parse_args(["llama3-8b", "train_4k", "--microbatches", "1", flag])
    r = pi.iterate_cell(reduced(ARCHS["llama3-8b"]), shape, mesh, "2x4", **pi.cell_knobs(shape, args))
    out[flag] = [r["flops"], r["dots"], {k: v for k, v in r["collectives"].items() if v and k != "total"}]

from repro_torch.launch.op_trace import OpTrace, sites
tracer = OpTrace()
c = count_cell(build_cell(reduced(ARCHS["qwen3-moe-30b-a3b"]), ShapeConfig("decode", 256, 8, "decode"), mesh),
               counter=tracer)
out["trace"] = {"flops": c["flops"], "ops": c["ops"], "logged": len(tracer.log), "sites": sites(tracer.log),
                "collectives": c["collectives"]["total"]}

B, S, D, F = 8, 64, 256, 512
x = DTensor.from_local(torch.empty(B // 2 * S, D, device="meta", dtype=torch.bfloat16), mesh,
                       (Shard(0), Replicate()), run_check=False)
w = DTensor.from_local(torch.empty(D, F // 4, device="meta", dtype=torch.bfloat16), mesh,
                       (Replicate(), Shard(1)), run_check=False)
with OpCounter() as oc:
    y = x @ w
out["matmul"] = {"flops": oc.flops, "hand": 2 * (B // 2 * S) * D * (F // 4), "placements": str(y.placements)}
print(json.dumps(out))
"""


def _smoke():
    """``chip_smoke.py`` (the script imports only torch at its top)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smoke_counts() -> dict:
    """``chip_smoke.py``'s ``DRYRUN_REDUCED``."""
    return _smoke().DRYRUN_REDUCED


@pytest.fixture(scope="module")
def cells():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = f"CASES = {CASES!r}\nKNOBS = {sorted(_smoke().TOOLS_KNOB_CELLS)!r}\n" + _SCRIPT
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_each_cell_counts(cells):
    assert len(cells) == len(CASES) + 2 + len(_smoke().TOOLS_KNOB_CELLS)
    for k, v in cells.items():
        if k in ("matmul", "trace") or k.startswith("--"):
            continue
        assert v["flops"] > 0 and v["peak"] >= v["args"] > 0, (k, v)


def test_train_cells_move_bytes_through_collectives(cells):
    assert cells["llama3-8b:train:64:8:2"]["collectives"] > 0
    assert cells["llama3-8b:train:64:8:1"]["collectives"] > 0
    assert cells["qwen3-moe-30b-a3b:train:64:8:1"]["collectives"] > 0


def test_microbatches_keep_the_flops(cells):
    assert cells["llama3-8b:train:64:8:2"]["flops"] == cells["llama3-8b:train:64:8:1"]["flops"]


@pytest.mark.parametrize("key", sorted(_smoke_counts()))
def test_counts_equal_the_smokes(cells, key):
    """The counts ``chip_smoke.py`` holds the card's host (torch 2.11) to."""
    flops, dots, by_kind = _smoke_counts()[key]
    got = cells[key]
    assert (got["flops"], got["dots"], got["by_kind"]) == (flops, dots, by_kind), (key, got)


@pytest.mark.parametrize("flag", sorted(_smoke().TOOLS_KNOB_CELLS))
def test_knob_cells_equal_the_smokes(cells, flag):
    """``perf_iterate``'s knob cells that ``chip_smoke.py``'s tools phase
    holds the card's host to; remat off counts fewer FLOPs."""
    flops, dots, by_kind = cells[flag]
    assert (flops, dots, by_kind) == _smoke().TOOLS_KNOB_CELLS[flag], (flag, cells[flag])
    assert cells["--no-remat"][0] < cells["llama3-8b:train:64:8:1"]["flops"] == cells["--grad-compression"][0]


def test_op_trace_logs_what_the_counter_counts(cells):
    """``launch.op_trace``: the same counts, one log entry an op, and the
    collectives by site adding up to the total (the routing's all-gather
    of the picks among them)."""
    t, plain = cells["trace"], cells["qwen3-moe-30b-a3b:decode:256:8:0"]
    assert t["flops"] == plain["flops"] and t["logged"] == t["ops"] > 0
    assert sum(int(line.split(" B ")[0]) for line in t["sites"]) == t["collectives"] == plain["collectives"]
    assert any("all-gather int64" in line and "models/moe.py" in line for line in t["sites"]), t["sites"]


def test_one_sharded_matmul_counts_a_ranks_share(cells):
    m = cells["matmul"]
    assert m["flops"] == m["hand"], m
    assert m["placements"] == "(Shard(dim=0), Shard(dim=1))"
