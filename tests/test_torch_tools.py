"""The port's dev tools (``repro_torch.tools``) against ``repro``'s, on the CPU.

``make_golden`` run into a temporary directory writes the seven fixtures
equal to the committed ``tests/golden_torch/`` arrays bit for bit (they
were written by torch 2.13 at one thread, which ``make_golden`` pins; on
another torch version the CPU's convolutions may round otherwise, and
``tests/test_torch_golden.py`` holds the bands).

``perf_iterate``'s cell mode on reduced cells over a (data=2, model=4)
``ShapeMesh``: its counts (FLOPs, matrix-product FLOPs, op bytes,
collectives, argument and peak bytes) and roofline row equal
``launch.dryrun.run_cell``'s for the same knobs; ``--no-remat`` counts
fewer FLOPs than remat, ``--grad-compression`` adds the f32 error buffers
(4 bytes a parameter) to the argument bytes, ``--serve-dtype float32``
moves more bytes than bfloat16. (``tests/test_torch_cells.py`` counts
the two knob cells of ``chip_smoke.py``'s tools phase on a fake process
group of 8 ranks.)

The adaptive record on ``reduced(llama3-8b)`` at f32 compute against
``repro``'s engine served ``repro``'s way (``tools/perf_iterate.py``'s
warm round, then the measured round) on the same weights through
``lm.params_from_numpy`` (``tests/test_torch_engine.py``'s recipe):
``requests``, ``ladder``, ``m_used_hist``, ``total_steps``,
``launched_steps`` and ``probe_forwards`` equal, and ``converged`` too but
where a request's δ lies within 1e-7 of its threshold; ``mean_delta`` to
1e-6 plus 1e-4 of the mean |f(x) − f(x′)|.

``render_experiments`` on ``run_cell`` records of two reduced cells, a
skipped one and an injected error: a row for each, GB from the port's
``memory`` fields, and the numeric cells of ``roofline_table`` equal to
``repro``'s ``tools/render_experiments.roofline_table`` on the same
records (it imports no JAX).
"""
import dataclasses
import functools
import importlib.util
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as J_ARCHS, reduced as j_reduced
from repro.configs.paper_cnn import CONFIG as J_CNN
from repro.models import cnn as jcnn
from repro.models.registry import Model as JModel
from repro.serve import ExplainEngine as JEngine, ExplainRequest as JRequest
from repro_torch.configs import ARCHS, ShapeConfig, reduced
from repro_torch.launch import dryrun
from repro_torch.launch.cells import ShapeMesh
from repro_torch.launch.explain import make_traffic
from repro_torch.models import lm
from repro_torch.models.common import tree_leaves
from repro_torch.tools import make_golden as mg
from repro_torch.tools import perf_iterate as pi
from repro_torch.tools import render_experiments as rx

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "golden_torch"


def _repro_tool(name: str):
    """A module of ``repro``'s ``tools/`` (the ones that import no JAX)."""
    spec = importlib.util.spec_from_file_location(f"repro_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------------ make_golden


def test_make_golden_writes_the_committed_fixtures(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(mg, "GOLDEN_DIR", str(tmp_path))
    written = mg.main(["--device", "cpu"])
    assert sorted(os.path.basename(p) for p in written) == sorted(os.listdir(GOLDEN))
    assert len(written) == 7 and "cnn_lime.npz" in capsys.readouterr().out
    for path in written:
        got, want = np.load(path), np.load(GOLDEN / os.path.basename(path))
        assert sorted(got.files) == sorted(want.files) == ["attributions", "delta", "f_baseline", "f_x", "meta"]
        for k in want.files:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (path, k)
    before = {p: os.path.getmtime(p) for p in written}
    assert len(mg.main(["--device", "cpu", "--forward-only"])) == 3
    assert [p for p in written if os.path.getmtime(p) != before[p]] == [
        str(tmp_path / f"cnn_{m}.npz") for m in ("lime", "occlusion", "rise")]


def test_golden_weights_follow_repros_layout():
    tree, x, t = mg.golden_arrays()
    jtree = jax.eval_shape(lambda: jcnn.init(J_CNN, jax.random.PRNGKey(0)))
    assert jax.tree.structure(jtree) == jax.tree.structure(tree)
    assert [a.shape for a in jax.tree.leaves(jtree)] == [a.shape for a in jax.tree.leaves(tree)]
    assert x.shape == (2, 32, 32, 3) and x.dtype == np.float32 and 0 <= x.min() and x.max() < 1
    assert t.tolist() == [1, 2]
    w = tree["block0"]["t3b"]  # HWIO (3, 3, 8, 16): std 1/sqrt(3·3·8)
    assert abs(w.std() * np.sqrt(72) - 1) < 0.1 and not tree["head"]["b"].any()


def test_make_golden_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        mg.main(["--device", "cuda"])


# ------------------------------------------------------------ perf_iterate cells

MESH = {"data": 2, "model": 4}
SMALL = {"train": ShapeConfig("c_train", 64, 8, "train"), "prefill": ShapeConfig("c_prefill", 64, 8, "prefill"),
         "decode": ShapeConfig("c_decode", 64, 8, "decode")}


def _args(*flags):
    return pi.parser().parse_args(["llama3-8b", "train_4k", *flags])


@functools.cache
def _cell(kind: str, flags: tuple):
    shape = SMALL[kind]
    mesh = ShapeMesh(tuple(MESH.values()), tuple(MESH))
    return pi.iterate_cell(reduced(ARCHS["llama3-8b"]), shape, mesh, "2x4", top=4,
                           **pi.cell_knobs(shape, _args(*flags)))


KNOB_CELLS = [("train", ("--microbatches", "2")), ("train", ("--microbatches", "2", "--no-remat")),
              ("train", ("--microbatches", "2", "--grad-compression")), ("prefill", ()),
              ("prefill", ("--serve-dtype", "bfloat16")), ("decode", ("--serve-dtype", "bfloat16"))]


@pytest.mark.parametrize("kind,flags", KNOB_CELLS, ids=[f"{k}{''.join(f)}" for k, f in KNOB_CELLS])
def test_cell_counts_equal_run_cell(kind, flags, monkeypatch):
    got = _cell(kind, flags)
    shape = SMALL[kind]
    monkeypatch.setitem(dryrun.ARCHS, "llama3-8b", reduced(ARCHS["llama3-8b"]))
    monkeypatch.setitem(dryrun.SHAPES_BY_NAME, shape.name, shape)
    want = dryrun.run_cell("llama3-8b", shape.name, ShapeMesh(tuple(MESH.values()), tuple(MESH)), "2x4",
                           **pi.cell_knobs(shape, _args(*flags)))
    assert want["status"] == "ok", want
    assert (got["flops"], got["bytes"]) == (want["cost"]["flops"], want["cost"]["bytes accessed"])
    assert (got["dots"], got["num_dots"]) == (want["dots"]["total_dot_flops"], want["dots"]["num_dots"])
    assert got["collectives"] == want["collectives"]
    assert (got["argument_bytes"], got["peak_bytes"]) == (want["memory"]["argument_bytes"],
                                                          want["memory"]["peak_bytes"])
    unnamed = lambda row: {k: v for k, v in row.items() if k != "arch"}  # the reduced config's own name
    assert unnamed(got["roofline"]) == unnamed(want["roofline"]) and got["chips"] == want["chips"] == 8
    assert len(got["top_dots"]) == 4 and len(got["top_ops"]) == 4
    lines = pi.cell_lines(got)
    assert f"flops {int(got['flops'])} " in lines[4] and f"peak bytes {int(got['peak_bytes'])}" in lines[4]


def test_knobs_move_the_counts():
    plain = _cell("train", ("--microbatches", "2"))
    no_remat = _cell("train", ("--microbatches", "2", "--no-remat"))
    comp = _cell("train", ("--microbatches", "2", "--grad-compression"))
    assert no_remat["flops"] < plain["flops"]
    n_params = sum(p.numel() for p in tree_leaves(lm.abstract_params(reduced(ARCHS["llama3-8b"]))))
    assert comp["argument_bytes"] - plain["argument_bytes"] == 4 * n_params
    assert _cell("prefill", ())["bytes"] > _cell("prefill", ("--serve-dtype", "bfloat16"))["bytes"]
    assert _args().serve_dtype == "float32" and _args().microbatches == 8


# ------------------------------------------------------- perf_iterate adaptive


def _cfgs():
    return (dataclasses.replace(j_reduced(J_ARCHS["llama3-8b"]), compute_dtype="float32"),
            dataclasses.replace(reduced(ARCHS["llama3-8b"]), compute_dtype="float32"))


def _jax_record(jcfg, params, reqs, args) -> tuple[dict, list]:
    """``repro``'s ``explain_adaptive_bench`` round for round, on given
    weights and requests (its module sets XLA_FLAGS at import)."""
    eng = JEngine(jcfg, params, method=args.method, schedule=args.schedule, m=args.base_m, n_int=4,
                  adaptive=True, tol=args.tol, m_max=args.m_max)
    eng.explain(reqs)
    a = eng.stats.adaptive
    warm = (a.total_steps, a.launched_steps, a.probe_forwards, a.converged, a.requests)
    out = eng.explain(reqs)
    return {
        "ladder": list(eng.m_ladder), "requests": a.requests - warm[4], "total_steps": a.total_steps - warm[0],
        "launched_steps": a.launched_steps - warm[1], "probe_forwards": a.probe_forwards - warm[2],
        "converged": a.converged - warm[3], "m_used_hist": {str(k): v for k, v in sorted(a.m_used.items())},
        "mean_delta": float(np.mean([o["delta"] for o in out])),
    }, out


def test_adaptive_record_matches_repro(tmp_path, monkeypatch):
    jcfg, tcfg = _cfgs()
    jparams = JModel(jcfg).init(jax.random.PRNGKey(0))
    args = pi.parser().parse_args(["--explain-adaptive", "--device", "cpu"])
    reqs = make_traffic(tcfg, args.requests, 9, 32, np.random.default_rng(args.seed))
    want, jout = _jax_record(jcfg, jparams, [JRequest(r.tokens, r.target) for r in reqs], args)
    rec, eng = pi.explain_adaptive_record(tcfg, lm.params_from_numpy(jparams, device="cpu"), reqs, args, "cpu")
    assert rec["requests"] == want["requests"] == 8 and rec["ladder"] == want["ladder"] == [8, 16, 32, 64]
    for k in ("m_used_hist", "total_steps", "launched_steps", "probe_forwards"):
        assert rec[k] == want[k], (k, rec[k], want[k])
    tout = eng.explain(reqs)  # a replay: the same per-request results the record was made of
    near = sum(min(abs(t["delta"] - t["threshold"]), abs(j["delta"] - j["threshold"])) <= 1e-7
               for t, j in zip(tout, jout))
    assert abs(rec["converged"] - want["converged"]) <= near
    spread = float(np.mean([abs(o["f_x"] - o["f_baseline"]) for o in jout]))
    assert abs(rec["mean_delta"] - want["mean_delta"]) <= 1e-6 + 1e-4 * spread
    assert rec["cache_misses"] == rec["cache_misses_warm"] == eng.stats.misses > 0
    assert rec["device"] == "cpu" and rec["torch"] == torch.__version__ and rec["attn"] == "auto"


def test_adaptive_cli_appends_to_the_trajectory(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(pi, "TRAJECTORY", str(tmp_path / "results" / "trajectory_torch.jsonl"))
    for note in ("a", "b"):
        rec = pi.main(["--explain-adaptive", "--device", "cpu", "--requests", "3", "--note", note])
        assert 8 <= rec["mean_m_used"] <= 64 and rec["requests"] == 3
    lines = (tmp_path / "results" / "trajectory_torch.jsonl").read_text().splitlines()
    assert [json.loads(x)["note"] for x in lines] == ["a", "b"]
    assert "appended to" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        pi.main(["--explain-adaptive", "--device", "cuda"])


# --------------------------------------------------------- render_experiments


@pytest.fixture(scope="module")
def records():
    mesh = ShapeMesh((2, 4))
    mp = pytest.MonkeyPatch()
    try:
        mp.setitem(dryrun.ARCHS, "llama3-8b", reduced(ARCHS["llama3-8b"]))
        mp.setitem(dryrun.ARCHS, "mamba2-780m", reduced(ARCHS["mamba2-780m"]))
        for s in SMALL.values():
            mp.setitem(dryrun.SHAPES_BY_NAME, s.name, s)
        recs = [dryrun.run_cell("llama3-8b", "c_train", mesh, "2x4", microbatches=2),
                dryrun.run_cell("mamba2-780m", "c_decode", mesh, "2x4"),
                dryrun.run_cell("llama3-8b", "long_500k", mesh, "2x4")]
        mp.setattr(dryrun, "build_cell", lambda *a, **k: (_ for _ in ()).throw(RuntimeError("injected")))
        recs.append(dryrun.run_cell("llama3-8b", "c_prefill", mesh, "2x4"))
    finally:
        mp.undo()
    return {f"{r['arch']}:{r['shape']}": r for r in recs}


def test_render_has_a_row_for_each_cell(records):
    assert [r["status"] for r in records.values()] == ["ok", "ok", "skipped", "error"]
    table = rx.dryrun_table(records)
    rows = {line.split(" | ")[0][2:]: line for line in table.splitlines()[2:]}
    assert set(rows) == set(records)
    assert "skipped — " in rows["llama3-8b:long_500k"] and "ERROR RuntimeError: injected" in rows["llama3-8b:c_prefill"]
    for key in ("llama3-8b:c_train", "mamba2-780m:c_decode"):
        mem = records[key]["memory"]
        cells = rows[key].split(" | ")
        assert cells[2:4] == [f"{mem['argument_bytes'] / 1e9:.2f}", f"{mem['peak_bytes'] / 1e9:.2f}"]
        assert float(cells[4]) == pytest.approx(records[key]["cost"]["flops"], rel=1e-2)


def test_roofline_table_numbers_equal_repros(records):
    ref = _repro_tool("render_experiments").roofline_table(records)
    got = rx.roofline_table(records)
    numeric = lambda table: [line.split(" | ")[:7] for line in table.splitlines()[2:]]
    assert len(numeric(got)) == 2 and numeric(got) == numeric(ref)


def test_render_writes_the_port_file(records, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(rx, "RESULTS", str(tmp_path))
    monkeypatch.setattr(rx, "OUT", str(tmp_path / "EXPERIMENTS_torch.md"))
    (tmp_path / "dryrun_torch_pod16x16.json").write_text(json.dumps(records))
    (tmp_path / "trajectory_torch.jsonl").write_text(json.dumps(
        {"ts": "t", "device": "cpu", "arch": "llama3-8b", "layers": 2, "method": "ig", "schedule": "paper",
         "tol": 0.01, "ladder": [8, 16], "requests": 8, "mean_m_used": 9.0, "total_steps": 72,
         "launched_steps": 80, "latency_per_req_ms": 5.0, "cache_misses": 3, "mean_delta": 0.004, "note": "n"}) + "\n")
    assert rx.main([]) == str(tmp_path / "EXPERIMENTS_torch.md")
    doc = (tmp_path / "EXPERIMENTS_torch.md").read_text()
    assert "2 ok / 1 skipped" in doc and "0 ok / 0 skipped" in doc and "| t | cpu | llama3-8b (2) |" in doc
    assert "Benchmarks: none yet" in doc
    for tpu_word in ("v5e", "VMEM", "XLA", "HLO", "197e12"):
        assert tpu_word not in doc, tpu_word
