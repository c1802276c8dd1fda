"""Multi-pod dry run of the port: ``repro.launch.dryrun`` over DTensor.

Counts every (architecture × input-shape) cell on the production meshes
at full published width and depth, on the ``meta`` device (shapes only,
nothing allocated, no card needed), and records one rank's FLOPs, bytes,
collectives and peak memory with the roofline terms on ``HW_H100``:

    PYTHONPATH=src python -m repro_torch.launch.dryrun                 # all cells, 1-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod     # 2-pod mesh
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --jobs 8        # 8 cells at a time
    PYTHONPATH=src python -m repro_torch.launch.dryrun --compare A.json B.json   # two sweeps, cell by cell

Results go to ``results/dryrun_torch_<mesh>.json`` (incremental; safe to
re-run a subset; ``repro``'s ``dryrun_<mesh>.json`` is never touched).

Each cell runs its step once under ``roofline.op_counts.OpCounter``
(``launch.cells.count_cell``), its arguments DTensors of ``meta`` local
shards over a fake process group of the mesh's size. There is no costing
pass: the port's layer and microbatch loops are Python loops, so every
layer and microbatch is counted as it runs (``repro``'s ``costing_mode``
and ``cost_analysis_dict`` have no counterpart). ``memory`` is one rank's
argument bytes and the peak of its live bytes, not XLA's
``memory_analysis``; ``cost["bytes accessed"]`` is the eager program's
traffic (every op's inputs and outputs), not a fusion-aware estimate.
A cell whose step DTensor cannot run sharded ends in ``status: "error"``
with the exception and a traceback tail: failures are the dry run's output.
With ``--jobs N`` each cell is counted in a child process of its own
(the fake process group is process-global), N at a time, and the children's
records are merged into the results file.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

from repro_torch.configs import ARCHS, LM_SHAPES, SHAPES_BY_NAME, shape_applicable
from repro_torch.launch.cells import build_cell, count_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline import HW_H100, model_flops, roofline_report

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results")


def run_cell(arch_name: str, shape_name: str, mesh, mesh_name: str, **kw) -> dict:
    """One cell's record: ``status`` ``ok`` (with ``cost``, ``memory``,
    ``collectives``, ``dots`` and the ``roofline`` row), ``skipped`` (with
    the reason) or ``error`` (with the exception and a traceback tail)."""
    cfg = ARCHS[arch_name]
    shape = SHAPES_BY_NAME[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh_name}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    t0 = time.time()
    try:
        counts = count_cell(build_cell(cfg, shape, mesh, **kw))
        chips = mesh.size()
        cost = {"flops": float(counts["flops"]), "bytes accessed": float(counts["bytes accessed"])}
        report = roofline_report(
            arch=arch_name,
            shape=shape_name,
            mesh_name=mesh_name,
            chips=chips,
            cost=cost,
            coll_bytes_per_chip=counts["collectives"]["total"],
            mflops=model_flops(cfg, shape),
            hw=HW_H100,
            peak_bytes_per_chip=float(counts["peak_bytes"]),
        )
        rec.update(
            status="ok",
            seconds=round(time.time() - t0, 1),
            chips=chips,
            cost=cost,
            memory={"argument_bytes": counts["argument_bytes"], "peak_bytes": counts["peak_bytes"]},
            collectives=counts["collectives"],
            dots={k: counts["dots"][k] for k in ("total_dot_flops", "num_dots")},
            ops=counts["ops"],
            roofline=report.row(),
        )
    except Exception as e:  # noqa: BLE001 — failures ARE the dry-run output
        rec.update(
            status="error",
            seconds=round(time.time() - t0, 1),
            error=f"{type(e).__name__}: {e}",
            traceback=traceback.format_exc()[-2000:],
        )
    return rec


def load_results(path: str) -> dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {}


COUNTED = ("flops", "total_dot_flops", "collectives")


def compare(a: dict, b: dict) -> list[str]:
    """Two sweeps' records (``load_results``), cell by cell: each cell's
    statuses, and for a cell ``ok`` in both whether its FLOPs,
    matrix-product FLOPs and collective bytes by kind are equal, with both
    peaks; one line a cell, and a last line counting the cells that part."""
    lines, apart = [], 0
    for key in sorted(set(a) | set(b)):
        ra, rb = a.get(key, {}), b.get(key, {})
        sa, sb = ra.get("status"), rb.get("status")
        if sa != "ok" or sb != "ok":
            lines.append(f"{key:40s} {sa} / {sb}")
            apart += sa != sb
            continue
        got = [(ra["cost"]["flops"], rb["cost"]["flops"]),
               (ra["dots"]["total_dot_flops"], rb["dots"]["total_dot_flops"]), (ra["collectives"], rb["collectives"])]
        same = [x == y for x, y in got]
        apart += not all(same)
        parts = ", ".join(f"{n} {'equal' if eq else f'{x} / {y}'}" for n, eq, (x, y) in zip(COUNTED, same, got))
        peaks = " / ".join(f"{r['memory']['peak_bytes'] / 1e9:.3f}" for r in (ra, rb))
        lines.append(f"{key:40s} {parts}; peak {peaks} GB; collectives {ra['collectives']['total'] / 1e6:.1f} MB")
    return lines + [f"{len(set(a) | set(b))} cells, {apart} apart"]


def _kw(shape_name: str, args) -> dict:
    return {"microbatches": args.microbatches} if SHAPES_BY_NAME[shape_name].kind == "train" else {}


def _in_children(todo: list, args):
    """Yield each cell's record as its child ends: ``--arch A --shape S``
    runs of this module, ``args.jobs`` at a time, each into files of its
    own; a child that dies yields an ``error`` record with its log's tail.
    A cell that does not apply is recorded here, with no child."""
    tmp = tempfile.mkdtemp(prefix="dryrun_")
    pending, running = [], []
    for a, s in todo:
        if shape_applicable(ARCHS[a], SHAPES_BY_NAME[s])[0]:
            pending.append((a, s))
        else:
            yield run_cell(a, s, None, "")
    while pending or running:
        while pending and len(running) < args.jobs:
            a, s = pending.pop(0)
            out, log = (os.path.join(tmp, f"{a}_{s}.{ext}") for ext in ("json", "log"))
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a, "--shape", s, "--out", out,
                   "--microbatches", str(args.microbatches), "--force"] + (["--multi-pod"] if args.multi_pod else [])
            with open(log, "w") as f:
                running.append((a, s, out, log, subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)))
        time.sleep(0.5)
        for item in [r for r in running if r[4].poll() is not None]:
            running.remove(item)
            a, s, out, log, proc = item
            if os.path.exists(out):
                yield load_results(out)[f"{a}:{s}"]
            else:
                with open(log) as f:
                    tail = f.read()[-2000:]
                yield {"arch": a, "shape": s, "status": "error", "error": f"the child exited {proc.returncode}",
                       "traceback": tail}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape name (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--force", action="store_true", help="re-run cached cells")
    ap.add_argument("--out", default=None)
    ap.add_argument("--jobs", type=int, default=1, help="cells counted at once, each in a child process")
    ap.add_argument("--compare", nargs=2, metavar="JSON", help="compare two sweeps' results files and exit")
    args = ap.parse_args(argv)
    if args.compare:
        lines = compare(*(load_results(p) for p in args.compare))
        print("\n".join(lines))
        return 0 if lines[-1].endswith(" 0 apart") else 1

    mesh_name = "pod2x16x16" if args.multi_pod else "pod16x16"
    os.makedirs(RESULTS_DIR, exist_ok=True)
    out_path = args.out or os.path.join(RESULTS_DIR, f"dryrun_torch_{mesh_name}.json")
    results = load_results(out_path)

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else [s.name for s in LM_SHAPES]

    todo = []
    for a in archs:
        for s in shapes:
            key = f"{a}:{s}"
            if key in results and results[key].get("status") in ("ok", "skipped") and not args.force:
                print(f"[cached ] {key:48s} {results[key]['status']}")
                continue
            todo.append((a, s))
    if args.jobs > 1:
        records = _in_children(todo, args)
    else:
        mesh = make_production_mesh(multi_pod=args.multi_pod)
        records = (run_cell(a, s, mesh, mesh_name, **_kw(s, args)) for a, s in todo)

    failures = 0
    for rec in records:
        key = f"{rec['arch']}:{rec['shape']}"
        results[key] = rec
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)
        status = rec["status"]
        extra = ""
        if status == "ok":
            r = rec["roofline"]
            extra = (
                f"dom={r['dominant']:10s} "
                f"t={max(r['compute_s'], r['memory_s'], r['collective_s']):.4f}s "
                f"frac={r['roofline_fraction']:.3f} "
                f"peak={r['peak_bytes_per_chip'] / 1e9:.1f}GB ({rec['seconds']}s)"
            )
        elif status == "error":
            extra = rec["error"][:120]
            failures += 1
        print(f"[{status:7s}] {key:48s} {extra}", flush=True)
    print(f"\n{mesh_name}: {len(results)} cells, {failures} failures -> {out_path}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
