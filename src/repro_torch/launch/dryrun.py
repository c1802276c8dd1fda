"""Multi-pod dry run of the port: ``repro.launch.dryrun`` over DTensor.

Counts every (architecture × input-shape) cell on the production meshes
at full published width and depth, on the ``meta`` device (shapes only,
nothing allocated, no card needed), and records one rank's FLOPs, bytes,
collectives and peak memory with the roofline terms on ``HW_H100``:

    PYTHONPATH=src python -m repro_torch.launch.dryrun                 # all cells, 1-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod     # 2-pod mesh
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k

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
"""
from __future__ import annotations

import argparse
import json
import os
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape name (default: all)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--force", action="store_true", help="re-run cached cells")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    mesh = make_production_mesh(multi_pod=args.multi_pod)
    mesh_name = "pod2x16x16" if args.multi_pod else "pod16x16"
    os.makedirs(RESULTS_DIR, exist_ok=True)
    out_path = args.out or os.path.join(RESULTS_DIR, f"dryrun_torch_{mesh_name}.json")
    results = load_results(out_path)

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else [s.name for s in LM_SHAPES]

    failures = 0
    for a in archs:
        for s in shapes:
            key = f"{a}:{s}"
            if key in results and results[key].get("status") in ("ok", "skipped") and not args.force:
                print(f"[cached ] {key:48s} {results[key]['status']}")
                continue
            kw = {"microbatches": args.microbatches} if SHAPES_BY_NAME[s].kind == "train" else {}
            rec = run_cell(a, s, mesh, mesh_name, **kw)
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
