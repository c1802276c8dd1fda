"""Perf iteration tool of the port: count one dry-run cell under knob
overrides and print its terms, or measure the adaptive explain ladder.

    PYTHONPATH=src python -m repro_torch.tools.perf_iterate llama3-8b train_4k \\
        --microbatches 4 --grad-compression
    PYTHONPATH=src python -m repro_torch.tools.perf_iterate qwen3-moe-235b-a22b decode_32k \\
        --serve-dtype bfloat16

``tools/perf_iterate.py`` on the port. Cell mode counts the cell at full
published width and depth on ``meta`` over the fake 256-rank production
mesh (512 with ``--multi-pod``), as ``launch.dryrun`` does (no card), and
prints the three roofline terms at ``HW_H100``, the counts a chip, the
collectives by kind, the top matrix products and the ops that move the
most bytes, so each hypothesis -> change -> count cycle is one command.
Nothing is cached; compare against ``results/dryrun_torch_pod16x16.json``.
Two differences from ``repro``'s: ``--microbatches`` is honoured (the
port counts every microbatch's eager ops, so it needs no costing variant,
and its numbers equal a sweep's record of the same cell at the same
knobs), and the serving dtype stays ``repro``'s flag default, float32,
where the sweep counts bfloat16.

Adaptive-explain mode measures the OTHER hot path — the δ-feedback serving
ladder — and appends one record per run to the trajectory file, so
steps-to-tolerance is tracked beside latency across iterations:

    PYTHONPATH=src python -m repro_torch.tools.perf_iterate [llama3-8b] --explain-adaptive \\
        [--tol 1e-2 --base-m 8 --m-max 64 --note "my change"] [--device cpu]
    # the card, full width cut to 2 layers
    PYTHONPATH=src python -m repro_torch.tools.perf_iterate llama3-8b --explain-adaptive --full --layers 2

It serves ``reduced(ARCHS[arch])`` by default, as ``repro`` does; the
port's ``--full`` and ``--layers`` size it for the card. The weights come
from ``Model.init`` with a torch generator seeded 0 on the device (so the
numbers are not ``repro``'s); the traffic from ``default_rng(--seed)`` as
in ``repro``. On the card the attention runs through the flash kernels
(on the CPU ``attn="auto"``, ``repro``'s default). Each record also
carries the card's name and power limit (``nvidia-smi``) or ``cpu``, and
the torch version. Trajectory file: ``results/trajectory_torch.jsonl``
(one JSON object per line; ``repro``'s ``BENCH_trajectory.jsonl`` is
never touched).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, SHAPES_BY_NAME, reduced
from repro_torch.launch import add_port_args, device_of, sized, use_kernels
from repro_torch.launch.cells import build_cell, count_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline import HW_H100, model_flops, roofline_report
from repro_torch.sharding import mesh_axes

TRAJECTORY = os.path.join(os.path.dirname(__file__), "..", "..", "..", "results", "trajectory_torch.jsonl")


# ------------------------------------------------------- adaptive explain mode


def device_name(device="cuda") -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (its device name alone
    when ``nvidia-smi`` cannot be read), or ``cpu``."""
    device = torch.device(device)
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        smi = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60)
        return smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(index)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def explain_adaptive_record(cfg, params, reqs: list, args: argparse.Namespace, device="cuda") -> tuple[dict, Any]:
    """One δ-feedback serving measurement of ``reqs`` through an adaptive
    ``ExplainEngine`` on ``cfg`` and ``params``: a warm round builds every
    ladder callable the traffic touches, then the measured round. Returns
    (the record, the engine). The record's counters are the measured
    round's, but for ``m_used_hist`` and ``cache_misses``, which count both
    rounds as ``repro``'s do; ``cache_misses_warm`` is the misses after the
    warm round."""
    from repro_torch.serve import ExplainEngine

    device = torch.device(device)
    attn = "flash" if device.type == "cuda" else "auto"  # the card's attention is the flash kernels
    eng = ExplainEngine(
        cfg, params, method=args.method, schedule=args.schedule, m=args.base_m, n_int=4,
        adaptive=True, tol=args.tol, m_max=args.m_max, use_kernels=use_kernels(device, False),
        attn=attn, device=device,
    )
    eng.explain(reqs)  # warm every ladder callable this traffic touches
    a = eng.stats.adaptive
    warm = (a.total_steps, a.launched_steps, a.probe_forwards, a.converged, a.early_exits, a.requests)
    warm_misses = eng.stats.misses
    _sync(device)
    t0 = time.time()
    out = eng.explain(reqs)
    _sync(device)
    wall = time.time() - t0
    # report the measured round only — mixing in warm-round counters would
    # inflate steps relative to the measured latency
    steps = a.total_steps - warm[0]
    rec = {
        "ts": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "kind": "explain_adaptive",
        "arch": args.arch,
        "method": args.method,
        "schedule": args.schedule,
        "tol": args.tol,
        "ladder": list(eng.m_ladder),
        "requests": a.requests - warm[5],
        "wall_s": wall,
        "latency_per_req_ms": 1e3 * wall / len(reqs),
        "mean_m_used": steps / max(a.requests - warm[5], 1),
        "total_steps": steps,
        "launched_steps": a.launched_steps - warm[1],
        "probe_forwards": a.probe_forwards - warm[2],
        "converged": a.converged - warm[3],
        "early_exits": a.early_exits - warm[4],
        "m_used_hist": {str(k): v for k, v in sorted(a.m_used.items())},  # both rounds, as repro's
        "cache_misses": eng.stats.misses,
        "cache_misses_warm": warm_misses,  # equal to cache_misses: the measured round built nothing
        "mean_delta": float(np.mean([float(o["delta"]) for o in out])),
        "note": args.note,
        "device": device_name(device),
        "torch": torch.__version__,
        "layers": cfg.num_layers,
        "d_model": cfg.d_model,
        "attn": attn,
    }
    return rec, eng


def explain_adaptive_bench(args: argparse.Namespace) -> dict:
    """The mode's run: the model ``args`` size, ``repro``'s traffic, one
    record appended to ``TRAJECTORY`` and printed."""
    from repro_torch.launch.explain import make_traffic
    from repro_torch.models.registry import Model

    device = device_of(args)
    cfg = sized(ARCHS[args.arch], reduced, args)
    params = Model(cfg).init(torch.Generator(device=device).manual_seed(0), device=device)
    # repro's traffic: prompts of 9–32 token ids and targets, request for request
    reqs = make_traffic(cfg, args.requests, 9, 32, np.random.default_rng(args.seed))
    rec, _ = explain_adaptive_record(cfg, params, reqs, args, device)
    os.makedirs(os.path.dirname(TRAJECTORY), exist_ok=True)
    with open(TRAJECTORY, "a") as fh:
        fh.write(json.dumps(rec) + "\n")
    print(json.dumps(rec, indent=1))
    print(f"-> appended to {os.path.normpath(TRAJECTORY)}")
    return rec


# ---------------------------------------------------------------- cell mode


def cell_knobs(shape, args: argparse.Namespace) -> dict:
    """``build_cell``'s keyword arguments for ``shape`` under the flags."""
    if shape.kind == "train":
        return dict(microbatches=args.microbatches, remat=not args.no_remat,
                    grad_compression=args.grad_compression)
    return dict(serve_dtype=args.serve_dtype)


def iterate_cell(cfg, shape, mesh, mesh_name: str, *, top: int = 8, **kw) -> dict:
    """Count one cell (``launch.cells.count_cell``) and return its terms:
    the counts a chip (``flops``, ``dots``, ``bytes``, ``collectives`` by
    kind, ``argument_bytes``, ``peak_bytes``), the ``roofline`` row at
    ``HW_H100``, the ``top`` matrix products (``top_dots``) and the ``top``
    ops by bytes (``top_ops``)."""
    t0 = time.time()
    counts = count_cell(build_cell(cfg, shape, mesh, **kw))
    chips = int(np.prod(list(mesh_axes(mesh).values())))
    coll = counts["collectives"]
    rep = roofline_report(
        arch=cfg.name, shape=shape.name, mesh_name=mesh_name, chips=chips,
        cost={"flops": counts["flops"], "bytes accessed": counts["bytes accessed"]},
        coll_bytes_per_chip=coll["total"], mflops=model_flops(cfg, shape), hw=HW_H100,
        peak_bytes_per_chip=float(counts["peak_bytes"]),
    )
    dots = counts["dots"]
    return {
        "arch": cfg.name, "shape": shape.name, "mesh": mesh_name, "chips": chips, "knobs": kw,
        "seconds": time.time() - t0,
        "flops": counts["flops"], "dots": dots["total_dot_flops"], "num_dots": dots["num_dots"],
        "bytes": counts["bytes accessed"], "collectives": coll,
        "argument_bytes": counts["argument_bytes"], "peak_bytes": counts["peak_bytes"],
        "roofline": rep.row(),
        "top_dots": dots["top"][:top], "top_ops": counts["bytes_by_op"][:top],
    }


def cell_lines(res: dict) -> list[str]:
    """``repro``'s printed lines of a counted cell, and the exact counts."""
    r = res["roofline"]
    coll = res["collectives"]
    lines = [
        f"\n{res['arch']}:{res['shape']}  (count {res['seconds']:.0f}s, {res['chips']} chips, knobs {res['knobs']})",
        f"  compute={r['compute_s']:.4f}s memory={r['memory_s']:.4f}s "
        f"collective={r['collective_s']:.4f}s dominant={r['dominant']}",
        f"  flops/chip={res['flops']:.3e} bytes/chip={res['bytes']:.3e} "
        f"coll/chip={coll['total']:.3e} useful={r['useful_ratio']:.3f} "
        f"frac={r['roofline_fraction']:.4f}",
        f"  peak/chip={res['peak_bytes'] / 1e9:.3f}GB args/chip={res['argument_bytes'] / 1e9:.3f}GB",
        f"  counted: flops {int(res['flops'])} matrix-product flops {int(res['dots'])} "
        f"collective bytes {int(coll['total'])} peak bytes {int(res['peak_bytes'])}",
        "  collectives: " + str({k: f"{v / 2**30:.2f}GiB" for k, v in coll.items() if v}),
    ]
    lines.append(f"  top dots ({res['num_dots']} total, {res['dots']:.3e} flops):")
    lines += [f"    {d['frac'] * 100:5.1f}% x{d['count']:<4d} {d['shape'][:100]}" for d in res["top_dots"]]
    lines.append("  top memory ops:")
    lines += [f"    {o['frac'] * 100:5.1f}% x{o['count']:<5d} {o['bytes']:.2e}B  {o['op'][:95]}" for o in res["top_ops"]]
    return lines


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tools.perf_iterate", allow_abbrev=False)
    ap.add_argument("arch", nargs="?", default="llama3-8b", choices=sorted(ARCHS))
    ap.add_argument("shape", nargs="?", choices=sorted(SHAPES_BY_NAME))
    ap.add_argument("--explain-adaptive", action="store_true",
                    help="measure δ-feedback explain serving instead of a cell")
    ap.add_argument("--method", default="ig", help="attribution method (core.methods)")
    ap.add_argument("--schedule", default="paper", help="schedule family (core.schedule)")
    ap.add_argument("--tol", type=float, default=1e-2)
    ap.add_argument("--base-m", type=int, default=8)
    ap.add_argument("--m-max", type=int, default=64)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--note", default="", help="free-form tag for the trajectory record")
    ap.add_argument("--microbatches", type=int, default=8)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--serve-dtype", default="float32",
                    help="serving weights' dtype of prefill/decode cells (the sweep, "
                    "launch.dryrun, counts bfloat16: build_prefill_cell's default)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--top-dots", type=int, default=8)
    add_port_args(ap)
    return ap


def main(argv: Optional[list[str]] = None) -> dict:
    """Run one mode; returns the trajectory record or the counted cell."""
    ap = parser()
    args = ap.parse_args(argv)
    if args.explain_adaptive:
        return explain_adaptive_bench(args)
    if not args.shape:
        ap.error("shape is required unless --explain-adaptive is given")
    mesh = make_production_mesh(multi_pod=args.multi_pod)
    shape = SHAPES_BY_NAME[args.shape]
    res = iterate_cell(ARCHS[args.arch], shape, mesh, "pod2x16x16" if args.multi_pod else "pod16x16",
                       top=args.top_dots, **cell_knobs(shape, args))
    print("\n".join(cell_lines(res)))
    return res


if __name__ == "__main__":
    main()
    raise SystemExit(0)
