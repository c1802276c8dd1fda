"""Assemble results/EXPERIMENTS_torch.md from the port's dry runs and trajectory.

    PYTHONPATH=src python -m repro_torch.tools.render_experiments

``tools/render_experiments.py`` on the port. Reads the port's own sweeps,
``results/dryrun_torch_pod16x16.json`` and ``dryrun_torch_pod2x16x16.json``
(``python -m repro_torch.launch.dryrun [--multi-pod]``), and the adaptive
trajectory ``results/trajectory_torch.jsonl`` (``python -m
repro_torch.tools.perf_iterate --explain-adaptive``), and writes
``results/EXPERIMENTS_torch.md`` — generated, git-ignored, never a file at
the root (``repro`` writes ``EXPERIMENTS.md`` there). Re-run after dry
runs and perf iterations to refresh the tables. It has no benchmark
section: the port has no benchmark yet.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional

from repro_torch.roofline import HW_H100

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
RESULTS = os.path.join(ROOT, "results")
OUT = os.path.join(RESULTS, "EXPERIMENTS_torch.md")
TRAJECTORY = "trajectory_torch.jsonl"


def load(name: str) -> dict:
    """A results file of ``RESULTS`` (``launch.dryrun.load_results``'s
    reading: {} when it is missing)."""
    path = os.path.join(RESULTS, name)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def load_trajectory() -> list[dict]:
    """The trajectory's records, one a line, oldest first."""
    path = os.path.join(RESULTS, TRAJECTORY)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def fmt_gb(b: float) -> str:
    return f"{b / 1e9:.2f}"


def dryrun_table(results: dict) -> str:
    """One row a cell: status, one chip's argument and peak bytes, FLOPs and
    collective bytes, and the seconds the count took."""
    rows = [
        "| cell | status | argument GB/chip | peak GB/chip | FLOPs/chip | collective GB/chip | count s |",
        "|---|---|---|---|---|---|---|",
    ]
    for key in sorted(results):
        r = results[key]
        if r.get("status") == "skipped":
            rows.append(f"| {key} | skipped — {r.get('reason', '')} | | | | | |")
            continue
        if r.get("status") != "ok":
            rows.append(f"| {key} | ERROR {r.get('error', '')[:60]} | | | | | |")
            continue
        mem = r.get("memory", {})
        flops = r.get("cost", {}).get("flops", 0)
        coll = r.get("collectives", {}).get("total", 0)
        rows.append(
            f"| {key} | ok | {fmt_gb(mem.get('argument_bytes', 0))} | {fmt_gb(mem.get('peak_bytes', 0))} | "
            f"{flops:.2e} | {fmt_gb(coll)} | {r.get('seconds', '')} |"
        )
    return "\n".join(rows)


NOTES = {
    "train": "AdamW's in-place f32 passes and activation streaming; a fused optimizer or a larger per-chip batch",
    "prefill": "eager op bytes at 32k: score and cast passes a fused attention kernel would keep on chip",
    "decode": "reads every weight and the KV cache a token — bandwidth-bound; cut the bytes (bf16/int8, in-place cache reads)",
}


def roofline_table(results: dict) -> str:
    """``repro``'s roofline columns, from each ``ok`` cell's ``roofline`` row."""
    rows = [
        "| cell | compute s | memory s | collective s | dominant | 6ND/counted | roofline frac | bottleneck note |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for key in sorted(results):
        r = results[key]
        if r.get("status") != "ok":
            continue
        rr = r["roofline"]
        kind = "decode" if "decode" in key or "long" in key else ("prefill" if "prefill" in key else "train")
        dominant = rr["dominant"]
        note = NOTES[kind] if dominant == "memory" else (
            "collective-bound: overlap or compress the gradient reduction"
            if dominant == "collective"
            else "compute-bound: push the tensor cores' share")
        rows.append(
            f"| {key} | {rr['compute_s']:.4f} | {rr['memory_s']:.4f} | "
            f"{rr['collective_s']:.4f} | **{dominant}** | {rr['useful_ratio']:.2f} | "
            f"{rr['roofline_fraction']:.3f} | {note} |"
        )
    return "\n".join(rows)


def trajectory_table(records: list[dict]) -> str:
    """One row a ``perf_iterate --explain-adaptive`` record."""
    if not records:
        return "_no trajectory yet — run `python -m repro_torch.tools.perf_iterate --explain-adaptive`_"
    rows = [
        "| ts | device | arch (layers) | method | schedule | tol | ladder | requests | mean m_used | "
        "Σ steps (launched) | ms/request | misses | mean δ | note |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in records:
        rows.append(
            f"| {r.get('ts', '')} | {r.get('device', '')} | {r.get('arch', '')} ({r.get('layers', '')}) | "
            f"{r.get('method', '')} | {r.get('schedule', '')} | {r.get('tol', '')} | {r.get('ladder', '')} | "
            f"{r.get('requests', '')} | {r.get('mean_m_used', 0):.2f} | "
            f"{r.get('total_steps', '')} ({r.get('launched_steps', '')}) | {r.get('latency_per_req_ms', 0):.2f} | "
            f"{r.get('cache_misses', '')} | {r.get('mean_delta', 0):.4g} | {r.get('note', '')} |"
        )
    return "\n".join(rows)


def _tally(results: dict) -> tuple[int, int]:
    return (sum(r.get("status") == "ok" for r in results.values()),
            sum(r.get("status") == "skipped" for r in results.values()))


def render(pod1: dict, pod2: dict, trajectory: list[dict]) -> str:
    """The document of two sweeps and a trajectory."""
    ok1, sk1 = _tally(pod1)
    ok2, sk2 = _tally(pod2)
    return f"""# EXPERIMENTS (PyTorch port)

Generated by `python -m repro_torch.tools.render_experiments` from the
port's results files; every number comes from a committed harness
(`repro_torch.launch.dryrun`, `repro_torch.tools.perf_iterate`).

Benchmarks: none yet — the port's benchmark adds its section here.

## Dry run — (architecture × shape) × mesh, counted

Every cell runs its step once on the `meta` device (shapes only, nothing
allocated, no card) with its arguments DTensors of local shards over a
fake process group of the mesh's size, under `roofline.op_counts.OpCounter`,
so every count is one rank's: FLOPs by `torch.utils.flop_counter`'s
formulas, collective bytes by kind, the arguments' bytes and the peak of
live bytes. Train cells: FSDP(+TP) rules, 8 microbatches, remat.
Prefill/decode: TP(+FSDP weights), bf16 serving weights; `long_500k`
decodes with the KV/state sequence-sharded on the data axis.

### Single pod — (data=16, model=16), 256 ranks — {ok1} ok / {sk1} skipped

{dryrun_table(pod1)}

### Multi-pod — (pod=2, data=16, model=16), 512 ranks — {ok2} ok / {sk2} skipped

{dryrun_table(pod2)}

## Roofline — three terms a chip (single pod, `HW_H100`)

`compute = FLOPs/chip ÷ {HW_H100.peak_flops:.4g}` (bf16 dense tensor cores), `memory = op
bytes/chip ÷ {HW_H100.hbm_bw:.4g}`, `collective = collective bytes/chip ÷ {HW_H100.link_bw:.4g}`
(NVLink, each way), the H100 SXM data sheet's figures (`HW_H100`). The op
bytes are the eager program's: every op's inputs and outputs at their
element counts, views and allocations free, without fusion — an upper
bound on what a fused program moves. `6ND/counted` = model FLOPs
(6·N_active·D train, 2·N_active·D inference) over the counted FLOPs;
`roofline frac` = model FLOPs ÷ (chips · peak · the dominant term).

{roofline_table(pod1)}

## Adaptive explain — steps to tolerance beside latency

One row a `perf_iterate --explain-adaptive` run (the measured round of
mixed-length traffic after a warm round); the device column is the card's
name and power limit, or `cpu`.

{trajectory_table(trajectory)}
"""


def main(argv: Optional[list[str]] = None) -> str:
    """Write ``OUT``; returns its path."""
    argparse.ArgumentParser(prog="python -m repro_torch.tools.render_experiments").parse_args(argv)
    doc = render(load("dryrun_torch_pod16x16.json"), load("dryrun_torch_pod2x16x16.json"), load_trajectory())
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        f.write(doc)
    print(f"wrote {OUT}")
    return OUT


if __name__ == "__main__":
    main()
    raise SystemExit(0)
