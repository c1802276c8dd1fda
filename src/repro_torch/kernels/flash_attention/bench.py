"""Time the bf16 flash kernels against those of another flash source, in one process on a CUDA card.

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.bench [--baseline SOURCE.cu] [--out OUT.json]

Builds the library from the repository's source and, with ``--baseline``, a
second one from SOURCE.cu (any path; a source with the same ``Params`` and
parts, such as an earlier commit's written out with ``git show``), built
with the same flags. At each bf16 attention shape ``chip_smoke.py`` runs the
flash kernels at (the LM engine's, the prefills', the GQA groups',
gemma3-27b's, whisper-tiny's and internvl2-26b's, the train step's; the
explain buckets at the chunk the smoke's engines pick), it holds every
library's forward, dQ and (where the smoke times the trio) dK/dV against
their plain versions, |err| ≤ 3e-2 (1 + |want|) as the smoke gates them,
checks that two calls give the same bits, then times each kernel with a
cold L2 in turns: baseline, repository, repository, baseline. Prints one
line per shape and kernel and the card's name and power limit, and writes
every time and worst err/allowed ratio to OUT.json (default
``build/flash_bench.json``). Needs a card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

import torch

from repro_torch.kernels import common
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention import ref as fr
from repro_torch.kernels.sweep import cold_ms

TOL = 3e-2  # the bf16 flash tolerance of the JAX tests, the smoke and the card tests
# (name, (B, S, NQ, NKV, D), causal, ragged, kernels timed)
TRIO = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
SHAPES = (
    ("lm engine", (256, 128, 32, 8, 128), True, True, TRIO),
    ("prefill 16x128", (16, 128, 32, 8, 128), True, False, ("flash_fwd",)),
    ("prefill 2x999", (2, 999, 32, 8, 128), True, False, ("flash_fwd",)),
    ("internlm2 group", (4, 256, 48, 8, 128), True, True, ("flash_fwd", "flash_bwd_dq")),
    ("yi group", (4, 256, 32, 4, 128), True, True, ("flash_fwd", "flash_bwd_dq")),
    ("gemma3 prefill", (2, 4096, 32, 16, 128), True, False, ("flash_fwd",)),
    ("gemma3 explain", (4, 2048, 32, 16, 128), True, True, TRIO),
    ("whisper encoder", (4, 1500, 6, 6, 64), False, False, ("flash_fwd",)),
    ("whisper explain", (1024, 128, 6, 6, 64), True, True, TRIO),
    ("internvl2 prefill", (16, 384, 48, 8, 128), True, False, ("flash_fwd",)),
    ("internvl2 explain 16x128", (256, 128, 48, 8, 128), True, True, TRIO),
    ("internvl2 explain 4x512", (64, 512, 48, 8, 128), True, True, TRIO),
    ("train step", (8, 128, 32, 8, 128), True, False, TRIO),
)


@contextmanager
def _using(lib):
    """The launchers on ``lib`` for the duration (``None``: the repository's)."""
    real = fk.load_library
    if lib is not None:
        fk.load_library = lambda: lib
    try:
        yield
    finally:
        fk.load_library = real


def _inputs(g, shape, causal, ragged):
    """q, k, v, dO as transposed (B, H, S, D) views of model-layout bf16
    tensors, kvlen in (S/2, S] (``ragged``) or S, and the plain versions'
    outputs with the backward's lse and delta."""
    B, S, NQ, NKV, D = shape
    rnd = lambda h: torch.randn((B, S, h, D), generator=g, device="cuda").to(torch.bfloat16).transpose(1, 2)
    q, k, v, do = rnd(NQ), rnd(NKV), rnd(NKV), rnd(NQ)
    if ragged:
        kvlen = torch.randint(S // 2 + 1, S + 1, (B,), generator=g, device="cuda", dtype=torch.int32)
    else:
        kvlen = torch.full((B,), S, device="cuda", dtype=torch.int32)
    o, lse = fr.flash_fwd_ref(q, k, v, kvlen, causal=causal)
    delta = (do.float() * o.float()).sum(-1)
    return q, k, v, do, kvlen, o, lse, delta


def _calls(x, causal):
    q, k, v, do, kvlen, _, lse, delta = x
    args = (q, k, v, do, lse, delta, kvlen)
    return {"flash_fwd": lambda: fk.flash_fwd_cuda(q, k, v, kvlen, causal=causal),
            "flash_bwd_dq": lambda: (fk.flash_bwd_dq_cuda(*args, causal=causal),),
            "flash_bwd_dkv": lambda: fk.flash_bwd_dkv_cuda(*args, causal=causal)}


def _wants(x, causal, names):
    q, k, v, do, kvlen, o, lse, delta = x
    args = (q, k, v, do, lse, delta, kvlen)
    want = {"flash_fwd": (o, lse)}
    if "flash_bwd_dq" in names:
        want["flash_bwd_dq"] = (fr.flash_bwd_dq_ref(*args, causal=causal),)
    if "flash_bwd_dkv" in names:
        want["flash_bwd_dkv"] = fr.flash_bwd_dkv_ref(*args, causal=causal)
    return want


def _ratio(got, want) -> float:
    """The worst |got − want| / (TOL (1 + |want|)) over the outputs."""
    return max(float(((a.float() - b.float()).abs() / (TOL * (1 + b.float().abs()))).max())
               for a, b in zip(got, want))


def bench_shape(g, libs: dict, shape, causal, ragged, names) -> dict:
    x = _inputs(g, shape, causal, ragged)
    want, calls = _wants(x, causal, names), _calls(x, causal)
    out = {}
    for name in names:
        rec = out[name] = {}
        for label, lib in libs.items():
            with _using(lib):
                first, second = calls[name](), calls[name]()
            torch.cuda.synchronize()
            rec[f"{label}_ratio"] = _ratio(first, want[name])
            if not rec[f"{label}_ratio"] <= 1:
                raise AssertionError(f"{name} ({label}) at {shape}: err/allowed {rec[f'{label}_ratio']:.3g}")
            if not all(torch.equal(a, b) for a, b in zip(first, second)):
                raise AssertionError(f"{name} ({label}) at {shape}: two calls differ")
        # in turns: baseline, repository, repository, baseline (or the repository twice)
        order = ["baseline", "repo", "repo", "baseline"] if "baseline" in libs else ["repo", "repo"]
        for label in order:
            with _using(libs[label]):
                rec.setdefault(f"{label}_ms", []).append(cold_ms(calls[name]))
        line = ", ".join(f"{label} {' '.join(f'{t:.4f}' for t in rec[f'{label}_ms'])} ms "
                         f"(err/allowed {rec[f'{label}_ratio']:.3g})" for label in libs)
        if "baseline" in libs:
            speed = sum(rec["baseline_ms"]) / sum(rec["repo_ms"])
            line += f"; baseline / repository {speed:.2f}"
            rec["speedup"] = speed
        print(f"  {name}: {line}", flush=True)
    del x, want
    torch.cuda.empty_cache()
    return out


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, help="another flash source to time beside the repository's")
    ap.add_argument("--out", type=Path, default=common.BUILD_DIR / "flash_bench.json")
    ap.add_argument("--only", default="", help="comma-separated shape names (default: every shape)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the flash bench needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    libs = {"repo": None}
    fk.load_library()
    if args.baseline:
        libs = {"baseline": fk.load_library((str(args.baseline.resolve()),)), **libs}
    only = {s for s in args.only.split(",") if s}
    g = torch.Generator(device="cuda").manual_seed(0)
    result = {"device": smi, "baseline": str(args.baseline) if args.baseline else None, "shapes": {}}
    for name, shape, causal, ragged, names in SHAPES:
        if only and name not in only:
            continue
        print(f"{name}: B={shape[0]} S={shape[1]} NQ={shape[2]} NKV={shape[3]} D={shape[4]} bf16, "
              f"{'causal' if causal else 'non-causal'}, {'ragged' if ragged else 'every key'}", flush=True)
        result["shapes"][name] = bench_shape(g, libs, shape, causal, ragged, names)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
