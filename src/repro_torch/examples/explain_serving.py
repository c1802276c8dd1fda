"""End-to-end explanation SERVING — the paper's deployment scenario.

    PYTHONPATH=src python -m repro_torch.examples.explain_serving [--device cpu] [--arch llama3-8b]

``examples/explain_serving.py`` on the port. Serves batched explanation
requests ("why this next token?") through ``ExplainService`` on a reduced
LM with seeded random weights, and reports per-request token scores,
convergence and wall-clock — paper (NUIG) against uniform at the same
budget, the uniform step count that matches paper's delta (the
iso-convergence search over m, 2m, 4m, 8m; Fig. 6a's analogue), and the
adaptive ladder, which climbs per request until a relative δ holds.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.launch import device_of
from repro_torch.models.registry import Model
from repro_torch.serve import ExplainRequest, ExplainService


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.explain_serving")
    ap.add_argument("--arch", default="llama3-8b", choices=sorted(ARCHS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--seq", type=int, default=24)
    ap.add_argument("--m", type=int, default=32)
    ap.add_argument("--tol", type=float, default=1e-2, help="relative δ tolerance for the adaptive demo")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[list[str]] = None) -> dict:
    args = parser().parse_args(argv)
    device = device_of(args)
    cfg = reduced(ARCHS[args.arch])
    params = Model(cfg).init(torch.Generator(device=device).manual_seed(0), device=device)
    rng = np.random.default_rng(0)
    reqs = [
        ExplainRequest(
            tokens=rng.integers(0, cfg.vocab_size, args.seq).astype(np.int32),
            target=int(rng.integers(0, cfg.vocab_size)),
        )
        for _ in range(args.requests)
    ]

    results = {}
    for method in ("paper", "uniform"):
        svc = ExplainService(cfg, params, schedule=method, m=args.m, n_int=4, device=device)
        svc.explain(reqs[:1])  # warmup
        _sync(device)
        t0 = time.perf_counter()
        out = svc.explain(reqs)
        wall = time.perf_counter() - t0
        deltas = [o["delta"] for o in out]
        results[method] = (wall, float(np.mean(deltas)))
        print(
            f"method={method:8s} m={args.m} batch={args.requests} "
            f"wall={wall:.3f}s mean_delta={np.mean(deltas):.5f}"
        )

    # iso-convergence: how many uniform steps match paper's delta?
    target_delta = results["paper"][1]
    iso, factor = {}, None
    for mu in (args.m, 2 * args.m, 4 * args.m, 8 * args.m):
        svc = ExplainService(cfg, params, schedule="uniform", m=mu, device=device)
        d = float(np.mean([o["delta"] for o in svc.explain(reqs)]))
        iso[mu] = d
        print(f"uniform m={mu}: delta={d:.5f}")
        if d <= target_delta:
            factor = mu / args.m
            print(f"--> iso-convergence step reduction: {mu}/{args.m} = {factor:.1f}x")
            break

    top = np.argsort(-np.abs(out[0]["token_scores"]))[:5].tolist()
    print("top-5 attributed positions (request 0):", top)

    # tolerance-driven serving: don't pick m at all — state the δ you need
    # and let each request climb the m-ladder until it holds.
    base_m = max(4, args.m // 4)  # paper allocation needs >= n_int steps
    print(f"\n-- adaptive: tol={args.tol} relative δ, ladder from m={base_m}")
    svc = ExplainService(
        cfg, params, schedule="paper", m=base_m, n_int=4,
        adaptive=True, tol=args.tol, m_max=max(2 * args.m, 2 * base_m), device=device,
    )
    svc.explain(reqs)  # warm every ladder path this traffic touches
    a = svc.engine.stats.adaptive
    steps0, exits0, reqs0 = a.total_steps, a.early_exits, a.requests
    _sync(device)
    t0 = time.perf_counter()
    out = svc.explain(reqs)
    wall = time.perf_counter() - t0
    for i, o in enumerate(out[:4]):
        print(
            f"request {i}: m_used={o['m_used']:<4d} hops={o['hops']} "
            f"delta={o['delta']:.5f} (threshold {o['threshold']:.5f}) "
            f"converged={o['converged']}"
        )
    steps = a.total_steps - steps0
    mean_m = steps / (a.requests - reqs0)
    print(
        f"adaptive wall={wall:.3f}s mean_m_used={mean_m:.1f} "
        f"early_exits={a.early_exits - exits0}/{a.requests - reqs0} "
        f"steps={steps} vs fixed-m {args.m}x{len(reqs)}={args.m * len(reqs)}"
    )
    return {
        "methods": {k: {"wall": w, "mean_delta": d} for k, (w, d) in results.items()},
        "iso": iso, "iso_factor": factor, "top5": top,
        "adaptive": {"wall": wall, "mean_m_used": mean_m, "early_exits": a.early_exits - exits0,
                     "steps": steps, "requests": [dict(o) for o in out[:4]]},
    }


if __name__ == "__main__":
    main()
    sys.exit(0)
