"""Serving from the command line: ``repro.launch.serve`` on the port — batched generation,
optionally with explain riding along.

    # classic: batched greedy generation, the CPU at reduced widths
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --arch llama3-8b --tokens 32

    # sampled decoding
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --sample --temperature 0.8

    # the card: internvl2-26b at full width, 24 layers, 256 patches before each prompt
    PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-26b --full --layers 24 \
        --batch 4 --prompt-len 128 --tokens 32

    # unified mixed workload: generate + explain through one scheduler
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --mixed --tokens 8 --requests 8

The classic path feeds a frontend config its stub features: internvl2's
patches (prepended to each prompt) and whisper's encoder frames. Its cache
holds frontend_tokens + prompt_len + tokens positions for a vision config,
where ``repro`` leaves the patches out and its last frontend_tokens decode
writes clamp onto one slot. ``--mixed`` serves at f32 compute, as ``repro``
forces; on whisper-tiny it raises, as ``repro``'s does, since a generate
request carries no encoder frames.

The flags and the printed lines are ``repro``'s, plus the port's
``--device``, ``--full`` and ``--layers`` (``launch``). The seeded draws
(weights, the classic path's prompts and frontend features) are
``draw``'s, from torch generators on the chosen device: their numbers are
not ``repro``'s, and the features are normal draws where ``repro`` feeds
ones. ``--sample`` draws its noise from a generator seeded with seed + 2;
``--mixed`` takes its traffic from ``numpy.random.default_rng(seed)`` as in
``repro``.
"""
from __future__ import annotations

import argparse
import sys
import time
from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.launch import add_port_args, device_of, sized, use_kernels
from repro_torch.models.registry import Model
from repro_torch.serve import ServeEngine


def draw(cfg, args: argparse.Namespace, device="cuda") -> tuple[dict, dict]:
    """The run's seeded draws on ``device``: the weights (``Model.init``,
    generator seed ``args.seed``) and the classic path's batch (generator
    seed + 1): ``args.batch`` prompts of ``args.prompt_len`` ids in [0, V)
    and, for a frontend config, normal features (B, frontend_tokens,
    frontend_dim) for vision or (B, encoder_seq, frontend_dim) for audio."""
    params = Model(cfg).init(torch.Generator(device=device).manual_seed(args.seed), device=device)
    g = torch.Generator(device=device).manual_seed(args.seed + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=g,
                                     device=device, dtype=torch.int32)}
    if cfg.frontend:
        n = cfg.frontend_tokens if cfg.frontend == "vision" else cfg.encoder_seq
        batch["frontend"] = torch.randn((args.batch, n, cfg.frontend_dim), generator=g, device=device)
    return params, batch


def run_classic(cfg, params, batch: dict, args, device="cuda") -> tuple[ServeEngine, torch.Tensor]:
    """Greedy (or ``--sample``) generation of ``batch``; returns the engine
    and the generated ids."""
    device = torch.device(device)
    patches = cfg.frontend_tokens if cfg.frontend == "vision" else 0
    engine = ServeEngine(cfg, params, max_len=patches + args.prompt_len + args.tokens, device=device)
    sample_kw = {}
    if args.sample:
        sample_kw = {"generator": torch.Generator(device=device).manual_seed(args.seed + 2),
                     "temperature": args.temperature}
    t0 = time.time()
    out = engine.generate(batch, args.tokens, **sample_kw)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    mode = f"sampled T={args.temperature}" if args.sample else "greedy"
    print(f"arch={cfg.name} {mode} generated {tuple(out.shape)} in {dt:.2f}s")
    print("first sequence:", out[0].cpu().numpy()[:16], "...")
    if bool((out < 0).any()) or bool((out >= cfg.vocab_size).any()):
        raise AssertionError(f"generated ids outside [0, {cfg.vocab_size})")
    return engine, out


def run_mixed(cfg, params, args, device="cuda"):
    """Mixed generate+explain traffic through the unified MixedScheduler;
    returns the scheduler and the last round's tickets."""
    from repro_torch.serve import (BATCH, INTERACTIVE, ExplainEngine, ExplainRequest, GenerateRequest,
                                   MixedScheduler, TenantPolicy)

    device = torch.device(device)
    # probe reuse agrees with the engine's own probe at f32 compute
    cfg = replace(cfg, compute_dtype="float32")
    engine = ExplainEngine(
        cfg,
        params,
        m=args.m,
        n_int=args.n_int,
        seq_buckets=(8, 16, 32, 64),
        adaptive=args.adaptive,
        tol=args.tol,
        result_cache=args.result_cache * (1 << 20),
        use_kernels=use_kernels(device, False),
        device=device,
    )
    max_len = args.prompt_len + args.tokens
    tenants = {"default": TenantPolicy(rate=args.tenant_rate)} if args.tenant_rate else None
    sched = MixedScheduler(engine, max_len=max_len, max_queue=args.max_queue,
                           decode_chunk=args.decode_chunk, tenants=tenants)
    rng = np.random.default_rng(args.seed)

    for rnd in range(args.rounds):
        tickets = []
        for i in range(args.requests):
            prompt = rng.integers(1, cfg.vocab_size, args.prompt_len).astype(np.int32)
            if i % 3 == 2:  # every third request is explain-only traffic
                tickets.append(sched.submit(
                    ExplainRequest(tokens=prompt, target=int(rng.integers(0, cfg.vocab_size)))))
            else:
                tickets.append(sched.submit(GenerateRequest(
                    tokens=prompt,
                    num_tokens=args.tokens,
                    explain=True,
                    slo=INTERACTIVE if i % 2 == 0 else BATCH,
                    temperature=args.temperature if args.sample else 0.0,
                    seed=args.seed + i if args.sample else None,
                )))
        t0 = time.perf_counter()
        sched.run_until_idle()
        wall = time.perf_counter() - t0
        done = sum(t.status == "done" for t in tickets)
        print(f"round {rnd}: {done}/{len(tickets)} done in {wall:.2f}s "
              f"(degraded={engine.stats.degraded} "
              f"rejected={sched.rejected_backpressure + sched.rejected_rate})")

    st = engine.stats
    print(f"executable cache: hits={st.hits} misses={st.misses} hit_rate={st.hit_rate:.2f}")
    if engine.result_cache is not None:
        print(f"result cache: hits={st.result_hits} misses={st.result_misses} "
              f"hit_rate={st.result_hit_rate:.2f} evictions={st.result_evictions} "
              f"bytes={st.result_bytes}")
    print(f"scheduler: degraded={st.degraded} preempted={st.preempted} "
          f"stragglers={len(sched.monitor.flagged)}")
    for name, s in sorted(sched.latency_summary().items()):
        print(f"  {name:12s} n={s['n']:<4d} p50={1e3 * s['p50_s']:.1f}ms "
              f"p99={1e3 * s['p99_s']:.1f}ms")
    gen = next(t for t in tickets if t.kind == "generate" and t.status == "done")
    a0 = gen.attributions[0]
    print(f"sample generate ticket: tokens={gen.tokens[:8]} "
          f"first-token attribution f_x={a0['f_x']:.4f} delta={a0['delta']:.5f} "
          f"(endpoint donated by the decode prefill — no re-run)")
    return sched, tickets


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="llama3-8b", choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sample", action="store_true",
                    help="categorical sampling instead of greedy argmax")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--mixed", action="store_true",
                    help="mixed generate+explain traffic through the unified MixedScheduler")
    ap.add_argument("--requests", type=int, default=8, help="requests/round (--mixed)")
    ap.add_argument("--rounds", type=int, default=2, help="traffic rounds (--mixed)")
    ap.add_argument("--m", type=int, default=8)
    ap.add_argument("--n-int", type=int, default=4)
    ap.add_argument("--adaptive", action="store_true")
    ap.add_argument("--tol", type=float, default=1e-2)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--decode-chunk", type=int, default=8)
    ap.add_argument("--tenant-rate", type=float, default=0.0,
                    help="per-tenant admission rate in req/s (0 = unlimited)")
    ap.add_argument("--result-cache", type=int, default=0, metavar="MB",
                    help="content-addressed attribution cache budget in MB (0 = off): repeat "
                    "explain traffic completes at admission without a queue slot (--mixed)")
    add_port_args(ap)
    return ap


def run(args: argparse.Namespace):
    """Serve what ``args`` describe and print ``repro``'s lines. Returns
    (the ``ServeEngine``, its generated ids) on the classic path, (the
    ``MixedScheduler``, the last round's tickets) with ``--mixed``."""
    device = device_of(args)
    cfg = sized(get_config(args.arch), reduced, args)
    if args.mixed and args.prompt_len > 32:
        args.prompt_len = 16  # keep the demo's bucket set small
    params, batch = draw(cfg, args, device)
    if args.mixed:
        return run_mixed(cfg, params, args, device)
    return run_classic(cfg, params, batch, args, device)


def main(argv: Optional[list[str]] = None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
