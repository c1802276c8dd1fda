"""Explanation serving from the command line: ``repro.launch.explain`` on the port.

    # the CPU, reduced widths (repro's sizes)
    PYTHONPATH=src python -m repro_torch.launch.explain --device cpu \
        --arch llama3-8b --m 8 --requests 6 --rounds 2 --max-seq 20

    # the card, full width cut to 4 layers, the flash kernels
    PYTHONPATH=src python -m repro_torch.launch.explain --arch internvl2-26b \
        --full --layers 4 --attn flash --rounds 2

    # a data-parallel mesh of 4 processes on the CPU
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.explain \
        --device cpu --dist-backend gloo --mesh 4,1 --requests 6

Drives the shape-bucketed ``ExplainEngine`` with mixed-length request
traffic (prompt lengths in [--min-seq, --max-seq]): round 1 builds each
bucket's callables, later rounds at seen buckets reuse them. Prints
per-bucket latency, build time and the cache hit-rate, then the chosen
schedule against uniform at the same step budget; ``--workload prompt``
explains one fixed prompt and prints its per-token table, ``--workload
vit`` the ViT's patches of one seeded image and prints the top-5 patches.
whisper-tiny and internvl2-26b are explained over their token stream only
(no encoder output, no patches), as ``repro`` does.

The flags and the printed lines are ``repro``'s, with these differences:
``--device``, ``--full`` and ``--layers`` are the port's (``launch``);
``--use-kernels`` only matters on the CPU, since the card always serves
stage 2 through the kernels; ``--mesh dp,tp`` runs under ``torchrun
--nproc-per-node dp·tp`` (``--dist-backend``: ``nccl`` by default on the
card, ``gloo`` on the CPU and where ranks share a card): rank 0 serves and
prints ``repro``'s lines, the other ranks compute their rows of each
stage-2 call and print nothing; ``--host-devices`` (JAX's virtual CPU
devices) has no counterpart, a device of the mesh being a process. The seeded
draws (weights, the ViT's image) are ``draw``'s: torch generators on the
chosen device, so their numbers are not ``repro``'s; the traffic comes from
``numpy.random.default_rng(seed)`` as in ``repro``, request for request.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.configs.vit import CONFIG as VIT_CONFIG, VitConfig, reduced_vit
from repro_torch.core.methods import METHODS
from repro_torch.core.schedule import SCHEDULES
from repro_torch.launch import add_port_args, device_of, sized, use_kernels
from repro_torch.launch.distributed import init_distributed, world_from_env
from repro_torch.launch.mesh import make_explain_mesh, parse_mesh_arg
from repro_torch.models import vit
from repro_torch.models.registry import Model
from repro_torch.serve import ExplainEngine, ExplainRequest
from repro_torch.serve.explain_engine import serve_worker
from repro_torch.sharding import dispatch


def make_traffic(cfg, n: int, lo: int, hi: int, rng) -> list[ExplainRequest]:
    return [
        ExplainRequest(
            tokens=rng.integers(1, cfg.vocab_size, size=int(s)).astype(np.int32),
            target=int(rng.integers(0, cfg.vocab_size)),
        )
        for s in rng.integers(lo, hi + 1, size=n)
    ]


def methods_table() -> str:
    """The registry, rendered for --help."""
    lines = ["attribution methods (--method):"]
    for name in sorted(METHODS):
        spec = METHODS[name]
        if spec.forward_only:
            extra = f" [forward-only, n_masks={spec.n_masks}]"
        elif spec.expand is not None:
            extra = f" [accum={spec.accum}, n_samples={spec.n_samples}]"
        else:
            extra = f" [accum={spec.accum}]"
        lines.append(f"  {name:14s} {spec.description}{extra}")
    lines.append("schedule families (--schedule): " + ", ".join(sorted(SCHEDULES)))
    return "\n".join(lines)


def report(engine: ExplainEngine) -> None:
    st = engine.stats
    print(f"  executable cache: hits={st.hits} misses={st.misses} "
          f"hit_rate={st.hit_rate:.2f}")
    if engine.result_cache is not None:
        print(f"  result cache: hits={st.result_hits} misses={st.result_misses} "
              f"hit_rate={st.result_hit_rate:.2f} evictions={st.result_evictions} "
              f"bytes={st.result_bytes}")
    if st.degraded or st.preempted or st.queue_depth:
        print(f"  scheduler: degraded={st.degraded} preempted={st.preempted} "
              f"queue_depth={st.queue_depth}")
    for shape in sorted(st.buckets):
        b = st.buckets[shape]
        print(
            f"  bucket B={shape[0]:<3d} S={shape[1]:<5d} calls={b.calls:<3d} "
            f"reqs={b.requests:<4d} compile={b.compile_s:.2f}s "
            f"mean_latency={1e3 * b.mean_latency_s:.1f}ms "
            f"bytes={b.bytes_accessed:.2e} peak={b.peak_bytes:.2e}"
        )
    for shape in sorted(st.hop_buckets):
        b = st.hop_buckets[shape]
        print(
            f"  hop    B={shape[0]:<3d} S={shape[1]:<5d} calls={b.calls:<3d} "
            f"{'':9s} compile={b.compile_s:.2f}s "
            f"mean_latency={1e3 * b.mean_latency_s:.1f}ms"
        )
    a = st.adaptive
    if a.requests:
        print(
            f"  adaptive: ladder={engine.m_ladder} converged={a.converged}/{a.requests} "
            f"early_exits={a.early_exits} hops={a.hop_calls} "
            f"mean_m_used={a.mean_m_used:.1f} steps={a.total_steps} "
            f"(launched {a.launched_steps} incl. pad) probe_fwd={a.probe_forwards}"
        )
        print(f"  m_used histogram: {dict(sorted(a.m_used.items()))}")


def draw(cfg, seed: int, device="cuda") -> tuple[dict, Optional[torch.Tensor]]:
    """The run's seeded draws, from one generator on ``device``: the weights
    (``Model.init``, or the ViT's ``init_params``) and, for a ViT, one image
    (1, H, W, C) uniform in [0, 1); None for an LM."""
    g = torch.Generator(device=device).manual_seed(seed)
    if isinstance(cfg, VitConfig):
        params = vit.init_params(cfg, g, device=device)
        img = torch.rand((1, cfg.image_size, cfg.image_size, cfg.channels), generator=g, device=device)
        return params, img
    return Model(cfg).init(g, device=device), None


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.explain",
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=methods_table(),
    )
    ap.add_argument("--arch", default="llama3-8b", choices=sorted(ARCHS))
    ap.add_argument("--method", default="ig", choices=sorted(METHODS),
                    help="attribution method (see table below)")
    ap.add_argument("--schedule", default="paper", choices=sorted(SCHEDULES),
                    help="interpolation schedule family")
    ap.add_argument("--m", type=int, default=64)
    ap.add_argument("--n-int", type=int, default=4)
    ap.add_argument("--n-masks", type=int, default=0,
                    help="perturbation mask budget P for forward-only methods "
                    "(occlusion/rise/lime; 0 = method default)")
    ap.add_argument("--requests", type=int, default=16, help="requests per round")
    ap.add_argument("--rounds", type=int, default=3, help="traffic rounds (round 1 builds)")
    ap.add_argument("--min-seq", type=int, default=9)
    ap.add_argument("--max-seq", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--adaptive", action="store_true",
                    help="δ-feedback early-exit: escalate unconverged requests up the m-ladder")
    ap.add_argument("--tol", type=float, default=1e-2, help="relative δ tolerance")
    ap.add_argument("--m-max", type=int, default=0, help="ladder top (default 8·m)")
    ap.add_argument("--n-samples", type=int, default=0,
                    help="path-ensemble size for noise_tunnel/expected_grad (0 = method default)")
    ap.add_argument("--sigma", type=float, default=0.0,
                    help="ensemble perturbation scale (0 = method default)")
    ap.add_argument("--fused", action="store_true",
                    help="fused stage 2: interpolation composed into the VJP")
    ap.add_argument("--attn", default="auto", choices=("auto", "flash"),
                    help="attention implementation: flash = the flash kernels (forward, dQ, "
                    "dK/dV on the card; their plain versions on the CPU)")
    ap.add_argument("--workload", default="traffic", choices=("traffic", "prompt", "vit"),
                    help="traffic = mixed-length token traffic; prompt = one fixed LM "
                    "prompt with a per-token attribution table; vit = ViT patch "
                    "attribution demo (ignores --arch/--min-seq/--max-seq)")
    ap.add_argument("--use-kernels", action="store_true",
                    help="the kernel ops on the CPU (their plain versions); the card always uses them")
    ap.add_argument("--autotune", action="store_true",
                    help="load per-(bucket, device) tuned configs from results/autotune_<device>.json")
    ap.add_argument("--result-cache", type=int, default=0, metavar="MB",
                    help="content-addressed attribution cache budget in MB (0 = off); "
                    "repeat requests replay bit-identically without touching the engine")
    ap.add_argument("--warm-state", default="", metavar="DIR",
                    help="warm-start directory: restore the engine's callables (+ autotune "
                    "entries + hop-zero history) before serving and save them after")
    ap.add_argument("--hop-zero", action="store_true",
                    help="with --adaptive: start each bucket at the δ-history quantile "
                    "rung instead of the base rung (repeat traffic skips known hops)")
    ap.add_argument("--mesh", default="",
                    help="'dp,tp' device mesh for sharded serving (e.g. 4,1) under torchrun "
                    "--nproc-per-node dp·tp; empty = this process alone")
    ap.add_argument("--dist-backend", default="", choices=("", "nccl", "gloo"),
                    help="the process group's backend with --mesh (default: nccl with --device "
                    "cuda, gloo with --device cpu; gloo where ranks share a card)")
    ap.add_argument("--scheduler", action="store_true",
                    help="route traffic through the MixedScheduler admission queue "
                    "(bounded, per-tenant rate limits); prints backpressure/rate "
                    "rejections and degradation counters")
    ap.add_argument("--max-queue", type=int, default=64, help="scheduler queue bound (with --scheduler)")
    ap.add_argument("--tenant-rate", type=float, default=0.0,
                    help="per-tenant token-bucket refill rate in req/s (0 = unlimited; with --scheduler)")
    add_port_args(ap)
    return ap


def run(args: argparse.Namespace) -> list[ExplainEngine]:
    """Serve the traffic ``args`` describe and print ``repro``'s lines;
    returns the engines, one per schedule leg. Under ``--mesh`` every rank
    calls it: rank 0 serves, the others serve its stage-2 rows and return
    ``[]``; the process group this call started ends with it."""
    device = device_of(args)
    if not args.mesh:
        return _serve(args, device, None)
    dp, tp = parse_mesh_arg(args.mesh)
    _, world, _, _ = world_from_env()
    if world != dp * tp:
        print(f"--mesh {args.mesh} needs {dp * tp} processes, one a mesh device: run it under "
              f"torchrun --nproc-per-node {dp * tp} (this world has {world})", file=sys.stderr)
        raise SystemExit(2)
    started = not dist.is_initialized()
    init_distributed(args.dist_backend or ("nccl" if device.type == "cuda" else "gloo"))
    try:
        if device.type == "cuda":
            device = torch.device("cuda", torch.cuda.current_device())
        mesh = make_explain_mesh(dp, tp, device=device)
        return _serve(args, device, mesh)
    finally:
        if started:
            dist.destroy_process_group()


def _mesh_line(dp: int, tp: int, device: torch.device) -> str:
    """``repro``'s mesh line; "ranks" where ranks share a card."""
    world = dist.get_world_size()
    if device.type == "cuda" and world > torch.cuda.device_count():
        return f"mesh: data={dp} model={tp} over {world} ranks sharing {torch.cuda.device_count()} card(s)"
    return f"mesh: data={dp} model={tp} over {world} devices"


def _serve(args: argparse.Namespace, device: torch.device, mesh) -> list[ExplainEngine]:
    """``run``'s body: rank 0 (or the only process) serves and prints, a
    worker rank serves rank 0's rows."""
    rank = dist.get_rank() if mesh is not None else 0
    if rank == 0 and mesh is not None:
        print(_mesh_line(*mesh.mesh.shape, device))
    say = print if rank == 0 else (lambda *a, **k: None)
    engine_kwargs: dict = {}
    fixed_reqs = None
    if args.workload == "vit":
        cfg = sized(VIT_CONFIG, reduced_vit, args)
        params, img = draw(cfg, args.seed, device)
        with torch.no_grad():
            target = int(torch.argmax(vit.forward(cfg, params, img), -1)[0])
        feats = vit.patchify(cfg, img).float().cpu().numpy()[0]
        fixed_reqs = [ExplainRequest(tokens=np.arange(cfg.num_patches, dtype=np.int32), target=target,
                                     features=feats)]
        engine_kwargs["seq_buckets"] = (cfg.num_patches,)
        say(f"vit workload: {cfg.num_patches} patches, predicted class {target}")
    else:
        cfg = sized(get_config(args.arch), reduced, args)
        if cfg.frontend or cfg.is_encdec:
            say(f"note: {cfg.name} frontend is stubbed; explaining token stream only")
        params, _ = draw(cfg, args.seed, device)
        if args.workload == "prompt":
            # one deterministic prompt: the same tokens every run, the target fixed
            prompt = (np.arange(1, 13, dtype=np.int32) * 7) % (cfg.vocab_size - 1) + 1
            fixed_reqs = [ExplainRequest(tokens=prompt, target=int(prompt[-1]))]
            say(f"prompt workload: tokens={prompt.tolist()} target={prompt[-1]}")
    if rank:
        serve_worker(cfg, params, device=device)
        return []
    with dispatch.controller() if mesh is not None else contextlib.nullcontext():
        return _rounds(args, device, mesh, cfg, params, fixed_reqs, engine_kwargs)


def _rounds(args, device, mesh, cfg, params, fixed_reqs, engine_kwargs) -> list[ExplainEngine]:
    """The traffic rounds of every schedule leg, and the closing lines."""
    rng = np.random.default_rng(args.seed)

    out, engines = None, []
    compare = (args.schedule,) if args.schedule == "uniform" else (args.schedule, "uniform")
    if METHODS[args.method].forward_only:
        # perturbation methods never touch the interpolation schedule: one
        # pass, no uniform comparison leg
        compare = (args.schedule,)
    for sched_name in compare:
        engine = ExplainEngine(
            cfg,
            params,
            method=args.method,
            schedule=sched_name,
            m=args.m,
            n_int=args.n_int,
            adaptive=args.adaptive,
            tol=args.tol,
            m_max=args.m_max,
            n_samples=args.n_samples,
            sigma=args.sigma,
            n_masks=args.n_masks,
            fused=args.fused,
            use_kernels=use_kernels(device, args.use_kernels),
            attn=args.attn,
            autotune=args.autotune,
            result_cache=args.result_cache * (1 << 20),
            hop_zero=args.hop_zero,
            mesh=mesh,
            device=device,
            **engine_kwargs,
        )
        engines.append(engine)
        # the warm state belongs to the primary --schedule engine only
        if args.warm_state and sched_name == args.schedule:
            from repro_torch.serve import load_warm_state

            rep = load_warm_state(engine, args.warm_state)
            if rep.restored:
                print(f"warm state: restored {rep.executables} executables via {rep.via}")
            else:
                print(f"warm state: cold start ({rep.reason})")
        if METHODS[args.method].forward_only:
            mode = f"P={engine.n_masks} masks (forward-only)"
        elif args.adaptive:
            mode = f"adaptive tol={args.tol} ladder={engine.m_ladder}"
        else:
            mode = f"m={args.m}"
        samples = f" samples={engine.n_samples}" if engine.n_samples > 1 else ""
        flags = (" fused" if args.fused else "") + (" kernels" if engine.use_kernels else "") \
            + (" autotuned" if args.autotune else "")
        print(f"method={args.method} schedule={sched_name} {mode}{samples}{flags} "
              f"traffic={args.rounds}x{args.requests} reqs S∈[{args.min_seq},{args.max_seq}]")
        sched = None
        if args.scheduler and engine.n_samples == 1:
            from repro_torch.serve import MixedScheduler, TenantPolicy

            tenants = {"default": TenantPolicy(rate=args.tenant_rate)} if args.tenant_rate else None
            sched = MixedScheduler(engine, max_queue=args.max_queue, tenants=tenants)
        elif args.scheduler:
            print("note: --scheduler serves per-row methods only; "
                  f"{args.method} (n_samples={engine.n_samples}) runs direct")
        for rnd in range(args.rounds):
            reqs = (fixed_reqs if fixed_reqs is not None
                    else make_traffic(cfg, args.requests, args.min_seq, args.max_seq, rng))
            t0 = time.perf_counter()
            if sched is not None:
                tickets = [sched.submit(r) for r in reqs]
                sched.run_until_idle()
                out = [t.result for t in tickets if t.result is not None]
                rej = sum(t.status.startswith("rejected") for t in tickets)
                if rej:
                    print(f"  round {rnd}: {rej} rejected "
                          f"(backpressure={sched.rejected_backpressure} rate={sched.rejected_rate})")
                if not out:
                    print(f" round {rnd}: all {len(reqs)} requests rejected")
                    continue
            else:
                out = engine.explain(reqs)
            wall = time.perf_counter() - t0
            deltas = [o["delta"] for o in out]
            line = (f" round {rnd}: wall={wall:.2f}s mean_delta={np.mean(deltas):.5f} "
                    f"max_delta={np.max(deltas):.5f}")
            if args.adaptive:
                line += (f" mean_m_used={np.mean([o.get('m_used', 0) for o in out]):.1f}"
                         f" conv={sum(o.get('converged', False) for o in out)}/{len(out)}")
            print(line)
        report(engine)
        if args.warm_state and sched_name == args.schedule:
            from repro_torch.serve import save_warm_state

            save_warm_state(engine, args.warm_state)
            with open(os.path.join(args.warm_state, "manifest.json")) as fh:
                n_saved = json.load(fh)["n_executables"]
            print(f"warm state: saved {n_saved} executables to {args.warm_state}")
    scores = np.asarray(out[0]["token_scores"])
    if args.workload == "prompt":
        print("per-token attribution (pos, token, score):")
        for i, (t, s) in enumerate(zip(fixed_reqs[0].tokens, scores)):
            print(f"  {i:3d} {int(t):6d} {s:+.6f}")
    elif args.workload == "vit":
        g = cfg.image_size // cfg.patch_size
        grid = scores.reshape(g, g)
        flat = np.argsort(-np.abs(grid), axis=None)[:5]
        print(f"top-5 attributed patches on the {g}x{g} grid (row, col, score):")
        for idx in flat:
            r, c = divmod(int(idx), g)
            print(f"  ({r}, {c}) {grid[r, c]:+.6f}")
    else:
        top = np.argsort(-np.abs(scores))[:5]
        print("top-5 attributed positions (last round, req 0):", top)
    return engines


def main(argv: Optional[list[str]] = None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
