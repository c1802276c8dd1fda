"""Time the launch plans of the stage-2 Triton kernels and the solve's variants on a CUDA card.

    PYTHONPATH=src python -m repro_torch.kernels.sweep [OUT.json]

At the CNN path's stage-2 shape (B=16, K=64, F=3072) and the ViT path's
(B=16, K=16, F=150,528), f32, times with a cold L2 (``cold_ms``)
``idgi_dots`` over its plans (steps a program, tile, warps, F split),
``interpolate`` and ``interp_add`` (with each carry rank: the (B, F) carry
broadcast over the steps and the (B, K, F) per-step carry) over tiles,
warps and rows a loop step. Each candidate is first held against its plain
version: the dots within 1e-5 of the sum of |terms|, the interpolants
within 1e-6. Then the Gauss–Jordan solve at 16 systems of 17×17 and of
65×65 (f32, LIME's normal equations): every kernel variant that holds N
(the warp variant at 1 to 8 systems a block), each first bit-equal to its
plain sweep, beside the plain sweep's time. Times every candidate twice, in
two rounds, so the spread shows the noise. Prints one line per candidate,
the fastest five at each shape, what the choosers (``common.dots_plan``,
``common.sweep_tile``, ``lstsq.kernel.solve_plan``) pick and, for the
chosen dots plan, the time of its first pass and of the split's second pass
alone; writes every time to OUT.json (default ``build/sweep_stage2.json``).
Needs a card, ``triton`` and ``nvcc``.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import common

SHAPES = {"cnn": (16, 64, 3072), "vit": (16, 16, 224 * 224 * 3)}
DOTS_KB = (2, 4, 8)
DOTS_ROW_BYTES = (2048, 4096)
DOTS_PROGRAMS_PER_SM = (0, 1, 2, 4, 8)  # 0: no split
INTERP_ROW_BYTES = common.SWEEP_ROW_BYTES
INTERP_WARPS = (1, 2, 4, 8)
INTERP_UNROLL = (1, 2, 4, 8, 16)
SOLVE_SHAPES = ((16, 17), (16, 65))  # (systems, N): LIME on the ViT's patches, on the CNN's cells
SOLVE_SYSTEMS = (1, 2, 4, 8)  # the warp variant's systems a block


def cold_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, timed with CUDA
    events. Each call is queued behind a read of 256 MB, which leaves none
    of ``fn``'s data in the 50 MB L2 (and no dirty lines to write back) and
    keeps the card busy while the host launches ``fn``, so the host's launch
    cost is hidden wherever the card would hide it in a stream of work."""
    flush = torch.ones(256 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(3):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    for start, end in events:
        flush.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / iters


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def dots_candidates(B: int, K: int, F: int, sms: int) -> list[common.DotsPlan]:
    """Every plan of the sweep at (B, K, F) f32, without repeats."""
    plans = []
    for kb in DOTS_KB:
        for row_bytes in DOTS_ROW_BYTES:
            block = row_bytes // 4
            tiles = _cdiv(F, block)
            for warps in sorted({row_bytes // 512, row_bytes // 1024}):
                for per_sm in DOTS_PROGRAMS_PER_SM:
                    split = min(tiles, max(1, _cdiv(per_sm * sms, B * _cdiv(K, kb))))
                    per = _cdiv(tiles, split)
                    plan = common.DotsPlan(kb, _cdiv(tiles, per), per * block, block, warps)
                    if plan not in plans:
                        plans.append(plan)
    return plans


def _timed_twice(cands: list, fn, name: str) -> list[dict]:
    """Time ``fn(c)`` for every candidate, all of them once and then all
    again, so the spread between the two rounds shows the noise."""
    rows = [{**c, "ms": []} for c in cands]
    for _ in range(2):
        for row, c in zip(rows, cands):
            row["ms"].append(cold_ms(lambda: fn(c)))
    for row in rows:
        print(f"  {name} {tuple(v for k, v in row.items() if k != 'ms')}: "
              + ", ".join(f"{t:.5f}" for t in row["ms"]) + " ms", flush=True)
    return rows


def sweep_dots(B: int, K: int, F: int, sms: int) -> list[dict]:
    from repro_torch.kernels.ig_accum import kernel, ref

    g = torch.Generator(device="cuda").manual_seed(0)
    grads = torch.randn((B, K, F), generator=g, device="cuda")
    diff = torch.rand((B, F), generator=g, device="cuda")
    s_ref, p_ref = ref.idgi_dots_ref(grads, diff)
    lim = (1e-5 * (grads * grads).sum(-1), 1e-5 * (grads * diff[:, None]).abs().sum(-1))
    plans = dots_candidates(B, K, F, sms)
    for plan in plans:
        out = kernel.launch_dots(grads, diff, plan)
        torch.cuda.synchronize()
        for got, want, tol in zip(out, (s_ref, p_ref), lim):
            if not bool(((got - want).abs() <= tol).all()):
                raise AssertionError(f"idgi_dots {plan} at {(B, K, F)}: disagrees with the plain version")
    cands = [{**p._asdict(), "programs": B * _cdiv(K, p.kb) * p.split} for p in plans]
    run = lambda c: kernel.launch_dots(grads, diff, common.DotsPlan(*(c[f] for f in common.DotsPlan._fields)))
    return _timed_twice(cands, run, "idgi_dots")


def dots_passes(B: int, K: int, F: int, sms: int) -> dict:
    """Where the time of the chosen dots plan goes: the whole call, its
    first pass alone and, with a split, its second pass alone (each cold)."""
    from repro_torch.kernels.ig_accum import kernel

    plan = common.dots_plan(B, K, F, torch.float32, sms)
    g = torch.Generator(device="cuda").manual_seed(0)
    grads = torch.randn((B, K, F), generator=g, device="cuda")
    diff = torch.rand((B, F), generator=g, device="cuda")
    out = torch.empty((2, B, K), device="cuda")
    part = torch.empty((2, plan.split, B, K), device="cuda")
    triton, _, first, second = kernel._compiled()
    times = {"plan": tuple(plan), "call_ms": cold_ms(lambda: kernel.launch_dots(grads, diff, plan)),
             "first_pass_ms": cold_ms(lambda: first[(B, triton.cdiv(K, plan.kb), plan.split)](
                 grads, diff, part, K, F, plan.chunk, KB=plan.kb, BLOCK_F=plan.block_f,
                 num_warps=plan.num_warps))}
    if plan.split > 1:
        times["second_pass_ms"] = cold_ms(lambda: second[(triton.cdiv(B * K, kernel.DOTS_SUM_BLOCK), 2)](
            part, out, B * K, SPLIT=plan.split, BLOCK=kernel.DOTS_SUM_BLOCK, num_warps=4))
    print(f"  idgi_dots chosen plan {times}", flush=True)
    return times


def _interp_cands() -> list[dict]:
    return [{"block_f": row_bytes // 4, "num_warps": warps, "unroll": unroll}
            for row_bytes in INTERP_ROW_BYTES for warps in INTERP_WARPS for unroll in INTERP_UNROLL
            if 16 * 32 * warps <= row_bytes]


def sweep_interp(B: int, K: int, F: int) -> list[dict]:
    from repro_torch.kernels.interpolate import kernel, ref

    g = torch.Generator(device="cuda").manual_seed(1)
    x, b = torch.rand((B, F), generator=g, device="cuda"), torch.rand((B, F), generator=g, device="cuda")
    a = torch.rand((B, K), generator=g, device="cuda")
    want = ref.interpolate_ref(x, b, a)
    out = torch.empty_like(want)
    cands = _interp_cands()
    run = lambda c: kernel.launch_interp(x, b, a, out, c["block_f"], c["num_warps"], c["unroll"])
    for c in cands:
        out.zero_()
        run(c)
        torch.cuda.synchronize()
        if not float((out - want).abs().max()) <= 1e-6:
            raise AssertionError(f"interpolate {c} at {(B, K, F)}: disagrees with the plain version")
    return _timed_twice(cands, run, "interpolate")


def sweep_interp_add(B: int, K: int, F: int, step_carry: bool) -> list[dict]:
    from repro_torch.kernels.interp_accum import kernel, ref

    g = torch.Generator(device="cuda").manual_seed(2)
    x, b = torch.rand((B, F), generator=g, device="cuda"), torch.rand((B, F), generator=g, device="cuda")
    a = torch.rand((B, K), generator=g, device="cuda")
    u = torch.randn((B, K, F) if step_carry else (B, F), generator=g, device="cuda") * 0.01
    want = ref.interp_add_ref(x, b, a, u)
    out = torch.empty_like(want)
    run = lambda c: kernel.launch_interp_add(x, b, a, u, out, c["block_f"], c["num_warps"], c["unroll"])
    cands = _interp_cands()
    for c in cands:
        out.zero_()
        run(c)
        torch.cuda.synchronize()
        if not float((out - want).abs().max()) <= 1e-6:
            raise AssertionError(f"interp_add {c} at {(B, K, F)}: disagrees with the plain version")
        c["bit_equal"] = bool(torch.equal(out, want))
    return _timed_twice(cands, run, "interp_add " + ("per-step" if step_carry else "broadcast"))


def sweep_solve(B: int, N: int) -> dict:
    """Every variant of the solve that holds N, bit-equal to the plain
    sweep first, timed twice; and the plain sweep's time."""
    from repro_torch.kernels.lstsq import kernel, ref

    g = torch.Generator(device="cuda").manual_seed(3)
    P = max(64, 4 * N)  # LIME's design: binary groups and an intercept, full rank
    X = (torch.rand((B, P, N), generator=g, device="cuda") < 0.5).float()
    X[..., -1] = 1
    w, y = torch.rand((B, P), generator=g, device="cuda"), torch.randn((B, P), generator=g, device="cuda")
    A, rhs = ref.prepare_normal_eqs(*ref.normal_eqs(X, w, y), ridge=1e-2)
    want = ref.gauss_jordan_ref(A, rhs)
    out = torch.empty_like(want)
    plans = []
    for v in kernel.VARIANTS:
        plan = kernel.variant_plan(v, N, A.dtype)
        if plan is not None and v == "warp":
            plans += [plan._replace(threads=32 * n, systems=n) for n in SOLVE_SYSTEMS]
        elif plan is not None:
            plans.append(plan)
    for plan in plans:
        out.zero_()
        kernel.launch_solve(A, rhs, out, plan)
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            raise AssertionError(f"wls_solve {plan} at B={B} N={N}: not bit-equal to the plain sweep")
    plan_of = lambda c: kernel.SolvePlan(*(c[f] for f in kernel.SolvePlan._fields))
    run = lambda c: kernel.launch_solve(A, rhs, out, plan_of(c))
    rows = _timed_twice([p._asdict() for p in plans], run, "wls_solve")
    plain = cold_ms(lambda: ref.gauss_jordan_ref(A, rhs))
    limit = torch.cuda.get_device_properties(A.device).shared_memory_per_block_optin
    print(f"  wls_solve B={B} N={N}: plain sweep {plain:.5f} ms; "
          f"chosen {tuple(kernel.solve_plan(N, A.dtype, limit))}", flush=True)
    return {"plans": rows, "plain_ms": plain}


def _fastest(kern: str, rows: list[dict], chosen: tuple) -> None:
    print(f"  {kern} fastest (mean of the two rounds): " + "; ".join(
        f"{tuple(v for k, v in r.items() if k != 'ms')} {sum(r['ms']) / 2:.5f}"
        for r in sorted(rows, key=lambda r: sum(r["ms"]))[:5]) + f"; chosen {chosen}")


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("the sweep needs a CUDA card", file=sys.stderr)
        return 1
    out_path = Path(argv[0]) if argv else common.BUILD_DIR / "sweep_stage2.json"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    from repro_torch.kernels.interp_accum.kernel import interp_add_plan
    from repro_torch.kernels.interpolate.kernel import INTERP_UNROLL as unroll
    from repro_torch.kernels.lstsq.kernel import solve_plan

    sms = common.sm_count("cuda")
    smem_limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    result = {"device": smi, "idgi_dots": {}, "interpolate": {}, "interp_add": {}, "wls_solve": {}}
    for name, (B, K, F) in SHAPES.items():
        print(f"{name} shape B={B} K={K} F={F} f32:")
        dots, interp = sweep_dots(B, K, F, sms), sweep_interp(B, K, F)
        result["idgi_dots"][name], result["interpolate"][name] = dots, interp
        result.setdefault("idgi_dots_passes", {})[name] = dots_passes(B, K, F, sms)
        tile = common.sweep_tile(B, F, torch.float32, sms)
        _fastest("idgi_dots", dots, tuple(common.dots_plan(B, K, F, torch.float32, sms)))
        _fastest("interpolate", interp, (*tile, unroll))
        for form, step in (("broadcast", False), ("per-step", True)):
            rows = sweep_interp_add(B, K, F, step)
            result["interp_add"][f"{name} {form}"] = rows
            _fastest(f"interp_add {form}", rows, interp_add_plan(B, F, torch.float32, step, sms))
    for B, N in SOLVE_SHAPES:
        print(f"solve B={B} N={N} f32:")
        result["wls_solve"][f"B={B} N={N}"] = res = sweep_solve(B, N)
        _fastest("wls_solve", res["plans"], tuple(solve_plan(N, torch.float32, smem_limit)))
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
