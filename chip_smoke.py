"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Needs a CUDA card and the ``triton`` package; exits non-zero at once when
``torch.cuda.is_available()`` is false. Imports nothing of JAX or ``repro``.
Phases, each raising on a failed gate:

  1. device — the ``nvidia-smi`` name and power-limit line;
  2. kernels — builds the four Triton kernels of the slice (the compile
     cache goes to ``build/triton``) and holds each against its plain
     PyTorch version on the card: at the main path's shape (B=16, K=64,
     F=3072, f32), at a ragged masked shape through the op wrappers, and in
     bf16 for the two interpolation kernels; times the kernel, its plain
     version and one PyTorch library call of the same function, each with
     a cold L2, beside the bound the card's bandwidth sets;
  3. the slice — the paper CNN at ``CnnConfig()`` width with seeded random
     weights answers 4 batches of 16 seeded images through
     ``Explainer(method="ig", schedule="paper", m=64, n_int=4)``: fixed-m
     unfused, fixed-m fused and ``attribute_adaptive(tol=1e-2)``. Gates:
     finite results, every kernel of each path launched, fused agrees with
     unfused, resume is bit-identical to a fixed run over the refined
     schedule, and the first batch agrees with the port run on CPU copies.

Before the last line it prints one JSON object ``{"kernels": [...]}`` (per
kernel: launches on the slice, errors, ms, plain_ms, bound_ms, library_ms);
the last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
DEV = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
B, K, F = 16, 64, 3072  # the main path's stage-2 shape: 16 images, m=64, 32·32·3
N_BATCHES, M, N_INT, TOL = 4, 64, 4, 1e-2
TOL_LADDER = 0.0  # every row whose δ is not exactly 0 climbs the whole ladder
TOL_F32 = 1e-6  # elementwise f32 kernels: FMA contraction is off, rounding matches
TOL_SUM = 1e-5  # K-sums, relative to the largest |value|: another summation order
TOL_BF16 = 2.0**-7  # one bf16 ulp for values in [1, 2)
# the Triton kernels' names in a profiler trace
PORT_KERNELS = ("_interp_kernel", "_accum_kernel", "_interp_add_kernel", "_accum_cot_kernel")


def _sync():
    if DEV == "cuda":
        torch.cuda.synchronize()


def _cold_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, timed with CUDA
    events. Each call is queued behind a read of 256 MB, which leaves none
    of ``fn``'s data in the 50 MB L2 (and no dirty lines to write back) and
    keeps the card busy while the host launches ``fn``, so the host's launch
    cost is hidden wherever the card would hide it in a stream of work."""
    flush = torch.ones(256 << 20, dtype=torch.uint8, device=DEV)
    for _ in range(3):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    for start, end in events:
        flush.sum()
        start.record()
        fn()
        end.record()
    _sync()
    return sum(start.elapsed_time(end) for start, end in events) / iters


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"shape/dtype {tuple(got.shape)} {got.dtype} != {tuple(want.shape)} {want.dtype}")
    return float((got.float() - want.float()).abs().max())


def _check(name: str, err: float, tol: float) -> None:
    print(f"  {name}: max_abs_err={err:.3g} tol={tol:.3g}")
    if not err <= tol:
        raise AssertionError(f"{name}: error {err} above tolerance {tol}")


def _bound(nbytes: int, flops: int) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def kernel_phase() -> list[dict]:
    """Each kernel vs its plain version on the card; returns one record each."""
    from repro_torch.core import methods, paths
    from repro_torch.kernels.ig_accum import kernel as k_acc, ops as o_acc, ref as r_acc
    from repro_torch.kernels.interp_accum import kernel as k_ia, ops as o_ia, ref as r_ia
    from repro_torch.kernels.interpolate import kernel as k_int, ops as o_int, ref as r_int

    g = torch.Generator(device=DEV).manual_seed(0)
    rnd = lambda *s: torch.rand(s, generator=g, device=DEV)
    x, b = rnd(B, F), rnd(B, F)  # images in [0, 1), like the slice's
    a = rnd(B, K)
    w = rnd(B, K) / K
    acc = torch.randn(B, F, generator=g, device=DEV)
    grads = torch.randn(B, K, F, generator=g, device=DEV)
    carry = torch.randn(B, F, generator=g, device=DEV) * 0.01
    es = 4  # f32 bytes

    specs = [
        dict(name="interpolate", source="src/repro_torch/kernels/interpolate/kernel.py",
             replaces="src/repro/kernels/interpolate/kernel.py:30",
             kernel=lambda: k_int.interpolate_triton(x, b, a),
             plain=lambda: r_int.interpolate_ref(x, b, a),
             library=lambda: torch.lerp(b[:, None, :], x[:, None, :], a[:, :, None]),
             tol=TOL_F32, nbytes=es * (2 * B * F + B * K + B * K * F), flops=B * F + 2 * B * K * F),
        dict(name="ig_accum", source="src/repro_torch/kernels/ig_accum/kernel.py",
             replaces="src/repro/kernels/ig_accum/kernel.py:133",
             kernel=lambda: k_acc.ig_accum_triton(acc, grads, w),
             plain=lambda: r_acc.ig_accum_ref(acc, grads, w),
             library=lambda: torch.baddbmm(acc[:, None, :], w[:, None, :], grads),
             tol=None, nbytes=es * (2 * B * F + B * K + B * K * F), flops=2 * B * K * F + B * F),
        dict(name="interp_add", source="src/repro_torch/kernels/interp_accum/kernel.py",
             replaces="src/repro/kernels/interp_accum/kernel.py:64",
             kernel=lambda: k_ia.interp_add_triton(x, b, a, carry),
             plain=lambda: r_ia.interp_add_ref(x, b, a, carry),
             library=None,
             tol=TOL_F32, nbytes=es * (3 * B * F + B * K + B * K * F), flops=B * F + 3 * B * K * F),
        dict(name="accum_cot", source="src/repro_torch/kernels/interp_accum/kernel.py",
             replaces="src/repro/kernels/interp_accum/kernel.py:104",
             kernel=lambda: k_ia.accum_cot_triton(grads),
             plain=lambda: r_ia.accum_cot_ref(grads),
             library=lambda: grads.sum(1),
             tol=None, nbytes=es * (B * K * F + B * F), flops=B * K * F),
    ]
    print(f"kernels at the main path's shape B={B} K={K} F={F} f32:")
    records = []
    for s in specs:
        got, want = s["kernel"](), s["plain"]()
        _sync()
        err = _err(got, want)
        tol = s["tol"] if s["tol"] is not None else TOL_SUM * float(want.abs().max())
        _check(s["name"], err, tol)
        bound_ms, bound_by = _bound(s["nbytes"], s["flops"])
        records.append({
            "name": s["name"], "route": "triton", "source": s["source"], "replaces": s["replaces"],
            "launches": 0, "max_abs_err": err, "tolerance": tol,
            "ms": _cold_ms(s["kernel"]), "plain_ms": _cold_ms(s["plain"]),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None if s["library"] is None else _cold_ms(s["library"]),
        })

    print("kernels at a ragged shape (B=5, K=37, F=3·31·29, masked) through the op wrappers:")
    Bm, Km, feat = 5, 37, (31, 29, 3)
    xm, bm = rnd(Bm, *feat), rnd(Bm, *feat)
    am, wm = rnd(Bm, Km), rnd(Bm, Km) / Km
    mask = rnd(Bm, 31) > 0.3
    gm = torch.randn((Bm, Km) + feat, generator=g, device=DEV)
    accm = torch.randn((Bm,) + feat, generator=g, device=DEV)
    um = torch.randn((Bm,) + feat, generator=g, device=DEV) * 0.01
    _check("interpolate", _err(o_int.interpolate(xm, bm, am, mask=mask),
                               paths.interpolate(xm, bm, am, mask=mask)), TOL_F32)
    want = methods.riemann_accum(accm, gm, wm, mask=mask)
    _check("ig_accum", _err(o_acc.ig_accum(accm, gm, wm, mask=mask), want),
           TOL_SUM * float(want.abs().max()))
    _check("interp_add", _err(o_ia.interp_accum(xm, bm, am, um, mask=mask),
                              paths.interp_add(xm, bm, am, um, mask=mask)), TOL_F32)
    u1, u2 = um.clone().requires_grad_(), um.clone().requires_grad_()
    (g1,) = torch.autograd.grad((o_ia.interp_accum(xm, bm, am, u1, mask=mask) * gm).sum(), u1)
    (g2,) = torch.autograd.grad((paths.interp_add(xm, bm, am, u2, mask=mask) * gm).sum(), u2)
    _check("accum_cot", _err(g1, g2), TOL_SUM * float(g2.abs().max()))
    us = torch.randn((Bm, Km) + feat, generator=g, device=DEV) * 0.01
    _check("interp_add (per-step carry)", _err(o_ia.interp_accum(xm, bm, am, us, mask=mask),
                                               paths.interp_add(xm, bm, am, us, mask=mask)), TOL_F32)

    print("kernels in bf16 at the main path's shape:")
    xb, bb = x.bfloat16(), b.bfloat16()
    _check("interpolate bf16", _err(k_int.interpolate_triton(xb, bb, a), r_int.interpolate_ref(xb, bb, a)),
           TOL_BF16)
    _check("interp_add bf16", _err(k_ia.interp_add_triton(xb, bb, a, carry),
                                   r_ia.interp_add_ref(xb, bb, a, carry)), TOL_BF16)
    _check("accum_cot bf16", _err(k_ia.accum_cot_triton(grads.bfloat16()),
                                  r_ia.accum_cot_ref(grads.bfloat16())),
           TOL_SUM * float(grads.abs().sum(1).max()))
    return records


def _delta_tol(res) -> torch.Tensor:
    """δ agreement allowed between two runs of one explanation: 1e-6 plus
    1e-4 of |f(x) − f(x′)|, for f32 sums taken in another order."""
    return 1e-6 + 1e-4 * (res.f_x - res.f_baseline).abs()


def _attr_close(name, got, want, rows=None) -> None:
    """Attributions per row within 1e-4 of the row's largest |attribution|."""
    d = (got.float() - want.float()).flatten(1).abs().amax(1)
    lim = 1e-4 * want.float().flatten(1).abs().amax(1) + 1e-12
    ok = d <= lim
    if rows is not None:
        ok = ok | ~rows
    print(f"  {name}: max row err/limit {float((d / lim).max()):.3g}")
    if not bool(ok.all()):
        raise AssertionError(f"{name}: rows {torch.nonzero(~ok).flatten().tolist()} disagree")


def _profile(name: str, fn) -> None:
    """Print the card's busy share of one call of ``fn`` and its top kernels
    by device time (torch.profiler); "not measured" if the trace has none."""
    from torch.profiler import ProfilerActivity, profile

    _sync()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        _sync()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {e.key: e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
    busy = sum(kernels.values())
    if not busy:
        print(f"  profile {name}: device time not measured")
        return
    ours = sum(v for k, v in kernels.items() if k in PORT_KERNELS)
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    print(f"  profile {name}: wall {wall_us / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms "
          f"({busy / wall_us:.3f}), the port's kernels {ours / 1e3:.3f} ms, "
          f"{len(kernels)} kernel names; top: "
          + "; ".join(f"{k[:48]} {v / 1e3:.3f} ms" for k, v in top))


def _launched(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def _near_tie_rows(vals: torch.Tensor, m: int) -> torch.Tensor:
    """Rows whose largest-remainder ranking is within 1e-5 of a tie (or of a
    floor boundary), where two devices' probe values may allocate apart."""
    from repro_torch.core import schedule

    imp = schedule.normalized_deltas(vals)
    n = imp.shape[-1]
    q = imp * (m - n)
    rem = q - torch.floor(q)
    short = (m - n) - torch.floor(q).sum(-1)
    srt = torch.sort(rem, dim=-1, descending=True).values
    near = (torch.minimum(rem, 1 - rem) < 1e-5).any(-1)
    for r in range(vals.shape[0]):
        s = int(short[r])
        if 0 < s < n and float(srt[r, s - 1] - srt[r, s]) < 1e-5:
            near[r] = True
    return near


def slice_phase() -> dict:
    """The paper's explainer on the paper CNN, 4 batches of 16, with gates."""
    from repro_torch.configs.paper_cnn import CnnConfig
    from repro_torch.core import ig, probes, schedule
    from repro_torch.core.api import Explainer
    from repro_torch.kernels import common
    from repro_torch.models.cnn import PaperCNN, init_params

    cfg = CnnConfig()
    params = init_params(cfg, torch.Generator().manual_seed(0), device=DEV)
    model = PaperCNN(cfg, params)
    model_cpu = PaperCNN(cfg, {k: {n: t.cpu() for n, t in grp.items()} for k, grp in params.items()})
    ex = Explainer(model.prob, method="ig", schedule="paper", m=M, n_int=N_INT, device=DEV)
    ex_fused = replace(ex, fused=True)
    ex_uniform = replace(ex, schedule="uniform")
    gen = torch.Generator().manual_seed(1)
    s = cfg.image_size
    paths_launched = {}

    def timed(fn):
        _sync()
        t0 = time.perf_counter()
        before = dict(common.LAUNCHES)
        out = fn()
        _sync()
        return out, (time.perf_counter() - t0) * 1e3, _launched(before, common.LAUNCHES)

    def need(path, launched, names):
        paths_launched.setdefault(path, launched)
        missing = [n for n in names if launched[n] == 0]
        extra = [n for n in launched if n not in names and launched[n]]
        if missing or extra:
            raise AssertionError(f"{path}: kernels not launched {missing}, unexpected {extra}")

    common.reset_launches()  # the slice's own count starts here
    for i in range(N_BATCHES):
        x_cpu = torch.rand((B, s, s, cfg.channels), generator=gen)
        t_cpu = torch.randint(0, cfg.num_classes, (B,), generator=gen)
        x, t = x_cpu.to(DEV), t_cpu.to(DEV)
        bl = torch.zeros_like(x)

        _, probe_ms, _ = timed(lambda: ex.build_schedule(x, bl, t))
        res_u, ms_u, l_u = timed(lambda: ex.attribute(x, bl, t))
        need("fixed-m unfused", l_u, ("interpolate", "ig_accum"))
        res_f, ms_f, l_f = timed(lambda: ex_fused.attribute(x, bl, t))
        need("fixed-m fused", l_f, ("interp_add", "accum_cot"))
        (res_a, info), ms_a, l_a = timed(lambda: ex.attribute_adaptive(x, bl, t, tol=TOL))
        need("adaptive", l_a, ("interpolate", "ig_accum"))
        # a zero tolerance sends rows up the whole ladder, so the hop path
        # (row gathers, refinement, resume) runs on the card too
        (res_e, info_e), ms_e, l_e = timed(lambda: ex.attribute_adaptive(x, bl, t, tol=TOL_LADDER))
        need("adaptive, escalating", l_e, ("interpolate", "ig_accum"))
        if not (info_e["hops"] > 0).any():
            raise AssertionError(f"batch {i}: tol={TOL_LADDER} ran no hop")
        res_uni, _, _ = timed(lambda: ex_uniform.attribute(x, bl, t))
        for name, res in (("unfused", res_u), ("fused", res_f), ("adaptive", res_a),
                          ("adaptive, escalating", res_e)):
            if not all(bool(torch.isfinite(v).all()) for v in res):
                raise AssertionError(f"batch {i} {name}: non-finite result")
            if res.attributions.shape != x.shape:
                raise AssertionError(f"batch {i} {name}: shape {tuple(res.attributions.shape)}")
        print(f"batch {i}:")
        _attr_close("fused vs unfused", res_f.attributions, res_u.attributions)
        if not bool(((res_f.delta - res_u.delta).abs() <= _delta_tol(res_u)).all()):
            raise AssertionError(f"batch {i}: fused δ disagrees with unfused")

        # resume: one ladder hop == one fixed run over the refined schedule
        for e in (ex, ex_fused):
            _, st, sched = e.start(x, bl, t)
            refined = schedule.refine_nested(sched)
            new = schedule.Schedule(refined.alphas[:, M:], refined.weights[:, M:])
            (res1, _), _, l_hop = timed(lambda: e.resume(x, bl, t, new, st))
            need("adaptive hop" + (" fused" if e.fused else ""), l_hop,
                 ("interp_add", "accum_cot") if e.fused else ("interpolate", "ig_accum"))
            fixed = ig.attribute(model.prob, x, bl, refined, t, chunk=e.adaptive_chunk, **e.ig_kwargs())
            if not (torch.equal(res1.attributions, fixed.attributions) and torch.equal(res1.delta, fixed.delta)):
                raise AssertionError(f"batch {i}: resume (fused={e.fused}) not bit-identical")

        print(f"  wall ms: probe {probe_ms:.2f}, unfused {ms_u:.2f}, fused {ms_f:.2f}, "
              f"adaptive {ms_a:.2f}; probe share of unfused {probe_ms / ms_u:.3f}")
        print(f"  mean δ at m={M}: paper {float(res_u.delta.mean()):.3g}, "
              f"uniform {float(res_uni.delta.mean()):.3g}; adaptive m_used mean "
              f"{float(info['m_used'].mean()):.1f}, hops {info['hops'].tolist()}")
        print(f"  escalating adaptive (tol={TOL_LADDER}): {ms_e:.2f} ms, hops "
              f"{int(info_e['hops'].sum())}, steps {info_e['total_steps']}, launches {l_e}")
        if i == 1:  # warm: where one explanation's time goes
            _profile("unfused", lambda: ex.attribute(x, bl, t))
            _profile("fused", lambda: ex_fused.attribute(x, bl, t))

        if i == 0:  # the card against the port on CPU copies, one batch
            ex_cpu = replace(ex, f=model_cpu.prob, device="cpu")
            vals = probes.run_probe("boundary", model.prob, x, bl, t, n_int=N_INT).vals.cpu()
            vals_cpu = probes.run_probe("boundary", model_cpu.prob, x_cpu, bl.cpu(), t_cpu,
                                        n_int=N_INT).vals
            norm = lambda v: schedule.allocate_steps(schedule.normalized_deltas(v), M)
            tied = _near_tie_rows(vals_cpu, M) | _near_tie_rows(vals, M)
            same = (norm(vals) == norm(vals_cpu)).all(-1)
            print(f"  card vs CPU: near-tie rows {torch.nonzero(tied).flatten().tolist()}")
            if not bool((same | tied).all()):
                raise AssertionError("card and CPU allocate steps differently off a tie")
            res_c = ex_cpu.attribute(x_cpu, bl.cpu(), t_cpu)
            _attr_close("card vs CPU attributions", res_u.attributions.cpu(), res_c.attributions, ~tied)
            dd = (res_u.delta.cpu() - res_c.delta).abs()
            if not bool(((dd <= _delta_tol(res_c)) | tied).all()):
                raise AssertionError(f"card vs CPU δ: {dd.tolist()}")
            _, info_c = ex_cpu.attribute_adaptive(x_cpu, bl.cpu(), t_cpu, tol=TOL)
            thr = info_c["threshold"]
            edge = ((abs(info["delta"] - thr) <= 1e-3 * thr) | (abs(info_c["delta"] - thr) <= 1e-3 * thr))
            print(f"  card vs CPU adaptive: rows near the threshold {list(edge.nonzero()[0])}")
            for key in ("m_used", "hops", "converged"):
                if not ((info[key] == info_c[key]) | edge).all():
                    raise AssertionError(f"card vs CPU adaptive {key}: {info[key]} != {info_c[key]}")
    return {"launches": dict(common.LAUNCHES), "per_path": paths_launched}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import common  # fails, printing nothing, outside a checkout

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    # fixed cuDNN algorithms: a resumed rung must see the same gradients as
    # the fixed run it is compared with, bit for bit
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    triton, _ = common.import_triton()  # sets the compile cache first
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, triton {triton.__version__}")

    t0 = time.perf_counter()
    records = kernel_phase()
    print(f"kernel phase: {time.perf_counter() - t0:.1f} s (Triton builds included)")
    t0 = time.perf_counter()
    out = slice_phase()
    print(f"slice phase: {time.perf_counter() - t0:.1f} s")
    print("launches per path (one call each):", json.dumps(out["per_path"]))
    for r in records:
        r["launches"] = out["launches"][r["name"]]
        if r["launches"] == 0:
            raise AssertionError(f"kernel {r['name']} never launched on the slice")
    print(json.dumps({"kernels": records}))
    name = torch.cuda.get_device_name(0)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
