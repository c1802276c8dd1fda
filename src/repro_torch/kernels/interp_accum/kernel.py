"""Triton kernels of the fused stage 2: interpolate-plus-carry and its backward.

Replace ``repro/kernels/interp_accum/kernel.py``:

  * ``interp_add_triton`` ← ``interp_add_pallas`` (``_interp_add_bcast_kernel``
    and ``_interp_add_step_kernel``): b + α(x − b) at input precision, plus
    an f32 carry, cast to x.dtype. The carry is (B, F), broadcast over the
    steps (the riemann class), or (B, K, F), one per step (IDGI's class);
    both are one kernel here, chosen by a compile-time flag.
  * ``accum_cot_triton`` ← ``accum_cot_pallas`` (``_accum_cot_kernel``):
    Σ_k ḡ[:, k] in f32, the backward of the broadcast carry.

Bound on the H100: bytes, both kernels. ``interp_add`` reads x, b (B·F
each), the alphas and the carry and writes (B, K, F): at B=16, K=64,
F=3072 f32 about 13 MB with the broadcast carry, about 4 µs at 3.35 TB/s;
the per-step carry is read once more in full, (B, K, F) f32, so that form
moves about twice the bytes. ``accum_cot`` reads the (B, K, F) cotangent
once and writes (B, F) f32: the same 13 MB.

Design: both are K-sweeps on one tile (``common.sweep_tile``), one program
per (row, F tile), each thread on its own columns: at the ViT's (16, ·,
150,528) 2048 f32 columns on 4 warps, at the CNN's (16, ·, 3072) 128 on
one; bf16 takes twice the columns. The forward loads its x and b tile once,
forms d = x − b, then sweeps K, UNROLL rows a loop step: the step's alphas
come as one small vector, the rows' carry tiles (per-step form) are loaded
together before their stores, and each thread stores 16 bytes a row of its
own columns. The broadcast carry is loaded once with x and b; the two carry
ranks are one body, chosen by a compile-time flag. UNROLL keeps a thread at
64 values a loop step (``interp_add_plan``): 4 rows at the ViT's tile, 16
at the CNN's. The per-step form takes its tile from the carry's f32 rows,
so bf16 inputs do not double a thread's carry registers. The interpolation
rounds after each operation in x.dtype, then adds the carry in f32 — the
``repro.core.paths.interp_add`` dtype contract, so at carry 0 the nodes
equal the unfused path's even in bf16 — and FMA contraction is off, so f32
rounds as the plain version does, bit for bit. The
backward sweeps K one row at a time (COT_UNROLL rows a loop step, their
loads in flight together) into a per-thread f32 vector: each thread sums
only its own columns, so nothing is reduced across threads. No atomics and
a fixed sum order (k = 0, 1, …), so the same input gives the same bits.
Ragged F and K are masked, with no padding copies.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import common

INTERP_ADD_VALUES = 64  # interp_add: a thread's values a loop step, rows × its columns
COT_UNROLL = 8  # accum_cot: K rows whose loads are in flight together

tl = None  # triton.language, bound on the first launch


def _interp_add_kernel(x_ptr, b_ptr, a_ptr, u_ptr, o_ptr, K, F, STEP_CARRY: "tl.constexpr",
                       UNROLL: "tl.constexpr", BLOCK_F: "tl.constexpr"):
    row = tl.program_id(0).to(tl.int64)
    offs_f = tl.program_id(1) * BLOCK_F + tl.arange(0, BLOCK_F)
    fmask = offs_f < F
    x = tl.load(x_ptr + row * F + offs_f, mask=fmask, other=0.0)
    b = tl.load(b_ptr + row * F + offs_f, mask=fmask, other=0.0)
    dt = x.dtype
    bf = b.to(tl.float32)
    d = (x.to(tl.float32) - bf).to(dt).to(tl.float32)
    base = row * K * F
    if STEP_CARRY:
        u_ptrs = u_ptr + base
    else:
        u = tl.load(u_ptr + row * F + offs_f, mask=fmask, other=0.0)
    rows = tl.arange(0, UNROLL)
    offs = rows[:, None] * F + offs_f[None, :]  # (UNROLL, BLOCK_F): each thread its own columns
    o_ptrs = o_ptr + base
    a_ptrs = a_ptr + row * K + rows
    for k0 in range(0, K, UNROLL):
        live = k0 + rows < K
        mask = live[:, None] & fmask[None, :]
        if STEP_CARRY:  # the UNROLL rows' carry loads go out together, before their stores
            c = tl.load(u_ptrs + offs, mask=mask, other=0.0)
            u_ptrs += UNROLL * F
        else:
            c = u[None, :]
        a = tl.load(a_ptrs, mask=live, other=0.0).to(dt).to(tl.float32)
        step = (a[:, None] * d[None, :]).to(dt).to(tl.float32)
        xi = (bf[None, :] + step).to(dt).to(tl.float32)
        tl.store(o_ptrs + offs, (xi + c).to(o_ptr.dtype.element_ty), mask=mask)
        o_ptrs += UNROLL * F
        a_ptrs += UNROLL


def _accum_cot_kernel(g_ptr, o_ptr, K, F, UNROLL: "tl.constexpr", BLOCK_F: "tl.constexpr"):
    row = tl.program_id(0).to(tl.int64)
    offs_f = tl.program_id(1) * BLOCK_F + tl.arange(0, BLOCK_F)
    fmask = offs_f < F
    ptrs = g_ptr + row * K * F + offs_f
    acc = tl.zeros([BLOCK_F], dtype=tl.float32)
    for k0 in range(0, K, UNROLL):
        for kk in tl.static_range(UNROLL):  # one row at a time, each thread its own columns
            acc += tl.load(ptrs, mask=fmask & (k0 + kk < K), other=0.0).to(tl.float32)
            ptrs += F
    tl.store(o_ptr + row * F + offs_f, acc, mask=fmask)


@functools.cache
def _compiled():
    global tl
    triton, tl = common.import_triton()
    return triton, triton.jit(_interp_add_kernel), triton.jit(_accum_cot_kernel)


def interp_add_triton(
    x: torch.Tensor, baseline: torch.Tensor, alphas: torch.Tensor, carry: torch.Tensor
) -> torch.Tensor:
    """x, baseline: (B, F); alphas: (B, K) f32; carry: (B, F) or (B, K, F)
    f32, all CUDA -> (B, K, F) in x.dtype."""
    B, F = x.shape
    K = alphas.shape[1]
    step_carry = carry.dim() == 3
    x = common.check_flat("x", x, (B, F), common.FLOATS)
    baseline = common.check_flat("baseline", baseline, (B, F), (x.dtype,))
    alphas = common.check_flat("alphas", alphas, (B, K), (torch.float32,))
    carry = common.check_flat("carry", carry, (B, K, F) if step_carry else (B, F), (torch.float32,))
    out = torch.empty((B, K, F), dtype=x.dtype, device=x.device)
    launch_interp_add(x, baseline, alphas, carry, out,
                      *interp_add_plan(B, F, x.dtype, step_carry, common.sm_count(x.device)))
    common.LAUNCHES["interp_add"] += 1
    common.CARRY_RANKS[carry.dim()] += 1
    return out


def interp_add_plan(B: int, F: int, dtype: torch.dtype, step_carry: bool,
                    sms: int) -> tuple[int, int, int]:
    """(BLOCK_F, num_warps, UNROLL) of ``interp_add`` over (B, ·, F) on
    ``sms`` SMs: ``common.sweep_tile``'s tile (for the per-step form, over
    its f32 carry rows, the wider stream in bf16), and as many rows a loop
    step as make ``INTERP_ADD_VALUES`` values a thread, so that the rows'
    carry stays in registers (at 16 columns a thread, 8 rows of it spilled).

        >>> interp_add_plan(16, 150_528, torch.float32, True, 132)
        (2048, 4, 4)
        >>> interp_add_plan(16, 3072, torch.float32, False, 132)
        (128, 1, 16)
    """
    block, warps = common.sweep_tile(B, F, torch.float32 if step_carry else dtype, sms)
    return block, warps, INTERP_ADD_VALUES // (block // (32 * warps))


def launch_interp_add(x: torch.Tensor, baseline: torch.Tensor, alphas: torch.Tensor, carry: torch.Tensor,
                      out: torch.Tensor, block: int, warps: int, unroll: int) -> None:
    """Write b + α(x − b) + carry for checked operands into ``out`` on a tile
    of ``block`` columns, ``warps`` warps and ``unroll`` rows a loop step.
    Counts nothing (``interp_add_triton`` does)."""
    (B, F), K = x.shape, alphas.shape[1]
    triton, kern, _ = _compiled()
    kern[(B, triton.cdiv(F, block))](x, baseline, alphas, carry, out, K, F, STEP_CARRY=carry.dim() == 3,
                                     UNROLL=unroll, BLOCK_F=block, num_warps=warps, enable_fp_fusion=False)


def accum_cot_triton(grads: torch.Tensor) -> torch.Tensor:
    """grads (B, K, F) CUDA -> (B, F) f32 = Σ_k grads[:, k]."""
    B, K, F = grads.shape
    grads = common.check_flat("grads", grads, (B, K, F), common.FLOATS)
    out = torch.empty((B, F), dtype=torch.float32, device=grads.device)
    triton, _, kern = _compiled()
    block, warps = common.sweep_tile(B, F, grads.dtype, common.sm_count(grads.device))
    kern[(B, triton.cdiv(F, block))](grads, out, K, F, UNROLL=COT_UNROLL, BLOCK_F=block, num_warps=warps)
    common.LAUNCHES["accum_cot"] += 1
    return out
