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
F=3072 f32 about 13 MB, about 4 µs at 3.35 TB/s. ``accum_cot`` reads the
(B, K, F) cotangent once and writes (B, F) f32: the same 13 MB.

Design: one program per (row, F-tile). The forward loads its x, b (and a
broadcast carry) tile once and loops over K, storing BLOCK_K interpolants
per step. The interpolation rounds after each operation in x.dtype, then
adds the carry in f32 — the ``repro.core.paths.interp_add`` dtype contract,
so at carry 0 the nodes equal the unfused path's even in bf16 — and FMA
contraction is off so f32 rounds the same way. The backward sweeps K one
row at a time (COT_UNROLL rows a loop step, their loads in flight together)
into a per-thread f32 vector over its F tile: each thread sums only its own
columns, so nothing is reduced across threads, and each row's load is
coalesced, 16 bytes a load. Its F tile is the widest that still gives
every SM two programs (``common.sweep_tile``): at the ViT's (16, ·,
150,528) 2048 f32 columns on 4 warps, at the CNN's (16, ·, 3072) 128 on
one. No atomics and a fixed sum order (k = 0, 1, …), so the same input
gives the same bits.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import common

BLOCK_K = 16
BLOCK_F = 128
NUM_WARPS = 4
COT_UNROLL = 8  # accum_cot: K rows whose loads are in flight together

tl = None  # triton.language, bound on the first launch


def _interp_add_kernel(x_ptr, b_ptr, a_ptr, u_ptr, o_ptr, K, F,
                       STEP_CARRY: "tl.constexpr", BLOCK_K: "tl.constexpr",
                       BLOCK_F: "tl.constexpr"):
    row = tl.program_id(0).to(tl.int64)
    offs_f = tl.program_id(1) * BLOCK_F + tl.arange(0, BLOCK_F)
    fmask = offs_f < F
    x = tl.load(x_ptr + row * F + offs_f, mask=fmask, other=0.0)
    b = tl.load(b_ptr + row * F + offs_f, mask=fmask, other=0.0)
    dt = x.dtype
    d = (x.to(tl.float32) - b.to(tl.float32)).to(dt)
    if not STEP_CARRY:
        u = tl.load(u_ptr + row * F + offs_f, mask=fmask, other=0.0)
    for k0 in range(0, K, BLOCK_K):
        offs_k = k0 + tl.arange(0, BLOCK_K)
        kmask = offs_k < K
        mask2 = kmask[:, None] & fmask[None, :]
        a = tl.load(a_ptr + row * K + offs_k, mask=kmask, other=0.0).to(dt)
        step = (a.to(tl.float32)[:, None] * d.to(tl.float32)[None, :]).to(dt)
        xi = (b.to(tl.float32)[None, :] + step.to(tl.float32)).to(dt)
        offs = (row * K + offs_k[:, None]) * F + offs_f[None, :]
        if STEP_CARRY:
            o = xi.to(tl.float32) + tl.load(u_ptr + offs, mask=mask2, other=0.0)
        else:
            o = xi.to(tl.float32) + u[None, :]
        tl.store(o_ptr + offs, o.to(o_ptr.dtype.element_ty), mask=mask2)


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
    triton, kern, _ = _compiled()
    grid = (B, triton.cdiv(F, BLOCK_F))
    kern[grid](x, baseline, alphas, carry, out, K, F, STEP_CARRY=step_carry,
               BLOCK_K=BLOCK_K, BLOCK_F=BLOCK_F, num_warps=NUM_WARPS, enable_fp_fusion=False)
    common.LAUNCHES["interp_add"] += 1
    return out


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
