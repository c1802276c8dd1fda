"""Triton kernel: the batch of straight-line interpolants, b + α(x − b).

Replaces ``repro/kernels/interpolate/kernel.py`` ``interpolate_pallas``
(``_interp_kernel``), the unfused stage 2's interpolation.

Bound on the H100: bytes. Per call it reads x and b once (B·F each), the
alphas (B·K) and writes the (B, K, F) output, at under one flop per byte;
at B=16, K=64, F=3072 f32 that is about 13 MB, about 4 µs at 3.35 TB/s,
at the ViT's B=16, K=16, F=150,528 about 173 MB, about 52 µs. The output
write is almost all of it.

Design: a K-sweep of stores, the mirror of the K-sums' loads. One program
per (row, F tile) loads its x and b tile once, forms d = x − b, then sweeps
K one row at a time (INTERP_UNROLL rows a loop step, their stores issued
together), each thread writing only its own columns, 16 bytes a store. The
tile is the K-sums' (``common.sweep_tile``): 2048 f32 columns on 4 warps at
the ViT's shape, 128 on one at the CNN's; bf16 takes twice the columns. So
x and b are read once per call (the Pallas grid re-read them per K-tile),
and a program does K rows of work, not one small tile. Ragged F and K are
masked stores, with no padding copies. The arithmetic is f32 with
contraction into FMA turned off, so it rounds like the plain version.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import common

INTERP_UNROLL = 8  # K rows stored a loop step

tl = None  # triton.language, bound on the first launch


def _interp_kernel(x_ptr, b_ptr, a_ptr, o_ptr, K, F, UNROLL: "tl.constexpr", BLOCK_F: "tl.constexpr"):
    row = tl.program_id(0).to(tl.int64)
    offs_f = tl.program_id(1) * BLOCK_F + tl.arange(0, BLOCK_F)
    fmask = offs_f < F
    x = tl.load(x_ptr + row * F + offs_f, mask=fmask, other=0.0).to(tl.float32)
    b = tl.load(b_ptr + row * F + offs_f, mask=fmask, other=0.0).to(tl.float32)
    d = x - b
    o_ptrs = o_ptr + row * K * F + offs_f
    a_ptrs = a_ptr + row * K + tl.arange(0, 1)  # the step's alpha, as ig_accum loads its weight
    for k0 in range(0, K, UNROLL):
        for u in tl.static_range(UNROLL):  # one row at a time, each thread its own columns
            live = k0 + u < K
            a = tl.sum(tl.load(a_ptrs, mask=live, other=0.0), axis=0)
            tl.store(o_ptrs, (b + a * d).to(o_ptr.dtype.element_ty), mask=fmask & live)
            o_ptrs += F
            a_ptrs += 1


@functools.cache
def _compiled():
    global tl
    triton, tl = common.import_triton()
    return triton, triton.jit(_interp_kernel)


def interpolate_triton(x: torch.Tensor, baseline: torch.Tensor, alphas: torch.Tensor) -> torch.Tensor:
    """x, baseline: (B, F) CUDA; alphas: (B, K) f32 -> (B, K, F) in x.dtype."""
    B, F = x.shape
    K = alphas.shape[1]
    x = common.check_flat("x", x, (B, F), common.FLOATS)
    baseline = common.check_flat("baseline", baseline, (B, F), (x.dtype,))
    alphas = common.check_flat("alphas", alphas, (B, K), (torch.float32,))
    out = torch.empty((B, K, F), dtype=x.dtype, device=x.device)
    launch_interp(x, baseline, alphas, out, *common.sweep_tile(B, F, x.dtype, common.sm_count(x.device)),
                  INTERP_UNROLL)
    common.LAUNCHES["interpolate"] += 1
    return out


def launch_interp(x: torch.Tensor, baseline: torch.Tensor, alphas: torch.Tensor, out: torch.Tensor,
                  block: int, warps: int, unroll: int) -> None:
    """Write the interpolants of checked operands into ``out`` on a tile of
    ``block`` columns, ``warps`` warps and ``unroll`` rows a loop step.
    Counts nothing (``interpolate_triton`` does)."""
    (B, F), K = x.shape, alphas.shape[1]
    triton, kern = _compiled()
    kern[(B, triton.cdiv(F, block))](x, baseline, alphas, out, K, F, UNROLL=unroll, BLOCK_F=block,
                                     num_warps=warps, enable_fp_fusion=False)
