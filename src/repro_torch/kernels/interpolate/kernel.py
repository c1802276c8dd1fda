"""Triton kernel: the batch of straight-line interpolants, b + α(x − b).

Replaces ``repro/kernels/interpolate/kernel.py`` ``interpolate_pallas``
(``_interp_kernel``), the unfused stage 2's interpolation.

Bound on the H100: bytes. Per call it reads x and b once (B·F each), the
alphas (B·K) and writes the (B, K, F) output, at under one flop per byte;
at B=16, K=64, F=3072 f32 that is about 13 MB, about 4 µs at 3.35 TB/s.
The output write is almost all of it. Design: one program per (row,
F-tile) loads its x and b tile once and loops over K inside the block,
storing BLOCK_K interpolants per step, so x and b are read once per call
(the Pallas grid re-read them per K-tile). Ragged F and K edges are
masked loads and stores, with no padding copies. The arithmetic is f32
with contraction into FMA turned off, so it rounds like the plain version.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import common

BLOCK_K = 16
BLOCK_F = 128
NUM_WARPS = 4

tl = None  # triton.language, bound on the first launch


def _interp_kernel(x_ptr, b_ptr, a_ptr, o_ptr, K, F,
                   BLOCK_K: "tl.constexpr", BLOCK_F: "tl.constexpr"):
    row = tl.program_id(0).to(tl.int64)
    offs_f = tl.program_id(1) * BLOCK_F + tl.arange(0, BLOCK_F)
    fmask = offs_f < F
    x = tl.load(x_ptr + row * F + offs_f, mask=fmask, other=0.0).to(tl.float32)
    b = tl.load(b_ptr + row * F + offs_f, mask=fmask, other=0.0).to(tl.float32)
    d = x - b
    for k0 in range(0, K, BLOCK_K):
        offs_k = k0 + tl.arange(0, BLOCK_K)
        kmask = offs_k < K
        a = tl.load(a_ptr + row * K + offs_k, mask=kmask, other=0.0)
        o = b[None, :] + a[:, None] * d[None, :]
        optr = o_ptr + (row * K + offs_k[:, None]) * F + offs_f[None, :]
        tl.store(optr, o.to(o_ptr.dtype.element_ty), mask=kmask[:, None] & fmask[None, :])


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
    triton, kern = _compiled()
    grid = (B, triton.cdiv(F, BLOCK_F))
    kern[grid](x, baseline, alphas, out, K, F, BLOCK_K=BLOCK_K, BLOCK_F=BLOCK_F,
               num_warps=NUM_WARPS, enable_fp_fusion=False)
    common.LAUNCHES["interpolate"] += 1
    return out
