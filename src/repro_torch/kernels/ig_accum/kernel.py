"""Triton kernel: the stage-2 Riemann accumulation, acc + Σ_k w_k g_k.

Replaces ``repro/kernels/ig_accum/kernel.py`` ``ig_accum_pallas``
(``_accum_kernel``), the unfused stage 2's accumulation. IDGI's two
kernels in the same file (``idgi_dots_pallas``, ``ig_accum_sq_pallas``)
are not ported yet.

Bound on the H100: bytes. Per call it reads the (B, K, F) gradients once,
plus acc (B·F f32) and the weights, and writes one (B, F) f32 tile, at two
flops per gradient element; at B=16, K=64, F=3072 f32 about 13 MB, about
4 µs at 3.35 TB/s. Design: on the TPU, K was a sequential grid axis with
the output tile carried in VMEM. Here blocks run in no order, so one
program owns a (row, F-tile) pair and loops over K inside the block,
accumulating in f32 registers and storing once. No atomics: the sum order
is fixed, so results are deterministic run to run, which bit-identical
adaptive resume relies on.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import common

BLOCK_K = 16
BLOCK_F = 128
NUM_WARPS = 4

tl = None  # triton.language, bound on the first launch


def _accum_kernel(acc_ptr, g_ptr, w_ptr, o_ptr, K, F,
                  BLOCK_K: "tl.constexpr", BLOCK_F: "tl.constexpr"):
    row = tl.program_id(0).to(tl.int64)
    offs_f = tl.program_id(1) * BLOCK_F + tl.arange(0, BLOCK_F)
    fmask = offs_f < F
    acc = tl.load(acc_ptr + row * F + offs_f, mask=fmask, other=0.0)
    for k0 in range(0, K, BLOCK_K):
        offs_k = k0 + tl.arange(0, BLOCK_K)
        kmask = offs_k < K
        g = tl.load(g_ptr + (row * K + offs_k[:, None]) * F + offs_f[None, :],
                    mask=kmask[:, None] & fmask[None, :], other=0.0).to(tl.float32)
        w = tl.load(w_ptr + row * K + offs_k, mask=kmask, other=0.0).to(tl.float32)
        acc += tl.sum(g * w[:, None], axis=0)
    tl.store(o_ptr + row * F + offs_f, acc, mask=fmask)


@functools.cache
def _compiled():
    global tl
    triton, tl = common.import_triton()
    return triton, triton.jit(_accum_kernel)


def ig_accum_triton(acc: torch.Tensor, grads: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """acc (B, F) f32; grads (B, K, F); weights (B, K), CUDA -> (B, F) f32."""
    B, K, F = grads.shape
    grads = common.check_flat("grads", grads, (B, K, F), common.FLOATS)
    acc = common.check_flat("acc", acc, (B, F), (torch.float32,))
    weights = common.check_flat("weights", weights, (B, K), common.FLOATS)
    out = torch.empty((B, F), dtype=torch.float32, device=acc.device)
    triton, kern = _compiled()
    grid = (B, triton.cdiv(F, BLOCK_F))
    kern[grid](acc, grads, weights, out, K, F, BLOCK_K=BLOCK_K, BLOCK_F=BLOCK_F,
               num_warps=NUM_WARPS)
    common.LAUNCHES["ig_accum"] += 1
    return out
