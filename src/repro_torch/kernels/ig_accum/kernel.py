"""Triton kernels of the unfused stage 2's accumulation: riemann and IDGI.

Replace ``repro/kernels/ig_accum/kernel.py``:

  * ``ig_accum_triton`` ← ``ig_accum_pallas`` (``_accum_kernel``):
    acc + Σ_k w_k g_k, the riemann class (ig and the path ensembles);
  * ``idgi_dots_triton`` ← ``idgi_dots_pallas`` (``_dots_kernel``):
    ⟨g_k, g_k⟩ and ⟨g_k, diff⟩ per (row, step), each reduced over all of F;
  * ``ig_accum_sq_triton`` ← ``ig_accum_sq_pallas`` (``_accum_sq_kernel``):
    acc + Σ_k c_k g_k², IDGI's weighting pass (g² is never stored); the
    same Triton body as ``ig_accum_triton``, compiled with ``SQUARE``.

IDGI's coefficient c = w·⟨g,diff⟩/⟨g,g⟩ is formed between its two kernels
(``ops.ig_accum_idgi``), since the dot products reduce over the whole row,
which no F-tile of the second pass sees.

Bound on the H100: bytes, all three. Each reads the (B, K, F) gradients
once, plus a (B, F) row (acc or diff) and writes (B, F) f32 or 2×(B, K)
f32, at 2–4 flops per gradient element: at B=16, K=64, F=3072 f32 about
13 MB, about 4 µs at 3.35 TB/s; at the ViT's B=16, K=16, F=150,528 about
165–175 MB, about 50 µs.

Design: on the TPU, the reduced axis (K for the accumulations, F for the
dots) was a sequential grid axis with the output tile carried in VMEM.
Here blocks run in no order, so a block owns its outputs and loops over
the reduced axis inside itself, in f32 registers:

  * the accumulations, one body for both (``SQUARE`` picks g or g², squared
    in f32 after the cast): one program per (row, F tile) that sweeps K one
    row at a time (ACCUM_UNROLL rows a loop step, their loads in flight
    together) into a per-thread f32 vector started from acc. Each thread
    sums only its own columns, so nothing is reduced across threads, each
    row's load is coalesced, 16 bytes a load, and every thread loads the
    step's coefficient from the same address. The F tile is the
    one ``accum_cot`` uses (``common.sweep_tile``): 2048 f32 columns on 4
    warps at the ViT's (16, ·, 150,528), 128 on one at the CNN's
    (16, ·, 3072); bf16 takes twice the columns, so a load still carries
    16 bytes. Splitting K across a program's warps (slots summed once after
    the loop) ran no faster at either shape, so it is not kept;
  * the dots, on the plan of ``common.dots_plan``: one program per (row,
    block of KB steps, F chunk) that sweeps its chunk in BLOCK_F-wide
    tiles, loading the tile of diff once and then the KB rows of g, 16
    bytes a load, into per-thread f32 sums of its own columns; one
    ``tl.sum`` a row after the loop. So diff is read K/KB times, not K
    times, and KB rows' loads are in flight together. F is split into
    chunks only to fill the SMs (the ViT's 16 × 16/KB programs are too
    few; the CNN's 16 × 64/KB are not, and take one launch); the chunks'
    (2, split, B, K) partials are then summed by a second, small pass in
    the order chunk 0, 1, …, so a call runs one or two kernels.

No atomics: every sum is taken in a fixed order (the accumulations k = 0,
1, … after acc; the dots' chunks 0, 1, …), so the results are the same
bits on every run, which bit-identical adaptive resume relies on (for IDGI
the coefficients, and so every attribution, depend on the dots' bits).
Ragged K and F are masked loads, not padding copies; a zero coefficient
adds exactly 0, and a zero row of g gives dots of exactly 0.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import common

ACCUM_UNROLL = 8  # K rows whose loads are in flight together
DOTS_SUM_BLOCK = 256  # the split's second pass: partial sums a program

tl = None  # triton.language, bound on the first launch


def _accum_kernel(acc_ptr, g_ptr, c_ptr, o_ptr, K, F, SQUARE: "tl.constexpr",
                  UNROLL: "tl.constexpr", BLOCK_F: "tl.constexpr"):
    row = tl.program_id(0).to(tl.int64)
    offs_f = tl.program_id(1) * BLOCK_F + tl.arange(0, BLOCK_F)
    fmask = offs_f < F
    g_ptrs = g_ptr + row * K * F + offs_f
    # the step's coefficient through a one-element vector: on the H100 a scalar
    # pointer took more registers and ran slower at the ViT's shape
    c_ptrs = c_ptr + row * K + tl.arange(0, 1)
    acc = tl.load(acc_ptr + row * F + offs_f, mask=fmask, other=0.0)  # the sum starts from acc
    for k0 in range(0, K, UNROLL):
        for u in tl.static_range(UNROLL):  # one row at a time, each thread its own columns
            live = k0 + u < K
            c = tl.sum(tl.load(c_ptrs, mask=live, other=0.0).to(tl.float32), axis=0)
            g = tl.load(g_ptrs, mask=fmask & live, other=0.0).to(tl.float32)
            if SQUARE:
                g = g * g
            acc += c * g
            g_ptrs += F
            c_ptrs += 1
    tl.store(o_ptr + row * F + offs_f, acc, mask=fmask)


def _dots_kernel(g_ptr, d_ptr, part_ptr, K, F, CHUNK, KB: "tl.constexpr", BLOCK_F: "tl.constexpr"):
    b = tl.program_id(0).to(tl.int64)
    offs_k = tl.program_id(1) * KB + tl.arange(0, KB)
    chunk, split = tl.program_id(2), tl.num_programs(2)
    kmask = offs_k < K
    rows = (b * K + offs_k) * F  # the KB rows of g this program sweeps
    cols = tl.arange(0, BLOCK_F)
    f0 = chunk * CHUNK
    s = tl.zeros([KB, BLOCK_F], dtype=tl.float32)  # each thread sums its own columns
    p = tl.zeros([KB, BLOCK_F], dtype=tl.float32)
    for f in range(f0, tl.minimum(f0 + CHUNK, F), BLOCK_F):
        fmask = f + cols < F
        d = tl.load(d_ptr + b * F + f + cols, mask=fmask, other=0.0).to(tl.float32)  # once for KB rows
        g = tl.load(g_ptr + rows[:, None] + (f + cols)[None, :], mask=kmask[:, None] & fmask[None, :],
                    other=0.0).to(tl.float32)
        s += g * g
        p += g * d[None, :]
    # partials (2, split, B, K): ⟨g,g⟩ then ⟨g,diff⟩; with one chunk, the outputs themselves
    out = part_ptr + chunk * K * tl.num_programs(0) + b * K + offs_k
    tl.store(out, tl.sum(s, axis=1), mask=kmask)
    tl.store(out + split * K * tl.num_programs(0), tl.sum(p, axis=1), mask=kmask)


def _dots_sum_kernel(part_ptr, o_ptr, N, SPLIT: "tl.constexpr", BLOCK: "tl.constexpr"):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < N
    src = part_ptr + tl.program_id(1) * SPLIT * N + offs  # output 0 or 1, its SPLIT × N partials
    acc = tl.load(src, mask=mask, other=0.0)
    for c in tl.static_range(1, SPLIT):  # chunk 0, 1, …, in that order; the loads issued together
        acc += tl.load(src + c * N, mask=mask, other=0.0)
    tl.store(o_ptr + tl.program_id(1) * N + offs, acc, mask=mask)


@functools.cache
def _compiled():
    global tl
    triton, tl = common.import_triton()
    return triton, triton.jit(_accum_kernel), triton.jit(_dots_kernel), triton.jit(_dots_sum_kernel)


def _accum(name: str, acc: torch.Tensor, grads: torch.Tensor, c: torch.Tensor,
           square: bool) -> torch.Tensor:
    """Launch the K-sweep: acc + Σ_k c_k g_k (``square``: c_k g_k²)."""
    B, K, F = grads.shape
    grads = common.check_flat("grads", grads, (B, K, F), common.FLOATS)
    acc = common.check_flat("acc", acc, (B, F), (torch.float32,))
    if square:
        c = common.check_flat("coeff", c, (B, K), (torch.float32,))
    else:
        c = common.check_flat("weights", c, (B, K), common.FLOATS)
    out = torch.empty((B, F), dtype=torch.float32, device=acc.device)
    triton, kern, _, _ = _compiled()
    block, warps = common.sweep_tile(B, F, grads.dtype, common.sm_count(grads.device))
    kern[(B, triton.cdiv(F, block))](acc, grads, c, out, K, F, SQUARE=square, UNROLL=ACCUM_UNROLL,
                                     BLOCK_F=block, num_warps=warps)
    common.LAUNCHES[name] += 1
    return out


def ig_accum_triton(acc: torch.Tensor, grads: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """acc (B, F) f32; grads (B, K, F); weights (B, K), CUDA -> (B, F) f32."""
    return _accum("ig_accum", acc, grads, weights, square=False)


def idgi_dots_triton(grads: torch.Tensor, diff: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """grads (B, K, F); diff (B, F), CUDA -> (⟨g,g⟩, ⟨g,diff⟩), both (B, K) f32.

    One or two kernels run (the second sums the F chunks' partials where
    ``common.dots_plan`` splits F); the call counts as one launch."""
    B, K, F = grads.shape
    grads = common.check_flat("grads", grads, (B, K, F), common.FLOATS)
    diff = common.check_flat("diff", diff, (B, F), common.FLOATS)
    out = launch_dots(grads, diff, common.dots_plan(B, K, F, grads.dtype, common.sm_count(grads.device)))
    common.LAUNCHES["idgi_dots"] += 1
    return out[0], out[1]


def launch_dots(grads: torch.Tensor, diff: torch.Tensor, plan: common.DotsPlan) -> torch.Tensor:
    """Run the dots on checked operands with ``plan``; (2, B, K) f32: ⟨g,g⟩
    then ⟨g,diff⟩. Counts nothing (``idgi_dots_triton`` does)."""
    B, K, F = grads.shape
    out = torch.empty((2, B, K), dtype=torch.float32, device=grads.device)
    part = out if plan.split == 1 else torch.empty((2, plan.split, B, K), dtype=torch.float32,
                                                   device=grads.device)
    triton, _, kern, sum_kern = _compiled()
    kern[(B, triton.cdiv(K, plan.kb), plan.split)](grads, diff, part, K, F, plan.chunk, KB=plan.kb,
                                                   BLOCK_F=plan.block_f, num_warps=plan.num_warps)
    if plan.split > 1:
        sum_kern[(triton.cdiv(B * K, DOTS_SUM_BLOCK), 2)](part, out, B * K, SPLIT=plan.split,
                                                          BLOCK=DOTS_SUM_BLOCK, num_warps=4)
    return out


def ig_accum_sq_triton(acc: torch.Tensor, grads: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """acc (B, F) f32; grads (B, K, F); coeff (B, K) f32, CUDA -> (B, F) f32
    = acc + Σ_k coeff_k · g_k²."""
    return _accum("ig_accum_sq", acc, grads, coeff, square=True)
