"""The port's kernels against their plain versions, on a CUDA card.

The kernel tests need a card (and ``triton`` for the Triton kernels, ``nvcc``
for the CUDA ones) and skip elsewhere. Imports no JAX (the card's machine
has none), so run it there without the repository's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: elementwise f32 kernels 1e-6 (FMA contraction is off, so they
round like the plain version); bf16 one ulp at the values' magnitude
(2**-7 for values below 2); K-sums 1e-5 relative (another summation order);
IDGI's dot products over F 1e-5 relative to the sum of |terms| (another
summation order over up to 150,528 terms), its accumulation 1e-5 relative
to the largest |value|; the reduced LM on the card against the CPU (f32,
TF32 off): log-probs, f(x) and decode logits 1e-5, engine token scores
1e-4 of a request's largest |score| (f32 products summed in another
order), generated tokens exactly; the MoE layer on the card against the CPU (f32,
TF32 off) 1e-5 of the largest |value|, the SSD mixer 1e-4 (sums over a
256-token chunk), the MoE's routing and its repeats exactly;
flash attention 1e-4 in f32 and 3e-2 in bf16, absolute and relative (the
JAX package's own flash tolerances: sums over D and over keys in another
order, and one bf16 rounding of each output); the Gauss–Jordan solve 1e-6
of max|β| and, at the sizes where its plan changes kernel, bit-equal (each
kernel rounds each operation as its plain version does).

The lazy-build test runs everywhere: the package imports and the CPU op runs
with no ``nvcc`` in reach.
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import common
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.ig_accum.kernel import idgi_dots_triton, ig_accum_sq_triton, ig_accum_triton
from repro_torch.kernels.ig_accum.ops import ig_accum, ig_accum_idgi
from repro_torch.kernels.ig_accum.ref import (
    idgi_dots_ref,
    ig_accum_idgi_ref,
    ig_accum_ref,
    ig_accum_sq_ref,
)
from repro_torch.kernels.interp_accum.kernel import accum_cot_triton, interp_add_triton
from repro_torch.kernels.interp_accum.ops import interp_accum
from repro_torch.kernels.interp_accum.ref import accum_cot_ref, interp_add_ref
from repro_torch.kernels.interpolate.kernel import interpolate_triton
from repro_torch.kernels.interpolate.ops import interpolate
from repro_torch.kernels.interpolate.ref import interpolate_ref
from repro_torch.kernels.lstsq import ops as lstsq_ops
from repro_torch.kernels.lstsq import ref as lstsq_ref
from repro_torch.kernels.lstsq.kernel import wls_solve_cuda

TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0**-7}
# (B, K, F): odd shapes, ragged ones (K and F multiples of no tile, at
# the K-sweeps' narrowest and widest F tile), the K-sweeps' tile edges (K=1;
# K not a multiple of their UNROLL; F one past a 128-, 2048- and, in bf16,
# a 256- or 4096-column tile), the CNN path's stage-2 shape and the ViT
# path's
RAGGED_SWEEPS = [(16, 1, 3072), (16, 37, 3073), (16, 63, 2049), (16, 9, 2048 * 37 + 1),
                 (16, 7, 4096 * 19 + 1)]
SHAPES = [(1, 1, 3), (3, 5, 77), (2, 9, 130), (4, 37, 3000), (5, 19, 4099), (3, 13, 100_003),
          *RAGGED_SWEEPS, (16, 64, 3072), (16, 16, 224 * 224 * 3),
          (16, 16, 128 * 4096)]  # the LM engine's at S=128, d=4096


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if importlib.util.find_spec("triton") is None:
        pytest.skip("needs the triton package")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,F", SHAPES)
def test_triton_kernels_match_plain(card, dtype, B, K, F):
    rnd = lambda *s: torch.rand(s, generator=card, device="cuda") * 2 - 1
    x, b = rnd(B, F).to(dtype), rnd(B, F).to(dtype)
    a, w = rnd(B, K).abs(), rnd(B, K).abs() / K
    u, us, acc = rnd(B, F) * 0.1, rnd(B, K, F) * 0.1, rnd(B, F)
    g = rnd(B, K, F).to(dtype)
    common.reset_launches()
    pairs = [
        (interpolate_triton(x, b, a), interpolate_ref(x, b, a), TOL[dtype], 0.0),
        (interp_add_triton(x, b, a, u), interp_add_ref(x, b, a, u), TOL[dtype], 0.0),
        (interp_add_triton(x, b, a, us), interp_add_ref(x, b, a, us), TOL[dtype], 0.0),
        (ig_accum_triton(acc, g, w), ig_accum_ref(acc, g, w), 1e-5, 1e-5),
        (accum_cot_triton(g), accum_cot_ref(g), 1e-5, 1e-5),
    ]
    # the op wrappers dispatch CUDA tensors to the kernels
    u_op = u.reshape(B, 1, F).clone().requires_grad_()
    out_op = interp_accum(x.reshape(B, 1, F), b.reshape(B, 1, F), a, u_op)
    (gu,) = torch.autograd.grad(out_op.float().sum(), u_op)
    pairs += [
        (interpolate(x, b, a[0]), interpolate_ref(x, b, a[:1].expand(B, -1)), TOL[dtype], 0.0),
        (ig_accum(acc, g, w), ig_accum_ref(acc, g, w), 1e-5, 1e-5),
        (out_op.reshape(B, K, F), interp_add_ref(x, b, a, u), TOL[dtype], 0.0),
        (gu.reshape(B, F), torch.full((B, F), float(K), device="cuda"), 0.0, 0.0),
    ]
    torch.cuda.synchronize()
    for got, want, atol, rtol in pairs:
        assert got.dtype == want.dtype and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=rtol)
    # each wrapper counts exactly its own launches, and no other kernel ran
    assert common.LAUNCHES == {**{name: 0 for name in common.LAUNCHES},
                               "interpolate": 2, "ig_accum": 2, "interp_add": 3, "accum_cot": 2}
    assert common.CARRY_RANKS == {2: 2, 3: 1}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["accum_cot", "ig_accum", "ig_accum_sq", "idgi_dots", "interpolate",
                                    "interp_add", "interp_add_step"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,F", [(5, 19, 4099), (16, 64, 3072), (16, 16, 224 * 224 * 3)])
def test_k_sweeps_same_bits_on_every_call(card, kernel, dtype, B, K, F):
    """No atomics and a fixed sum order: two calls on the same input give
    the same bits (the resume gates compare with ``torch.equal``); for
    ``idgi_dots`` both outputs, through the split's second pass where
    ``common.dots_plan`` splits F; ``interp_add`` with each carry rank."""
    g = torch.randn((B, K, F), generator=card, device="cuda").to(dtype)
    acc = torch.randn((B, F), generator=card, device="cuda")
    c = torch.rand((B, K), generator=card, device="cuda")
    x, b = acc.to(dtype), torch.rand((B, F), generator=card, device="cuda").to(dtype)
    call = {"accum_cot": lambda: (accum_cot_triton(g),),
            "ig_accum": lambda: (ig_accum_triton(acc, g, c),),
            "ig_accum_sq": lambda: (ig_accum_sq_triton(acc, g, c),),
            "idgi_dots": lambda: idgi_dots_triton(g, x),
            "interpolate": lambda: (interpolate_triton(x, b, c),),
            "interp_add": lambda: (interp_add_triton(x, b, c, acc),),
            "interp_add_step": lambda: (interp_add_triton(x, b, c, g.float()),)}[kernel]
    first, second = call(), call()
    assert len(first) == len(second) and all(torch.equal(a, z) for a, z in zip(first, second))


# (B, K, F): odd shapes, the K-sweeps' tile edges, the dots plan's edges on
# 132 SMs (K not a multiple of its 4 steps a program; F one past a
# 1024-column tile with one chunk, and one past four chunks of 5120 with
# five), the CNN path's stage-2 shape (one chunk), the ViT path's (F
# split in 5) and the LM engine's at S=128, d=4096
IDGI_SHAPES = [(1, 1, 3), (3, 5, 77), (5, 37, 3 * 31 * 29), *RAGGED_SWEEPS, (4, 7, 2049),
               (2, 13, 4 * 5120 + 1), (16, 64, 3072), (16, 16, 224 * 224 * 3), (16, 16, 128 * 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,K,F", IDGI_SHAPES)
def test_idgi_kernels_match_plain(card, dtype, B, K, F):
    rnd = lambda *s: torch.randn(s, generator=card, device="cuda")
    g, diff = rnd(B, K, F).to(dtype), rnd(B, F).to(dtype)
    g[0, 0] = 0  # a zero-gradient step: ⟨g,g⟩ = 0 contributes exactly 0
    acc, w = rnd(B, F), torch.rand((B, K), generator=card, device="cuda") / K
    common.reset_launches()
    s, p = idgi_dots_triton(g, diff)
    s_ref, p_ref = idgi_dots_ref(g, diff)
    gf = g.float()
    for got, want, terms in ((s, s_ref, gf * gf), (p, p_ref, gf * diff.float()[:, None])):
        assert got.dtype == torch.float32 and got.shape == (B, K)
        lim = 1e-5 * terms.abs().sum(-1) + 1e-30
        assert bool(((got - want).abs() <= lim).all())
    assert float(s[0, 0]) == 0.0 and float(p[0, 0]) == 0.0
    coeff = torch.rand((B, K), generator=card, device="cuda")
    out, want = ig_accum_sq_triton(acc, g, coeff), ig_accum_sq_ref(acc, g, coeff)
    torch.testing.assert_close(out, want, atol=1e-5 * float(want.abs().max()), rtol=0)
    # the op through both kernels, and a row whose every gradient is 0
    g[-1] = 0
    mask = torch.rand((B, F), generator=card, device="cuda") > 0.3
    got = ig_accum_idgi(acc, g, w, diff=diff, mask=mask)
    want = ig_accum_idgi_ref(acc, g * mask[:, None].to(dtype), w, diff)
    torch.testing.assert_close(got, want, atol=1e-5 * float(want.abs().max()), rtol=0)
    assert bool(torch.isfinite(got).all()) and torch.equal(got[-1], acc[-1])
    torch.cuda.synchronize()
    assert common.LAUNCHES == {**{name: 0 for name in common.LAUNCHES},
                               "idgi_dots": 2, "ig_accum_sq": 2}
    # no atomics: the same inputs give the same bits
    assert torch.equal(ig_accum_idgi(acc, g, w, diff=diff, mask=mask), got)


FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
EDGE_KVLEN = (1, 8, 9, 16, 17, 64, 65, 196)  # on and beside the backward's 8- and 16-row edges
# (B, S, NQ, NKV, D, causal, ragged): the ViT's attention at a smaller batch,
# the LMs' causal GQA ragged shape (and at the end the GQA groups of llama3-8b,
# internlm2-20b and yi-9b at D = 128), a long causal GQA key sweep (1024 keys,
# the engine's largest bucket) at D = 128 and the reduced LM's D = 16, one
# row full and one ragged, and the JAX tests' odd head dims and
# sequence lengths, one per head-dim bucket of the kernels; then the
# backward's fragment edges: S=196 with kvlen on and beside them (ragged
# given as the lengths), S at 1 and around one 16-row strip, a head dim
# that is not a multiple of 8 and one that is not a power of two
FLASH_SHAPES = [
    (8, 196, 6, 6, 64, False, False),
    (2, 333, 8, 2, 128, True, True),
    (2, 1024, 8, 2, 128, True, (1024, 611)),
    (2, 1024, 8, 2, 16, True, (1024, 611)),
    (1, 17, 4, 2, 8, True, True),
    (2, 33, 6, 6, 4, False, True),
    (2, 70, 4, 1, 256, True, False),
    (8, 196, 6, 6, 64, False, EDGE_KVLEN),
    (8, 196, 4, 2, 64, True, EDGE_KVLEN),
    (2, 1, 4, 2, 64, True, False),
    (2, 15, 6, 6, 64, False, True),
    (2, 16, 4, 2, 64, True, True),
    (3, 17, 2, 1, 64, False, False),
    (2, 50, 4, 2, 20, True, True),
    (2, 70, 6, 3, 72, False, True),
    (16, 128, 32, 8, 128, True, True),  # the LM engine's attention (llama3-8b heads)
    (2, 256, 48, 8, 128, True, True),  # internlm2-20b's GQA group (6 query heads a KV head)
    (2, 256, 32, 4, 128, True, True),  # yi-9b's (8 a KV head)
    (2, 2048, 32, 16, 128, True, True),  # gemma3-27b's (2 a KV head) at its 2048-token bucket
]


@pytest.fixture
def nvcc_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    try:
        common.find_nvcc()
    except RuntimeError:
        pytest.skip("needs nvcc")
    return torch.Generator(device="cuda").manual_seed(0)


def _flash_inputs(gen, B, S, NQ, NKV, D, ragged, dtype):
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dtype)
    q, k, v, do = rnd(B, S, NQ, D), rnd(B, S, NKV, D), rnd(B, S, NKV, D), rnd(B, S, NQ, D)
    if isinstance(ragged, tuple):
        kvlen = torch.tensor(ragged, dtype=torch.int32)
    elif ragged:  # a different prefix per row; at short S one row has no key at all
        kvlen = torch.tensor([(S * (b + 1)) // (B + 1) for b in range(B)], dtype=torch.int32)
        if S < 100 and B > 1:
            kvlen[0] = 0
    else:
        kvlen = torch.full((B,), S, dtype=torch.int32)
    return q, k, v, do, kvlen.cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,NQ,NKV,D,causal,ragged", FLASH_SHAPES)
def test_flash_kernels_match_plain(nvcc_card, dtype, B, S, NQ, NKV, D, causal, ragged):
    q, k, v, do, kvlen = _flash_inputs(nvcc_card, B, S, NQ, NKV, D, ragged, dtype)
    t = lambda x: x.transpose(1, 2)  # model layout -> the kernels' layout, a view
    qt, kt, vt, dot = t(q), t(k), t(v), t(do)
    tol = FLASH_TOL[dtype]
    common.reset_launches()
    o, lse = fk.flash_fwd_cuda(qt, kt, vt, kvlen, causal=causal)
    o_ref, lse_ref = fref.flash_fwd_ref(qt, kt, vt, kvlen, causal=causal)
    delta = (dot.float() * o_ref.float()).sum(-1)
    dq = fk.flash_bwd_dq_cuda(qt, kt, vt, dot, lse_ref, delta, kvlen, causal=causal)
    dk, dv = fk.flash_bwd_dkv_cuda(qt, kt, vt, dot, lse_ref, delta, kvlen, causal=causal)
    dq_ref = fref.flash_bwd_dq_ref(qt, kt, vt, dot, lse_ref, delta, kvlen, causal=causal)
    dk_ref, dv_ref = fref.flash_bwd_dkv_ref(qt, kt, vt, dot, lse_ref, delta, kvlen, causal=causal)
    torch.cuda.synchronize()
    assert o.stride() == qt.stride() and dk.stride() == kt.stride()
    for name, got, want in (("o", o, o_ref), ("lse", lse, lse_ref), ("dq", dq, dq_ref),
                            ("dk", dk, dk_ref), ("dv", dv, dv_ref)):
        assert got.dtype == want.dtype and got.shape == want.shape, name
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol, msg=name)
    assert common.LAUNCHES["flash_fwd"] == common.LAUNCHES["flash_bwd_dq"] == 1
    assert common.LAUNCHES["flash_bwd_dkv"] == 1

    # the op in model layout: forward and autograd against the analytic oracle
    lengths = kvlen if ragged else None
    qg, kg, vg = (x.clone().requires_grad_() for x in (q, k, v))
    out = flash_attention(qg, kg, vg, causal=causal, lengths=lengths)
    grads = torch.autograd.grad(out, (qg, kg, vg), do)
    want = t(fref.attention_ref(qt, kt, vt, causal=causal, lengths=lengths))
    wgrads = fref.attention_vjp_ref(qt, kt, vt, dot, causal=causal, lengths=lengths)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    for name, got, w in zip(("dq", "dk", "dv"), grads, wgrads):
        torch.testing.assert_close(got.float(), t(w).float(), atol=tol, rtol=tol, msg=name)
    assert (common.LAUNCHES["flash_fwd"], common.LAUNCHES["flash_bwd_dq"],
            common.LAUNCHES["flash_bwd_dkv"]) == (2, 2, 2)
    # no atomics: the same inputs give the same bits, for dQ, dK and dV
    again = torch.autograd.grad(flash_attention(qg, kg, vg, causal=causal, lengths=lengths),
                                (qg, kg, vg), do)
    for name, a, g in zip(("dq", "dk", "dv"), again, grads):
        assert torch.equal(a, g), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 6])
def test_flash_backward_on_unaligned_rows(nvcc_card, dtype, D):
    """Rows that do not start on 16 bytes (views one element into a wider
    buffer) and a head dim of 6 take the backward's 4-byte copies; they
    agree with the plain versions as the aligned rows do."""
    B, S, NQ, NKV = 2, 77, 4, 2
    rnd = lambda h: torch.randn((B, S, h, D + 1), generator=nvcc_card, device="cuda").to(dtype)
    q, k, v, do = (x[..., 1:].transpose(1, 2) for x in (rnd(NQ), rnd(NKV), rnd(NKV), rnd(NQ)))
    kvlen = torch.tensor([S, 40], dtype=torch.int32, device="cuda")
    tol = FLASH_TOL[dtype]
    o, lse = fref.flash_fwd_ref(q, k, v, kvlen, causal=True)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, do, lse, delta, kvlen)
    got = (fk.flash_bwd_dq_cuda(*args, causal=True),) + fk.flash_bwd_dkv_cuda(*args, causal=True)
    want = (fref.flash_bwd_dq_ref(*args, causal=True),) + fref.flash_bwd_dkv_ref(*args, causal=True)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(g.float(), w.float(), atol=tol, rtol=tol, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 6])
def test_flash_forward_on_unaligned_rows(nvcc_card, dtype, D, causal):
    """The forward on the same unaligned views: its 4-byte copies and the
    element-wise split of Q (scaled), K and V agree with the plain version
    as the aligned rows do."""
    B, S, NQ, NKV = 2, 77, 4, 2
    rnd = lambda h: torch.randn((B, S, h, D + 1), generator=nvcc_card, device="cuda").to(dtype)
    q, k, v = (x[..., 1:].transpose(1, 2) for x in (rnd(NQ), rnd(NKV), rnd(NKV)))
    kvlen = torch.tensor([S, 40], dtype=torch.int32, device="cuda")
    tol = FLASH_TOL[dtype]
    o, lse = fk.flash_fwd_cuda(q, k, v, kvlen, causal=causal)
    o_ref, lse_ref = fref.flash_fwd_ref(q, k, v, kvlen, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.float(), o_ref.float(), atol=tol, rtol=tol, msg="o")
    torch.testing.assert_close(lse, lse_ref, atol=tol, rtol=tol, msg="lse")


def _wls_system(gen, B, N, dtype):
    """Weighted normal equations of a random binary design with an
    intercept column, as LIME accumulates them, on the card; 64 masks, or
    4N where N is larger, so the design has full rank as LIME's has."""
    P = max(64, 4 * N)
    X = (torch.rand((B, P, N), generator=gen, device="cuda") < 0.5).to(dtype)
    X[..., -1] = 1
    w = torch.rand((B, P), generator=gen, device="cuda").to(dtype)
    y = torch.randn((B, P), generator=gen, device="cuda").to(dtype)
    return lstsq_ref.normal_eqs(X, w, y)


# (B, N, masked): the LIME slice's shape (16 groups + intercept), a ragged
# masked shape, and a larger N whose sweep strides over many elements
WLS_SHAPES = [(16, 17, False), (5, 17, True), (3, 65, False), (2, 3, True), (1, 1, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("B,N,masked", WLS_SHAPES)
def test_wls_solve_matches_plain(nvcc_card, dtype, B, N, masked):
    A, rhs = _wls_system(nvcc_card, B, N, dtype)
    mask = None
    if masked:
        mask = (torch.rand((B, N), generator=nvcc_card, device="cuda") > 0.3).to(dtype)
        mask[:, -1] = 1
    Ap, bp = lstsq_ref.prepare_normal_eqs(A, rhs, mask, 1e-2)
    common.reset_launches()
    got = wls_solve_cuda(Ap, bp)
    op = lstsq_ops.wls_solve(A, rhs, mask=mask, ridge=1e-2)
    want = lstsq_ref.gauss_jordan_ref(Ap, bp)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == dtype and got.shape == (B, N)
    torch.testing.assert_close(got, want, atol=1e-6 * float(want.abs().max()), rtol=0)
    assert torch.equal(op, got)
    torch.testing.assert_close(got, lstsq_ref.wls_solve_ref(A, rhs, mask=mask, ridge=1e-2),
                               atol=1e-3, rtol=1e-3)
    if masked:
        assert not bool(got[mask == 0].any())
    assert common.LAUNCHES == {**{name: 0 for name in common.LAUNCHES}, "wls_solve": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("N", [1, 2, 17, 31, 32, 33, 64, 65, 68, 69, 128, 129])
def test_wls_solve_bit_equal_at_variant_edges(nvcc_card, N, dtype, masked):
    """On both sides of each size where ``solve_plan`` changes kernel (the
    warp variant to N = 31, the register variant to 68, shared memory
    beyond, at 128 and 129 too), the kernel equals its plain sweep bit for
    bit, through the launcher and the op, and masked entries give β
    exactly 0."""
    B = 5
    A, rhs = _wls_system(nvcc_card, B, N, dtype)
    mask = None
    if masked:
        mask = (torch.rand((B, N), generator=nvcc_card, device="cuda") > 0.3).to(dtype)
        mask[:, -1] = 1
    Ap, bp = lstsq_ref.prepare_normal_eqs(A, rhs, mask, 1e-2)
    got = wls_solve_cuda(Ap, bp)
    op = lstsq_ops.wls_solve(A, rhs, mask=mask, ridge=1e-2)
    want = lstsq_ref.gauss_jordan_ref(Ap, bp)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want) and torch.equal(op, got)
    if masked:
        assert not bool(op[mask == 0].any())


@pytest.mark.cuda
def test_wls_solve_refuses_what_it_cannot_hold(nvcc_card):
    """A system larger than a block's shared memory raises; nothing takes
    the kernel's place."""
    A = torch.eye(400, device="cuda")[None]
    with pytest.raises(ValueError, match="shared memory"):
        wls_solve_cuda(A, torch.ones((1, 400), device="cuda"))


@pytest.mark.cuda
def test_lime_through_the_kernel_matches_the_plain_hook(nvcc_card):
    """LIME on the card: the default hook (the kernel) against the plain
    sweep as the hook, on the same masks, ragged rows included."""
    from repro_torch.core import perturb

    def plain(A, rhs, *, mask=None, ridge=0.0):
        return lstsq_ref.gauss_jordan_ref(*lstsq_ref.prepare_normal_eqs(A, rhs, mask, ridge))

    def f(xs, t):
        w = 1.0 + torch.arange(xs.shape[1], dtype=torch.float32, device=xs.device)[None, :, None]
        return torch.tanh((w * xs).sum((-2, -1)) / 8.0) + 0.01 * (xs**2).sum((-2, -1))

    B, S = 4, 40
    x = torch.randn((B, S, 3), generator=nvcc_card, device="cuda")
    mask = (torch.arange(S, device="cuda")[None] < torch.tensor([[40], [33], [20], [7]], device="cuda"))
    pe = perturb.PerturbExplainer(f, method="lime", n_masks=64, chunk=16, device="cuda")
    common.reset_launches()
    got = pe.attribute(x, torch.zeros_like(x), None, mask=mask)
    assert common.LAUNCHES["wls_solve"] == 1
    want = perturb.PerturbExplainer(f, method="lime", n_masks=64, chunk=16, device="cuda",
                                    solve_fn=plain).attribute(x, torch.zeros_like(x), None, mask=mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.attributions, want.attributions,
                               atol=1e-6 * float(want.attributions.abs().max()), rtol=0)
    assert not bool(got.attributions[~mask].any())
    assert common.LAUNCHES["wls_solve"] == 1  # the plain hook launched nothing


# ------------------------------------------------------------ the LM engine


def _lm_cpu_and_card(attn):
    """The reduced llama3-8b at f32 compute, seeded weights on the CPU and a
    copy on the card."""
    from dataclasses import replace

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import lm
    from repro_torch.models.common import tree_map

    cfg = replace(reduced(ARCHS["llama3-8b"]), compute_dtype="float32", attn_impl=attn)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    return cfg, params, tree_map(lambda _, t: t.cuda(), params)


@pytest.mark.cuda
@pytest.mark.parametrize("attn", ["auto", "flash"])
def test_lm_logprob_on_the_card_matches_the_cpu(nvcc_card, attn):
    """Ragged rows' target log-probs (f32, TF32 off) within 1e-5; the
    flash path launches the forward kernel."""
    from repro_torch.models.registry import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, p_cpu, p_card = _lm_cpu_and_card(attn)
    model = Model(cfg)
    tokens = torch.randint(1, cfg.vocab_size, (4, 32), generator=torch.Generator().manual_seed(1))
    aux = {"pos": torch.tensor([31, 8, 16, 0]), "target": torch.tensor([5, 7, 9, 11])}
    want = model.target_logprob_at_fn(p_cpu)(model.embed_inputs(p_cpu, {"tokens": tokens}), aux)
    common.reset_launches()
    e = model.embed_inputs(p_card, {"tokens": tokens.cuda()})
    got = model.target_logprob_at_fn(p_card)(e, {k: v.cuda() for k, v in aux.items()})
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)
    assert (common.LAUNCHES["flash_fwd"] > 0) == (attn == "flash")


@pytest.mark.cuda
@pytest.mark.parametrize("S", [96, 256])
def test_local_attention_on_the_card_matches_the_cpu(nvcc_card, S):
    """Sliding-window attention (w=64, 8 query heads on 4, D=128, f32, TF32
    off) on the card within 1e-5 of the CPU: the masked full path at
    S ≤ 2w, the blocked path above (plain PyTorch on both devices)."""
    from repro_torch.models.attention import local_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(S)
    q, k, v = (torch.randn(2, S, h, 128, generator=g) for h in (8, 4, 4))
    want = local_attention(q, k, v, window=64)
    got = local_attention(q.cuda(), k.cuda(), v.cuda(), window=64)
    torch.testing.assert_close(got.cpu(), want, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_lm_init_draws_on_the_card(nvcc_card):
    """A CUDA generator draws every tensor on the card, with the rule's std."""
    from dataclasses import replace

    from repro_torch.configs import ARCHS, reduced
    from repro_torch.models import lm

    cfg = replace(reduced(ARCHS["llama3-8b"]), d_model=256, d_ff=512)
    params = lm.init_params(cfg, nvcc_card, device="cuda")
    wq = params["layers"][0]["mixer"]["wq"]
    assert wq.is_cuda and not wq.requires_grad
    assert abs(float(wq.std()) * (2 * 256 * 4) ** 0.5 - 1) < 0.05  # fan-in L·d·H
    assert abs(float(params["embed"]["embedding"].std()) - 1) < 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("kw,kernels", [
    (dict(method="ig"), ("interpolate", "ig_accum")),
    (dict(method="ig", fused=True), ("interp_add", "accum_cot")),
    (dict(method="idgi", fused=True), ("interp_add", "idgi_dots", "ig_accum_sq")),
    (dict(method="ig", adaptive=True, tol=1e-3, m_max=32), ("interpolate", "ig_accum")),
    (dict(method="lime", n_masks=16), ("wls_solve",)),
])
def test_engine_on_the_card_matches_the_cpu(nvcc_card, kw, kernels):
    """The reduced LM served on mixed lengths through the flash kernels and
    the path's kernels: token scores within 1e-4 of each request's largest
    |score| of the port on the CPU, f(x) within 1e-5, exactly 0 at padding,
    adaptive traces equal."""
    import numpy as np

    from repro_torch.serve import ExplainEngine, ExplainRequest

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, p_cpu, p_card = _lm_cpu_and_card("flash")
    rng = np.random.default_rng(0)
    reqs = [ExplainRequest(rng.integers(1, 512, s).astype(np.int32), int(rng.integers(0, 512)))
            for s in (9, 17, 24, 30)]
    args = dict(m=8, n_int=4, seq_buckets=(8, 16, 32), **kw)
    common.reset_launches()
    got = ExplainEngine(cfg, p_card, device="cuda", **args).explain(reqs, return_raw=True)
    assert all(common.LAUNCHES[k] for k in kernels + ("flash_fwd",))
    want = ExplainEngine(cfg, p_cpu, device="cpu", **args).explain(reqs, return_raw=True)
    for g, w, r in zip(got, want, reqs):
        assert np.all(g["raw_token_scores"][len(r.tokens):] == 0.0)
        assert abs(g["f_x"] - w["f_x"]) <= 1e-5 and abs(g["f_baseline"] - w["f_baseline"]) <= 1e-5
        if "m_used" in w:
            assert (g["m_used"], g["hops"]) == (w["m_used"], w["hops"])
        np.testing.assert_allclose(g["token_scores"], w["token_scores"], rtol=0,
                                   atol=1e-4 * np.abs(w["token_scores"]).max())


@pytest.mark.cuda
def test_serve_on_the_card_matches_the_cpu(nvcc_card):
    """Greedy generation on the reduced LM (f32, TF32 off, flash prefill):
    the card's tokens are the CPU's, its decode logits teacher-forced on
    them within 1e-5, and the prefill launches the flash forward only."""
    from repro_torch.models.registry import Model
    from repro_torch.serve import ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, p_cpu, p_card = _lm_cpu_and_card("flash")
    tokens = torch.randint(1, cfg.vocab_size, (3, 20), generator=torch.Generator().manual_seed(2))
    want = ServeEngine(cfg, p_cpu, 28, device="cpu").generate({"tokens": tokens}, 9)
    common.reset_launches()
    got = ServeEngine(cfg, p_card, 28, device="cuda").generate({"tokens": tokens}, 9)
    assert got.is_cuda and torch.equal(got.cpu(), want)
    assert common.LAUNCHES["flash_fwd"] == cfg.num_layers
    assert sum(common.LAUNCHES.values()) == cfg.num_layers
    model = Model(cfg)

    def forced(params, dev):
        lg, cache = model.prefill(params, {"tokens": tokens.to(dev)}, 28)
        steps = [lg]
        for j in range(8):
            lg, cache = model.decode_step(params, cache, want[:, j:j + 1].to(dev))
            steps.append(lg)
        return torch.cat(steps, 1).cpu()

    torch.testing.assert_close(forced(p_card, "cuda"), forced(p_cpu, "cpu"), atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_mixed_scheduler_on_the_card(nvcc_card):
    """One mixed round on the reduced LM (f32, TF32 off, flash, adaptive):
    the scheduler's greedy tokens are ``ServeEngine.generate``'s on the
    same batch, and every attribution (donated, streamed, explain-only) is
    finite and exactly 0 past its request's tokens."""
    import numpy as np

    from repro_torch.serve import ExplainEngine, ExplainRequest, GenerateRequest, MixedScheduler, ServeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, _, p_card = _lm_cpu_and_card("flash")
    eng = ExplainEngine(cfg, p_card, m=8, n_int=4, seq_buckets=(8, 16, 32), adaptive=True, tol=1e-3,
                        m_max=32, device="cuda")
    sched = MixedScheduler(eng, max_len=32, decode_chunk=4)
    raw, deliver = {}, sched._deliver

    def capture(t, pos, token, r):  # the padded row of each result, before delivery drops it
        raw[(t.id, pos)] = r.get("raw_token_scores")
        deliver(t, pos, token, r)

    sched._deliver = capture
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab_size, (4, 12)).astype(np.int32)
    reqs = [GenerateRequest(p, 9, explain=i < 2, explain_stream=i == 0) for i, p in enumerate(prompts)]
    reqs += [ExplainRequest(rng.integers(1, cfg.vocab_size, s).astype(np.int32), 5) for s in (9, 20)]
    common.reset_launches()
    tickets = [sched.submit(r) for r in reqs]
    sched.run_until_idle()
    assert [t.status for t in tickets] == ["done"] * len(reqs)
    assert all(common.LAUNCHES[k] for k in ("flash_fwd", "flash_bwd_dq", "interpolate", "ig_accum"))
    want = ServeEngine(eng.cfg, p_card, 32, device="cuda").generate({"tokens": torch.from_numpy(prompts)}, 9)
    np.testing.assert_array_equal(np.stack([t.tokens for t in tickets[:4]]), want.cpu().numpy())
    assert [len(t.attributions) for t in tickets[:4]] == [9, 1, 0, 0]
    for t, r in zip(tickets, reqs):
        results = [(-1, t.result)] if t.kind == "explain" else [(a["pos"], a) for a in t.attributions]
        for pos, res in results:
            n, row = len(r.tokens) + max(pos, 0), raw[(t.id, pos)]
            assert res["token_scores"].shape == (n,) and np.isfinite(row).all()
            assert np.all(row[n:] == 0.0) and np.array_equal(row[:n], res["token_scores"])


@pytest.mark.cuda
def test_params_fingerprint_on_the_card_matches_the_cpu(monkeypatch):
    """A tree on the card hashes as its CPU copy does: leaves streamed
    through the pinned buffers in chunks of 1000 bytes (so chunk edges fall
    inside leaves), bf16 as raw words, a 0-d leaf, an empty one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.core import fingerprint

    monkeypatch.setattr(fingerprint, "_CHUNK", 1000)
    g = torch.Generator().manual_seed(0)
    cpu = {"w": torch.randn(37, 41, generator=g), "b": (torch.randn(999, generator=g).to(torch.bfloat16),
           {"i": torch.arange(300, dtype=torch.int32), "s": torch.tensor(2.5), "e": torch.zeros(0)})}
    card = {"w": cpu["w"].cuda(), "b": (cpu["b"][0].cuda(), {k: v.cuda() for k, v in cpu["b"][1].items()})}
    assert fingerprint.params_fingerprint(card) == fingerprint.params_fingerprint(cpu)
    card["w"][3, 5] += 1.0
    assert fingerprint.params_fingerprint(card) != fingerprint.params_fingerprint(cpu)


@pytest.mark.cuda
def test_warm_state_restores_on_the_card(nvcc_card, tmp_path):
    """An adaptive hop-zero engine on the reduced LM (flash) served until its
    starting rungs settle (each round feeds the δ-history), then saved; a
    fresh engine restored from it replays every key, then serves the round
    without a miss and with the saving engine's last round's bits."""
    import numpy as np

    from repro_torch.serve import ExplainEngine, ExplainRequest, load_warm_state, save_warm_state

    cfg, _, p_card = _lm_cpu_and_card("flash")
    kw = dict(m=8, n_int=4, seq_buckets=(8, 16, 32), adaptive=True, tol=1e-3, m_max=32, hop_zero=True,
              hop_zero_min=2, device="cuda")
    rng = np.random.default_rng(0)
    reqs = [ExplainRequest(rng.integers(1, cfg.vocab_size, s).astype(np.int32), 5) for s in (5, 9, 20, 7, 30)]
    eng = ExplainEngine(cfg, p_card, **kw)
    starts = lambda: [eng._hop_zero_m((1, S)) for S in (8, 16, 32)]
    for _ in range(4):
        before = starts()
        want = eng.explain(reqs, return_raw=True)
        if starts() == before:
            break
    assert starts() == before, "the starting rungs did not settle in 4 rounds"
    save_warm_state(eng, str(tmp_path / "warm"))
    fresh = ExplainEngine(cfg, p_card, **kw)
    rep = load_warm_state(fresh, str(tmp_path / "warm"))
    assert rep.restored and rep.via == "replay" and rep.executables == len(eng._cache)
    got = fresh.explain(reqs, return_raw=True)
    assert fresh.stats.misses == 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["raw_token_scores"], b["raw_token_scores"])
        assert (a["delta"], a["m_used"]) == (b["delta"], b["m_used"])


@pytest.fixture
def cuda_gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _moe_layer(gen, dtype):
    """A qwen3-moe layer at d=512, 32 experts top-8 of 128 (full routing
    rules), over 4 × 512 tokens: each token's 8 choices meet in its
    gradient, and a capacity factor of 1 drops some."""
    from dataclasses import replace

    from repro_torch.configs import ARCHS
    from repro_torch.models import moe
    from repro_torch.models.common import init_params

    cfg = replace(ARCHS["qwen3-moe-30b-a3b"], d_model=512, num_experts=32, moe_d_ff=128,
                  capacity_factor=1.0)
    p = init_params(moe.moe_def(cfg), gen, device="cuda")
    x = torch.randn((4, 512, 512), generator=gen, device="cuda").to(dtype)
    return cfg, p, x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_repeats_bit_for_bit_on_the_card(cuda_gen, dtype):
    """Dispatch and combine are gathers in both directions: two calls give
    the same output and input gradient bit for bit (a scatter-add's float
    atomics would not)."""
    from repro_torch.models import moe

    cfg, p, x = _moe_layer(cuda_gen, dtype)
    w = torch.randn(x.shape, generator=cuda_gen, device="cuda").to(dtype)
    outs = []
    for _ in range(2):
        xg = x.clone().requires_grad_()
        y, aux = moe.moe(p, xg, cfg)
        (y * w).sum().backward()
        outs.append((y.detach(), aux.detach(), xg.grad))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    r = moe.route(p["router"], x.reshape(-1, x.shape[-1]), cfg)
    assert 0 < int((~r.keep).sum()) < r.keep.numel()  # some choices dropped, most kept


@pytest.mark.cuda
def test_moe_on_the_card_matches_the_cpu(cuda_gen):
    """f32, TF32 off: output and input gradient within 1e-5 of the CPU's
    largest |value| (f32 products summed in another order), where the
    routing is the same."""
    from repro_torch.models import moe
    from repro_torch.models.common import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, p, x = _moe_layer(cuda_gen, torch.float32)
    got, want = [], []
    for dev, into in (("cuda", got), ("cpu", want)):
        pd = tree_map(lambda _, t: t.to(dev), p)
        xd = x.detach().to(dev).requires_grad_()
        y, _ = moe.moe(pd, xd, cfg)
        y.square().sum().backward()
        r = moe.route(pd["router"], xd.detach().reshape(-1, x.shape[-1]), cfg)
        into += [y.detach().cpu(), xd.grad.cpu(), r.keep.cpu()]
    assert torch.equal(got[2], want[2])
    for a, b in zip(got[:2], want[:2]):
        torch.testing.assert_close(a, b, atol=1e-5 * float(b.abs().max()), rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [256, 997], ids=["S=256 (one chunk)", "S=997 (chunk 1)"])
def test_ssd_on_the_card_matches_the_cpu(cuda_gen, S):
    """mamba2-780m's SSD mixer at full width (48 heads of 64, state 128,
    chunk 256), f32, TF32 off: the output, the prefill's state and conv
    tail, and at S=256 the input gradient (finite: the mask comes before
    the exponential), within 1e-4 of the CPU's largest |value| (sums over
    a 256-token chunk in another order: the state parts by 1.4e-5 of it)."""
    from dataclasses import replace

    from repro_torch.configs import ARCHS
    from repro_torch.models import ssm
    from repro_torch.models.common import init_params, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = replace(ARCHS["mamba2-780m"], compute_dtype="float32")
    p = init_params(ssm.ssm_def(cfg), cuda_gen, device="cuda")
    u = torch.randn((1, S, cfg.d_model), generator=cuda_gen, device="cuda")
    got, want = [], []
    for dev, into in (("cuda", got), ("cpu", want)):
        pd = tree_map(lambda _, t: t.to(dev), p)
        ud = u.detach().to(dev).requires_grad_(S == 256)
        out, cache = ssm.ssm_forward_with_state(pd, ud, cfg)
        into += [out.detach().cpu(), cache["state"].cpu(), cache["conv"].cpu()]
        if S == 256:
            out.square().sum().backward()
            into.append(ud.grad.cpu())
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, atol=1e-4 * float(b.abs().max()), rtol=0)


def test_package_imports_and_runs_on_cpu_without_nvcc(tmp_path, monkeypatch):
    """The CUDA build is lazy: with no nvcc anywhere, every module imports,
    the flash op and the solve op run on CPU tensors, no library is loaded,
    and asking for one raises."""
    src = Path(__file__).resolve().parents[1] / "src"
    code = (
        "import importlib, pkgutil, torch, repro_torch\n"
        "from repro_torch.kernels import common\n"
        "from repro_torch.kernels.flash_attention import kernel, ops\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "q = torch.randn(2, 5, 2, 4, requires_grad=True)\n"
        "ops.flash_attention(q, q, q).sum().backward()\n"
        "assert q.grad.shape == q.shape and kernel.load_library.cache_info().currsize == 0\n"
        "from repro_torch.kernels.lstsq import kernel as lk, ops as lo\n"
        "assert lo.wls_solve(torch.eye(3)[None], torch.ones(1, 3)).shape == (1, 3)\n"
        "assert lk.load_library.cache_info().currsize == 0\n"
        "assert sum(common.LAUNCHES.values()) == 0\n"
    )
    env = {**os.environ, "PATH": str(Path(sys.executable).parent), "PYTHONPATH": str(src),
           "CUDA_HOME": str(tmp_path / "no-cuda")}
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(common, "NVCC_DEFAULT", tmp_path / "nvcc")
    with pytest.raises(RuntimeError, match="nvcc"):
        common.find_nvcc()
