"""The port's Triton kernels against their plain versions, on a CUDA card.

Needs a card and ``triton``; skips elsewhere. Imports no JAX (the card's
machine has none), so run it there without the repository's conftest:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: elementwise f32 kernels 1e-6 (FMA contraction is off, so they
round like the plain version); bf16 one ulp at the values' magnitude
(2**-7 for values below 2); K-sums 1e-5 relative (another summation order).
"""
import importlib.util

import pytest
import torch

from repro_torch.kernels import common
from repro_torch.kernels.ig_accum.kernel import ig_accum_triton
from repro_torch.kernels.ig_accum.ops import ig_accum
from repro_torch.kernels.ig_accum.ref import ig_accum_ref
from repro_torch.kernels.interp_accum.kernel import accum_cot_triton, interp_add_triton
from repro_torch.kernels.interp_accum.ops import interp_accum
from repro_torch.kernels.interp_accum.ref import accum_cot_ref, interp_add_ref
from repro_torch.kernels.interpolate.kernel import interpolate_triton
from repro_torch.kernels.interpolate.ops import interpolate
from repro_torch.kernels.interpolate.ref import interpolate_ref

TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0**-7}
SHAPES = [(1, 1, 3), (3, 5, 77), (2, 9, 130), (4, 37, 3000), (16, 64, 3072)]  # (B, K, F)


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
    # each wrapper counts exactly its own launches
    assert common.LAUNCHES == {"interpolate": 2, "ig_accum": 2, "interp_add": 3, "accum_cot": 2}
