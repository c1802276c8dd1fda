"""Differentiable fused interp-plus-carry op — the fused stage 2's kernel unit.

``interp_accum`` is the drop-in for ``repro_torch.core.paths.interp_add``
(the function ``ig.attribute(fused=True)`` differentiates w.r.t. its carry),
as a ``torch.autograd.Function``:

  forward   b + α(x − x′) + carry in one pass (``interp_add`` kernel);
  backward  carry rank 2 (riemann class, carry broadcast over the steps):
            the one-pass K-reduction (``accum_cot`` kernel); carry rank 3
            (per-step carry): an f32 cast of the cotangent, no kernel.

The op is differentiable w.r.t. the carry only: the gradients of the
endpoints and the alphas are zero (returned as ``None``), because the fused
stage 2 treats (x, x′, α) as constants of the chunk. Use
``paths.interp_add`` where gradients through the endpoints are needed.
CPU tensors take the plain versions, CUDA tensors the Triton kernels.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.paths import mask_to_baseline
from repro_torch.kernels import common
from repro_torch.kernels.interp_accum.kernel import accum_cot_triton, interp_add_triton
from repro_torch.kernels.interp_accum.ref import accum_cot_ref, interp_add_ref


class InterpAdd(torch.autograd.Function):
    """Flat core: x/baseline (B, F), alphas (B, K) f32, carry (B, F) or
    (B, K, F) f32 -> (B, K, F) in x.dtype."""

    @staticmethod
    def forward(ctx, x, baseline, alphas, carry):
        ctx.bcast = carry.dim() == 2
        run = interp_add_triton if common.on_cuda(x, baseline, alphas, carry) else interp_add_ref
        return run(x, baseline, alphas, carry)

    @staticmethod
    def backward(ctx, g):
        if ctx.bcast:  # transpose of the step broadcast: the K-sum
            ubar = accum_cot_triton(g) if common.on_cuda(g) else accum_cot_ref(g)
        else:  # identity transpose, f32 cast only
            ubar = g.float()
        return None, None, None, ubar


def interp_accum(
    x: torch.Tensor,
    baseline: torch.Tensor,
    alphas: torch.Tensor,
    carry: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Drop-in for ``repro_torch.core.paths.interp_add``.

    x, baseline: (B, *F); alphas: (K,) or (B, K); carry: (B, *F) f32
    (broadcast over the steps) or (B, K, *F) f32 (per step). Returns
    (B, K, *F) in ``x.dtype``. mask: optional (B, *L) real-position mask —
    masked positions are pinned to the baseline before the kernel runs.
    """
    x = mask_to_baseline(x, baseline, mask)
    B, feat = x.shape[0], x.shape[1:]
    if alphas.dim() == 1:
        alphas = alphas.expand(B, -1)
    K = alphas.shape[1]
    bcast = carry.dim() == x.dim()
    cf = carry.float().reshape((B, -1) if bcast else (B, K, -1))
    out = InterpAdd.apply(x.reshape(B, -1), baseline.reshape(B, -1), alphas.float(), cf)
    return out.reshape((B, K) + feat)


__all__ = ["InterpAdd", "interp_accum", "interp_add_ref", "accum_cot_ref"]
