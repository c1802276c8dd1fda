"""Public wrapper for the Riemann accumulation kernel.

``ig_accum`` honours the MethodSpec accumulator signature
``(acc, grads, weights, *, diff, mask)``, so it drops into
``ig.attribute(accum_fn=...)`` for the riemann class (``ig``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.methods import expand_mask
from repro_torch.kernels import common
from repro_torch.kernels.ig_accum.kernel import ig_accum_triton
from repro_torch.kernels.ig_accum.ref import ig_accum_ref


def ig_accum(
    acc: torch.Tensor,
    grads: torch.Tensor,
    weights: torch.Tensor,
    *,
    diff: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Drop-in for ``repro_torch.core.methods.riemann_accum``.

    acc: (B, *F) f32; grads: (B, K, *F); weights: (B, K) -> (B, *F) f32.
    diff: accepted for signature uniformity (riemann ignores the direction).
    mask: optional (B, *L) real-position mask — gradients at masked
    positions are zeroed before accumulation. CPU tensors take the plain
    version, CUDA tensors the Triton kernel.
    """
    if mask is not None:
        grads = grads * expand_mask(mask, grads.dim(), lead=2).to(grads.dtype)
    B, K = grads.shape[:2]
    af, gf = acc.reshape(B, -1), grads.reshape(B, K, -1)
    run = ig_accum_triton if common.on_cuda(af, gf, weights) else ig_accum_ref
    return run(af, gf, weights).reshape(acc.shape)


__all__ = ["ig_accum", "ig_accum_ref", "ig_accum_triton"]
