"""Public wrapper: any feature shape, masks, dispatch by device."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.paths import mask_to_baseline
from repro_torch.kernels import common
from repro_torch.kernels.interpolate.kernel import interpolate_triton
from repro_torch.kernels.interpolate.ref import interpolate_ref


def interpolate(
    x: torch.Tensor,
    baseline: torch.Tensor,
    alphas: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Drop-in for ``repro_torch.core.paths.interpolate``.

    x, baseline: (B, *F); alphas: (K,) or (B, K) -> (B, K, *F) in x.dtype.
    mask: optional (B, *L) real-position mask — masked positions are pinned
    to the baseline before the kernel runs, so they interpolate to exactly
    the baseline. CPU tensors take the plain version, CUDA tensors the
    Triton kernel.
    """
    x = mask_to_baseline(x, baseline, mask)
    B, feat = x.shape[0], x.shape[1:]
    if alphas.dim() == 1:
        alphas = alphas.expand(B, -1)
    K = alphas.shape[1]
    xf, bf, af = x.reshape(B, -1), baseline.reshape(B, -1), alphas.float()
    run = interpolate_triton if common.on_cuda(xf, bf, af) else interpolate_ref
    return run(xf, bf, af).reshape((B, K) + feat)


__all__ = ["interpolate", "interpolate_ref", "interpolate_triton"]
