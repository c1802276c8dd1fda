"""The LIME solve hook: ``wls_solve(A, rhs, *, mask, ridge) -> beta``.

The signature of ``repro.kernels.lstsq.ops.wls_solve``, so it drops into
``core.perturb.attribute_from_masks(solve_fn=...)``, where it is the
default. The system is prepared first (``ref.prepare_normal_eqs``: upcast to
float32 at least, ridge, mask pinning); CPU tensors then take the plain
sweep ``gauss_jordan_ref``, CUDA tensors the kernel. The JAX op pads N to a
multiple of 8 for the TPU's sublanes; the identity rows it adds never couple
to the real block, so the CUDA kernel takes N as it is and gives the same β.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import common
from repro_torch.kernels.lstsq.kernel import wls_solve_cuda
from repro_torch.kernels.lstsq.ref import gauss_jordan_ref, prepare_normal_eqs


def wls_solve(
    A: torch.Tensor,
    rhs: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    ridge: float = 0.0,
) -> torch.Tensor:
    """Solve ``(A + λI) β = rhs`` per batch row.

    A: (B, N, N) accumulated normal equations (any float dtype); rhs (B, N);
    mask: optional (B, N) valid-entry mask — invalid rows are pinned to
    identity with a zero right-hand side, so β is exactly zero there.
    Returns (B, N) in the promoted (≥ float32) dtype.
    """
    Ap, bp = prepare_normal_eqs(A, rhs, mask, ridge)
    run = wls_solve_cuda if common.on_cuda(Ap, bp) else gauss_jordan_ref
    return run(Ap, bp)


__all__ = ["wls_solve", "wls_solve_cuda", "gauss_jordan_ref", "prepare_normal_eqs"]
