"""Plain PyTorch versions of the batched weighted-least-squares solve (LIME).

The forward-only class accumulates the weighted normal equations
``A = XᵀWX`` / ``b = XᵀWy`` chunk by chunk (``core.perturb.lime_update``)
and solves ``(A + λI) β = b`` per batch row. ``prepare_normal_eqs`` is the
one pre-solve step — the ridge, then mask pinning for ragged batches —
shared by the library oracle ``wls_solve_ref``, the kernel's plain version
``gauss_jordan_ref`` and the kernel op, so kernel parity is over the solve
itself.

Mask pinning: the rows and columns of invalid entries (LIME groups with no
real position in a padded input) are zeroed and their diagonal set to 1
with a zero right-hand side, so their solution entry is exactly zero and
they are decoupled from the valid block.
"""
from __future__ import annotations

from typing import Optional

import torch


def prepare_normal_eqs(
    A: torch.Tensor,
    rhs: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    ridge: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(…, N, N), (…, N) -> the regularized, mask-pinned system, in the
    promoted dtype (float32 at least: bf16 is upcast, float64 stays)."""
    dt = torch.promote_types(A.dtype, torch.float32)
    A, rhs = A.to(dt), rhs.to(dt)
    eye = torch.eye(A.shape[-1], dtype=dt, device=A.device)
    A = A + torch.tensor(ridge, dtype=dt, device=A.device) * eye
    if mask is not None:
        m = mask.to(dt)
        A = A * (m[..., :, None] * m[..., None, :]) + (1.0 - m)[..., :, None] * eye
        rhs = rhs * m
    return A, rhs


def wls_solve_ref(
    A: torch.Tensor,
    rhs: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    ridge: float = 0.0,
) -> torch.Tensor:
    """Batched solve of the prepared system by ``torch.linalg.solve`` (LU
    with pivoting): A (B, N, N), rhs (B, N), mask optional (B, N) -> (B, N)
    in the promoted (≥ f32) dtype. The library oracle the kernel is held
    against; no path of the port calls it."""
    Ap, bp = prepare_normal_eqs(A, rhs, mask, ridge)
    return torch.linalg.solve(Ap, bp[..., None])[..., 0]


def gauss_jordan_ref(A: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """The kernel's plain version: an unpivoted Gauss–Jordan sweep over a
    prepared system, A (B, N, N), rhs (B, N) -> (B, N) in A's dtype.

    The order of operations of ``repro.kernels.lstsq.kernel``'s
    ``_gauss_jordan_kernel``, each operation rounded on its own: for each
    pivot k, ``inv = 1/A[k,k]``, ``row_k = A[k]·inv``, ``b_k = b[k]·inv``,
    then ``A ← A − colz ⊗ row_k`` and ``b ← b − colz·b_k`` with ``colz``
    column k of A zeroed on the pivot row, and the pivot row overwritten by
    ``row_k`` (``b_k``). After N sweeps A is the identity and b the
    solution.
    """
    A, b = A.clone(), rhs.clone()
    N = A.shape[-1]
    rows = torch.arange(N, device=A.device)
    for k in range(N):
        inv = torch.reciprocal(A[:, k, k : k + 1])  # (B, 1), rounded as 1/x
        row_k = A[:, k, :] * inv  # (B, N)
        bk = b[:, k : k + 1] * inv  # (B, 1)
        on_row = rows == k
        colz = torch.where(on_row, torch.zeros_like(A[:, :, k]), A[:, :, k])  # (B, N)
        A = torch.where(on_row[:, None], row_k[:, None, :], A - colz[:, :, None] * row_k[:, None, :])
        b = torch.where(on_row, bk, b - colz * bk)
    return b


def normal_eqs(X: torch.Tensor, w: torch.Tensor, y: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(XᵀWX, XᵀWy) of a raw weighted design — the unchunked form of
    ``core.perturb.lime_update``'s accumulation (a test helper).

    X: (…, P, N) design rows; w: (…, P) weights; y: (…, P) responses.
    """
    Xw = X * w[..., None]
    return torch.einsum("...pi,...pj->...ij", Xw, X), torch.einsum("...pi,...p->...i", Xw, y)
