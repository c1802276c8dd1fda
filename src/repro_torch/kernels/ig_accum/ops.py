"""Public wrappers for the accumulation kernels.

Both wrappers honour the MethodSpec accumulator signature
``(acc, grads, weights, *, diff, mask)``, so they drop into
``ig.attribute(accum_fn=...)`` for their method: ``ig_accum`` for every
riemann-class method (ig, noise_tunnel, expected_grad; ``diff`` is accepted
and ignored), ``ig_accum_idgi`` for IDGI. ``accum_fn_for`` maps an
accumulator class name to its op. CPU tensors take the plain versions,
CUDA tensors the Triton kernels.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.methods import expand_mask
from repro_torch.kernels import common
from repro_torch.kernels.ig_accum.kernel import (
    idgi_dots_triton,
    ig_accum_sq_triton,
    ig_accum_triton,
)
from repro_torch.kernels.ig_accum.ref import (
    idgi_coeff,
    idgi_dots_ref,
    ig_accum_idgi_ref,
    ig_accum_ref,
    ig_accum_sq_ref,
)


def _mask_grads(grads: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return grads
    return grads * expand_mask(mask, grads.dim(), lead=2).to(grads.dtype)


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
    positions are zeroed before accumulation.
    """
    grads = _mask_grads(grads, mask)
    B, K = grads.shape[:2]
    af, gf = acc.reshape(B, -1), grads.reshape(B, K, -1)
    run = ig_accum_triton if common.on_cuda(af, gf, weights) else ig_accum_ref
    return run(af, gf, weights).reshape(acc.shape)


def ig_accum_idgi(
    acc: torch.Tensor,
    grads: torch.Tensor,
    weights: torch.Tensor,
    *,
    diff: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Drop-in for ``repro_torch.core.methods.idgi_accum`` (two kernels).

    acc: (B, *F) f32; grads: (B, K, *F); weights: (B, K); diff: (B, *F)
    -> (B, *F) f32 = acc + Σ_k w_k ⟨g_k, diff⟩/⟨g_k, g_k⟩ · g_k², a step
    with ⟨g, g⟩ = 0 adding exactly 0. mask: optional (B, *L) real-position
    mask — gradients at masked positions are zeroed first. The (B, K)
    coefficient is formed between the two kernels in plain PyTorch, as the
    JAX op forms it outside Pallas.
    """
    grads = _mask_grads(grads, mask)
    B, K = grads.shape[:2]
    af, gf, df = acc.reshape(B, -1), grads.reshape(B, K, -1), diff.reshape(B, -1)
    if common.on_cuda(af, gf, weights, df):
        dots, accum_sq = idgi_dots_triton, ig_accum_sq_triton
    else:
        dots, accum_sq = idgi_dots_ref, ig_accum_sq_ref
    s, p = dots(gf, df)
    return accum_sq(af, gf, idgi_coeff(weights, s, p)).reshape(acc.shape)


def accum_fn_for(accum: str) -> Callable:
    """The kernel op of a MethodSpec accumulator class name.

        >>> accum_fn_for("idgi").__name__
        'ig_accum_idgi'
    """
    table = {"riemann": ig_accum, "idgi": ig_accum_idgi}
    if accum not in table:
        raise ValueError(f"unknown accumulator class {accum!r}; known: {sorted(table)}")
    return table[accum]


__all__ = ["ig_accum", "ig_accum_idgi", "ig_accum_ref", "ig_accum_idgi_ref", "accum_fn_for"]
