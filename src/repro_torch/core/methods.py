"""Attribution methods — the ``MethodSpec`` registry.

A ``MethodSpec`` names a per-chunk *accumulator* with one uniform
signature and a finalizer, so every IG variant that rides the same
interpolate→grad→accumulate loop shares stage 2. Registered here:

  ig  — vanilla Riemann IG: acc += Σ_k w_k g_k; φ = (x − x′) ⊙ acc.

``repro.core.methods``' IDGI, path ensembles (noise_tunnel, expected_grad)
and the forward-only perturbation methods are not ported yet.

State contract: an accumulator is additive over schedule nodes and
homogeneous of degree 1 in the weights, so ``ig.IGState.acc`` scaled by the
exact power-of-two ``state_scale`` resumes bit-identically after
``schedule.refine_nested``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Union

import torch


def expand_mask(mask: torch.Tensor, ndim: int, *, lead: int = 1) -> torch.Tensor:
    """(B, *L) -> (B, 1×(lead-1), *L, 1, ...) broadcastable to rank ``ndim``."""
    shape = tuple(mask.shape[:1]) + (1,) * (lead - 1) + tuple(mask.shape[1:])
    return mask.reshape(shape + (1,) * (ndim - len(shape))).float()


# Accumulator signature:
#   accum(acc (B, *F) f32, grads (B, c, *F), weights (B, c),
#         *, diff (B, *F), mask optional (B, *L)) -> (B, *F) f32
# The Triton drop-in lives in ``repro_torch.kernels.ig_accum.ops``.


def riemann_accum(
    acc: torch.Tensor,
    grads: torch.Tensor,
    weights: torch.Tensor,
    *,
    diff: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """acc += Σ_k w_k g_k — the vanilla IG path-integral estimate."""
    if mask is not None:
        grads = grads * expand_mask(mask, grads.dim(), lead=2)
    wexp = weights.reshape(tuple(weights.shape) + (1,) * (grads.dim() - 2))
    return acc + (grads.float() * wexp).sum(1)


def riemann_finalize(
    acc: torch.Tensor,
    x: torch.Tensor,
    baseline: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """φ = (x − x′) ⊙ acc, exactly zero at masked positions."""
    attr = (x - baseline).float() * acc
    if mask is not None:
        attr = attr * expand_mask(mask, attr.dim())
    return attr


@dataclass(frozen=True)
class MethodSpec:
    """One attribution method = accumulator + finalizer.

    ``accum`` names the accumulator CLASS ("riemann"), which picks the
    kernel op ``Explainer`` injects. Every registered accumulator is linear
    in the per-step gradients, which the fused stage 2
    (``ig.attribute(fused=True)``) relies on: the chunk's weighted gradient
    sum is one (B, *F) gradient of a broadcast carry.
    """

    name: str
    accum: str
    accum_fn: Callable
    finalize: Callable


METHODS: dict[str, MethodSpec] = {
    # vanilla integrated gradients (weighted Riemann sum)
    "ig": MethodSpec("ig", "riemann", riemann_accum, riemann_finalize),
}


def get(name: Union[str, MethodSpec]) -> MethodSpec:
    """Look up a registered ``MethodSpec`` by name (specs pass through).

        >>> sorted(METHODS)
        ['ig']
        >>> get("ig").accum
        'riemann'
    """
    if isinstance(name, MethodSpec):
        return name
    if name not in METHODS:
        raise ValueError(f"unknown attribution method {name!r}; known: {sorted(METHODS)}")
    return METHODS[name]
