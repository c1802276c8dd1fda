"""Attribution methods — the ``MethodSpec`` registry.

A ``MethodSpec`` names a per-chunk *accumulator* with one uniform
signature, a finalizer and (optionally) a path-ensemble expansion, so every
IG variant that rides the same interpolate→grad→accumulate loop shares
stage 2. Registered here:

  ig            — vanilla Riemann IG: acc += Σ_k w_k g_k; φ = (x − x′) ⊙ acc.
  idgi          — IDGI (Yang et al., CVPR 2023): each step distributes its
                  tangent f-difference d_k = ⟨g_k, x − x′⟩ w_k over features
                  ∝ g_k², i.e. along the gradient direction only:
                  acc += Σ_k c_k g_k², c_k = w_k ⟨g_k, x − x′⟩ / ⟨g_k, g_k⟩;
                  φ = acc.
  noise_tunnel  — SmoothGrad-style expectation over noisy copies of x:
                  expand each example to n_samples noisy rows, run the
                  riemann accumulation, average.
  expected_grad — expected gradients over a gaussian baseline distribution
                  (``core.baselines.gaussian``), expanded and averaged alike.

  occlusion, rise, lime — the forward-only perturbation class
                  (``repro_torch.core.perturb``): the accumulator consumes
                  f at masked inputs, never a gradient; ``ig.attribute``
                  refuses these specs.

State contract: an accumulator is additive over schedule nodes and
homogeneous of degree 1 in the weights, so ``ig.IGState.acc`` scaled by the
exact power-of-two ``state_scale`` resumes bit-identically after
``schedule.refine_nested``. Both accumulator classes meet it.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional, Union

import torch

from repro_torch.core.baselines import Draw, gaussian
from repro_torch.kernels.ig_accum.ref import idgi_coeff


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


def idgi_accum(
    acc: torch.Tensor,
    grads: torch.Tensor,
    weights: torch.Tensor,
    *,
    diff: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """acc += Σ_k c_k (g_k ⊙ g_k), c_k = w_k ⟨g_k, x − x′⟩ / ⟨g_k, g_k⟩.

    ⟨g, g⟩ == 0 (a flat region) contributes exactly zero. Homogeneous of
    degree 1 in ``weights``, so the resumable-state contract holds.
    """
    if mask is not None:
        grads = grads * expand_mask(mask, grads.dim(), lead=2)
    B, c = grads.shape[:2]
    g = grads.float().reshape(B, c, -1)
    d = diff.float().reshape(B, 1, -1)
    s = (g * g).sum(-1)  # (B, c)  ⟨g, g⟩
    p = (g * d).sum(-1)  # (B, c)  ⟨g, x − x′⟩
    coeff = idgi_coeff(weights, s, p)
    return acc + ((g * g) * coeff[..., None]).sum(1).reshape(acc.shape)


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


def idgi_finalize(
    acc: torch.Tensor,
    x: torch.Tensor,
    baseline: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """IDGI's direction factor is inside the accumulator: φ = acc."""
    if mask is not None:
        acc = acc * expand_mask(mask, acc.dim())
    return acc


# Path-ensemble expansion: (x, baseline, draw, n, sigma) -> (x', baseline')
# with leading axis B·n, samples of example b contiguous at rows
# [b·n, (b+1)·n). ``draw`` is a torch.Generator or the (B·n, *F)
# standard-normal tensor (``core.baselines.standard_normal``).


def noise_expand(
    x: torch.Tensor, baseline: torch.Tensor, draw: Draw, n: int, sigma: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Noise-tunnel sampling: noisy copies of x, shared baseline."""
    from repro_torch.core.smooth import noise_samples  # smooth imports ig, which imports this

    return noise_samples(x, draw, n, sigma), baseline.repeat_interleave(n, dim=0)


def baseline_expand(
    x: torch.Tensor, baseline: torch.Tensor, draw: Draw, n: int, sigma: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Expected-gradients sampling: shared x, baselines drawn from the
    ``core.baselines`` gaussian distribution centred on the nominal x′."""
    br = baseline.repeat_interleave(n, dim=0)
    return x.repeat_interleave(n, dim=0), br + gaussian(br, draw, sigma)


@dataclass(frozen=True)
class MethodSpec:
    """One attribution method = accumulator + finalizer (+ expansion).

    ``accum`` names the accumulator CLASS ("riemann" | "idgi"), which picks
    the kernel op ``Explainer`` injects. ``expand`` (with ``n_samples``/
    ``sigma_default``) turns the method into an expectation over a path
    ensemble; the per-row computation is then exactly the riemann method,
    and the mean over each example's contiguous sample rows is taken after
    stage 2.

    ``grad_linear`` declares the accumulator linear in the per-step
    gradients (riemann: acc += Σ w_k g_k). The fused stage 2
    (``ig.attribute(fused=True)``) then takes the chunk's whole weighted
    gradient sum as the gradient of one broadcast (B, *F) carry. Quadratic
    accumulators (idgi) keep per-step gradients: they set
    ``grad_linear=False`` and the fused path takes the gradient of a
    per-step (B, c, *F) carry instead.
    """

    name: str
    accum: str
    accum_fn: Callable
    finalize: Callable
    expand: Optional[Callable] = None
    n_samples: int = 1
    sigma_default: float = 0.1
    grad_linear: bool = True
    # forward-only perturbation class (``core.perturb``): the accumulator
    # consumes f VALUES over n_masks binary masks, never a gradient —
    # ``ig.attribute`` refuses these specs; they run through
    # ``perturb.attribute_from_masks`` / ``PerturbExplainer``
    forward_only: bool = False
    n_masks: int = 0  # default mask budget P (forward-only methods)
    description: str = ""

    def row_spec(self) -> "MethodSpec":
        """The per-row spec with the expansion stripped."""
        if self.expand is None:
            return self
        return replace(self, expand=None, n_samples=1)


METHODS: dict[str, MethodSpec] = {
    "ig": MethodSpec(
        "ig", "riemann", riemann_accum, riemann_finalize,
        description="vanilla integrated gradients (weighted Riemann sum)",
    ),
    "idgi": MethodSpec(
        "idgi", "idgi", idgi_accum, idgi_finalize, grad_linear=False,
        description="IDGI: per-step f-difference split along the gradient direction",
    ),
    "noise_tunnel": MethodSpec(
        "noise_tunnel", "riemann", riemann_accum, riemann_finalize,
        expand=noise_expand, n_samples=4, sigma_default=0.1,
        description="SmoothGrad-style expectation of IG over noisy copies of x",
    ),
    "expected_grad": MethodSpec(
        "expected_grad", "riemann", riemann_accum, riemann_finalize,
        expand=baseline_expand, n_samples=4, sigma_default=0.1,
        description="expected gradients over a gaussian baseline distribution",
    ),
}


def _register_forward_only() -> None:
    from repro_torch.core import perturb  # perturb imports this module only lazily

    for name, n_masks, desc in (
        ("occlusion", 64, "sliding-window occlusion (mean f-drop per position)"),
        ("rise", 64, "RISE: random binary keep-masks, E[f | kept] − E[f]"),
        ("lime", 64, "LIME: weighted ridge regression on position-group masks"),
    ):
        update, finalize = perturb._FWD[name][1:]
        METHODS[name] = MethodSpec(
            name, name, update, finalize, forward_only=True,
            grad_linear=False, n_masks=n_masks, description=desc,
        )


_register_forward_only()


def get(name: Union[str, MethodSpec]) -> MethodSpec:
    """Look up a registered ``MethodSpec`` by name (specs pass through).

        >>> sorted(METHODS)
        ['expected_grad', 'idgi', 'ig', 'lime', 'noise_tunnel', 'occlusion', 'rise']
        >>> get("noise_tunnel").accum  # per row it is the riemann method
        'riemann'
        >>> get("rise").forward_only  # perturbation class: no gradient
        True
    """
    if isinstance(name, MethodSpec):
        return name
    if name not in METHODS:
        raise ValueError(f"unknown attribution method {name!r}; known: {sorted(METHODS)}")
    return METHODS[name]
