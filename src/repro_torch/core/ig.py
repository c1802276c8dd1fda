"""The IG engine — stage 2: batched, chunked gradient accumulation.

One function serves every schedule: the (alphas, weights) vectors are data.
The step axis is folded into the batch axis, and steps run in chunks of a
fixed size (a Python loop over chunks, where ``repro`` used ``lax.scan``),
so memory stays bounded for any m.

The per-chunk accumulator and the finalizer come from the
``repro_torch.core.methods`` registry. Kernel injection: ``interp_fn`` /
``interp_add_fn`` / ``accum_fn`` default to the plain PyTorch functions and
can be swapped for the Triton ops in ``repro_torch.kernels``
(``repro_torch.core.api.Explainer`` injects them by default).

Masking: ``mask`` marks real positions of right-padded inputs. It is
threaded through ``interp_fn`` (padded positions never leave the baseline),
the accumulator (padded gradients never accumulate), and the final
attribution (exact zeros at padded positions).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

from repro_torch.core import methods as methods_mod
from repro_torch.core.methods import MethodSpec, expand_mask
from repro_torch.core.paths import interp_add, interpolate, mask_to_baseline
from repro_torch.core.probes import ScalarFn, repeat_tree
from repro_torch.core.schedule import Schedule


class IGResult(NamedTuple):
    attributions: torch.Tensor  # (B, *F)
    f_x: torch.Tensor  # (B,) model output at the input
    f_baseline: torch.Tensor  # (B,) model output at the baseline
    delta: torch.Tensor  # (B,) convergence δ (completeness gap, Eq. 3)


class IGState(NamedTuple):
    """Resumable stage-2 accumulator (the adaptive ladder).

    ``acc`` is the method's running node sum Σ_k w_k g_k at the rung last
    run (before the (x − x′) factor); ``f_x``/``f_baseline`` are the
    endpoint forwards, computed once at rung 0 and carried so ladder hops
    never repeat them. Every field is per-example, so rows may be gathered.
    """

    acc: torch.Tensor  # (B, *F) float32 running node sum
    f_x: torch.Tensor  # (B,)
    f_baseline: torch.Tensor  # (B,)


def attribute(
    f: ScalarFn,
    x: torch.Tensor,
    baseline: torch.Tensor,
    sched: Schedule,
    target: Optional[torch.Tensor],
    *,
    method: Union[str, MethodSpec] = "ig",
    mask: Optional[torch.Tensor] = None,
    chunk: int = 0,
    fused: bool = False,
    interp_fn: Callable = interpolate,
    interp_add_fn: Callable = interp_add,
    accum_fn: Optional[Callable] = None,
    state: Optional[IGState] = None,
    state_scale: float = 1.0,
    return_state: bool = False,
    f_x: Optional[torch.Tensor] = None,
):
    """Path attribution along the straight line with any schedule + method.

    f: (xs (N, *F), targets) -> (N,);  x/baseline: (B, *F); target: (B,)
    ids or None. sched.alphas/weights: (m,) shared or (B, m) per-example.
    mask: optional (B, *L) real-position mask, L a prefix of the feature dims.

    Unfused (default): each chunk's interpolants are made by ``interp_fn``
    outside the graph, and the gradient of Σ f at them goes to ``accum_fn``.
    Fused (``fused=True``, grad-linear methods): the interpolants are made
    inside the differentiated function by ``interp_add_fn`` from a zero f32
    carry, and the gradient w.r.t. that carry of Σ_k w_k f(x_k) is the whole
    chunk's weighted gradient sum — the per-step gradient batch is never
    formed. The two agree to float tolerance, not bitwise.

    Probe reuse: ``f_x`` (B,) known endpoint values; only f(baseline) is
    then computed. Ignored when resuming from ``state``.

    Resumability: pass ``state`` from a prior call to continue accumulating
    — ``sched`` then holds only the NEW nodes, and the prior accumulator
    enters scaled by ``state_scale`` (0.5 per nested-refinement doubling,
    exact), so resuming is bit-identical to one fixed run over the whole
    refined schedule at the same ``chunk``. With ``return_state`` the call
    returns ``(IGResult, IGState)``.
    """
    spec = methods_mod.get(method)
    if accum_fn is None:
        accum_fn = spec.accum_fn
    B, feat = x.shape[0], tuple(x.shape[1:])
    # pinned view for the endpoint terms; the interpolants are pinned inside
    # interp_fn / interp_add_fn (mask kwarg)
    xp = mask_to_baseline(x, baseline, mask)
    diff = xp - baseline  # path direction, for direction-aware accumulators
    alphas, weights = sched.alphas, sched.weights
    if alphas.dim() == 1:
        alphas = alphas.expand(B, -1)
        weights = weights.expand(B, -1)
    m = alphas.shape[-1]
    c = chunk if chunk and chunk < m else m
    if m % c:
        raise ValueError(f"chunk {c} must divide m {m}")
    mkw = {} if mask is None else {"mask": mask}

    if state is None:
        acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    else:
        acc = state.acc.float()
        if state_scale != 1.0:
            acc = acc * state_scale
    for s in range(0, m, c):
        a, w = alphas[:, s : s + c], weights[:, s : s + c]  # (B, c)
        t = repeat_tree(target, c)
        if fused:
            u = torch.zeros(x.shape, dtype=torch.float32, device=x.device, requires_grad=True)
            xi = interp_add_fn(x, baseline, a, u, **mkw)  # (B, c, *F)
            vals = f(xi.reshape((B * c,) + feat), t).float()
            (inc,) = torch.autograd.grad((vals * w.float().reshape(-1)).sum(), u)
            if mask is not None:  # match the unfused accumulators' masked grads
                inc = inc * expand_mask(mask, inc.dim())
            acc = acc + inc
        else:
            xi = interp_fn(x, baseline, a, **mkw)  # (B, c, *F)
            flat = xi.reshape((B * c,) + feat).detach().requires_grad_()
            (g,) = torch.autograd.grad(f(flat, t).sum(), flat)
            acc = accum_fn(acc, g.reshape((B, c) + feat), w, diff=diff, **mkw)
    attr = spec.finalize(acc, xp, baseline, mask)

    with torch.no_grad():
        if state is not None:
            f_x, f_b = state.f_x, state.f_baseline
        elif f_x is not None:
            f_x = f_x.float()
            f_b = f(baseline, target)
        else:
            both = torch.cat([xp, baseline], dim=0)
            tt = None if target is None else torch.cat([target, target], dim=0)
            fv = f(both, tt)
            f_x, f_b = fv[:B], fv[B:]
    # attr is exactly zero at masked positions, so the full sum IS the
    # real-position sum
    delta = (attr.reshape(B, -1).sum(-1) - (f_x - f_b)).abs()
    res = IGResult(attr, f_x, f_b, delta)
    if return_state:
        return res, IGState(acc, f_x, f_b)
    return res
