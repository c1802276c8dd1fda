"""Related-work integrations on top of the engine (paper §I: XRAI, Noise
Tunnel, multi-baseline all *reuse* baseline IG — so all of them inherit the
NUIG speedup for free; these wrappers demonstrate that composition).

``noise_samples`` is the one shared sampling primitive: the registered
``noise_tunnel`` MethodSpec (``repro_torch.core.methods``) expands batches
through it, and the ``noise_tunnel`` wrapper below averages full IGResults
over the same distribution. Draws are a ``torch.Generator`` or the
standard-normal tensor itself (``core.baselines.standard_normal``).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.baselines import Draw, standard_normal
from repro_torch.core.ig import IGResult


def noise_samples(x: torch.Tensor, draw: Draw, n: int, sigma: float) -> torch.Tensor:
    """n gaussian-noised copies per example: (B, *F) -> (B·n, *F), samples of
    example b contiguous at rows [b·n, (b+1)·n). The noise is N(0, 1)·σ in
    f32, cast to x.dtype, then added; ``draw`` as a tensor is (B·n, *F)."""
    xr = x.repeat_interleave(n, dim=0)
    noise = standard_normal(draw, xr) * sigma
    return (xr + noise.to(xr.dtype)).to(x.dtype)


def _mean(results: list[IGResult]) -> IGResult:
    return IGResult(*(torch.stack(field).mean(0) for field in zip(*results)))


def noise_tunnel(
    attribute_fn: Callable[[torch.Tensor], IGResult],
    x: torch.Tensor,
    draw: Draw,
    *,
    n_samples: int = 4,
    sigma: float = 0.1,
) -> IGResult:
    """SmoothGrad-style: average attributions over noisy copies of x.

    ``attribute_fn(x_noisy) -> IGResult`` encapsulates baseline + schedule,
    so NUIG (or any schedule) composes transparently. ``draw`` as a tensor
    is (n_samples, *x.shape), one standard-normal draw per sample; the noise
    is cast to x.dtype before it is scaled by σ.
    """
    z = standard_normal(draw, x.expand((n_samples,) + tuple(x.shape)))
    return _mean([attribute_fn(x + z[i].to(x.dtype) * sigma) for i in range(n_samples)])


def multi_baseline(
    attribute_fn: Callable[[torch.Tensor], IGResult],
    baselines: list[torch.Tensor],
) -> IGResult:
    """Expected-gradients-style averaging over several baselines."""
    return _mean([attribute_fn(b) for b in baselines])
