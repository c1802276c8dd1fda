"""The synthetic contrast-threshold image task of the trained classifiers.

The counterpart of ``benchmarks/common.py``'s ``synthetic_images``. Class
1..9 is a bright blob at a class-specific spot of a 3×3 grid plus a
class-specific texture; class 0 is the background: any such image dimmed
far below the contrast threshold. A classifier trained on it keeps
predicting "background" along the black→image IG path until a sharp
transition, which is the paper's regime (Fig. 3): the class probability
rises in a narrow α-interval.

``render_images`` is the pure function of the draws; ``synthetic_images``
draws them from an explicit CPU ``torch.Generator`` and moves them to the
device, so one seed gives the card and the CPU the same images.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.paper_cnn import CONFIG as PAPER_CNN


def render_images(cfg, labels: torch.Tensor, noise: torch.Tensor, is_bg: Optional[torch.Tensor] = None,
                  scale: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(labels (n,) in 1..C−1, noise (n, s, s), optional background mask
    and dimming scale (n,)) -> (images (n, s, s, channels) in [0, 1],
    labels with the dimmed rows relabelled 0), on the draws' device."""
    s = cfg.image_size
    grid = torch.arange(s, dtype=torch.float32, device=labels.device) / s
    yy, xx = torch.meshgrid(grid, grid, indexing="ij")  # jnp.mgrid's (rows, cols)
    lf = labels.to(torch.float32)[:, None, None]
    cx = torch.remainder(labels, 3).to(torch.float32)[:, None, None] / 3.0 + 0.15
    cy = torch.remainder(torch.div(labels, 3, rounding_mode="floor"), 3).to(torch.float32)[:, None, None] / 3.0 + 0.15
    blob = torch.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / 0.02))
    tex = torch.sin((lf + 2) * 3.0 * xx) * 0.3
    img = torch.clamp(blob + tex + 0.1 * noise, 0, 2) / 2.0
    if is_bg is not None:
        img = torch.where(is_bg[:, None, None], img * scale[:, None, None], img)
        labels = torch.where(is_bg, torch.zeros_like(labels), labels)
    return img[..., None].repeat_interleave(cfg.channels, dim=-1), labels


def synthetic_images(generator: torch.Generator, n: int, cfg=PAPER_CNN, *, background_frac: float = 0.0,
                     device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """``n`` images of the task and their labels on ``device``: labels
    uniform in [1, num_classes), unit normal noise (n, s, s), and, when
    ``background_frac`` > 0, rows made background with that probability,
    dimmed by a factor uniform in [0.02, 0.25]. Drawn in that order from
    ``generator`` (a CPU generator)."""
    s = cfg.image_size
    labels = torch.randint(1, cfg.num_classes, (n,), generator=generator)
    noise = torch.randn((n, s, s), generator=generator)
    is_bg = scale = None
    if background_frac > 0:
        is_bg = (torch.rand((n,), generator=generator) < background_frac).to(device)
        scale = (0.02 + 0.23 * torch.rand((n,), generator=generator)).to(device)
    return render_images(cfg, labels.to(device), noise.to(device), is_bg, scale)
