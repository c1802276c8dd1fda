"""IG baselines — the notion of 'missingness' (paper §II).

Vision: black / white / noise images. Token models: the pad-token
embedding (interpolation happens in embedding space — tokens are discrete).

``BASELINES``/``get`` cover every baseline here, including the ones that
need extra arguments (``gaussian`` a draw, ``pad_embedding`` the embedding
table); callers bind those with ``functools.partial`` or keywords.

Random draws: where ``repro`` takes a ``jax.random`` key, the port takes a
``draw`` — a ``torch.Generator`` to draw standard normals from, or the
standard-normal tensor itself (parity tests hand in JAX's draw this way).
"""
from __future__ import annotations

from typing import Union

import torch

Draw = Union[torch.Generator, torch.Tensor]


def standard_normal(draw: Draw, like: torch.Tensor) -> torch.Tensor:
    """A standard-normal f32 tensor of ``like``'s shape on its device: drawn
    from the generator ``draw`` (on the generator's device), or ``draw``
    itself when it is already a tensor of that shape.

        >>> tuple(standard_normal(torch.Generator().manual_seed(0), torch.zeros(2, 3)).shape)
        (2, 3)
    """
    shape = tuple(like.shape)
    if isinstance(draw, torch.Tensor):
        if tuple(draw.shape) != shape:
            raise ValueError(f"draw has shape {tuple(draw.shape)}, expected {shape}")
        return draw.to(device=like.device, dtype=torch.float32)
    return torch.randn(shape, generator=draw, device=draw.device).to(like.device)


def black(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(x)


def white(x: torch.Tensor, value: float = 1.0) -> torch.Tensor:
    return torch.full_like(x, value)


def gaussian(x: torch.Tensor, draw: Draw, sigma: float = 1.0) -> torch.Tensor:
    """σ·N(0, 1) noise of x's shape, scaled in f32 and cast to x.dtype."""
    return (standard_normal(draw, x) * sigma).to(x.dtype)


def pad_embedding(embed_table: torch.Tensor, x_embeds: torch.Tensor, pad_id: int = 0) -> torch.Tensor:
    """Baseline for token models: every position = the pad-token embedding."""
    pad = embed_table[pad_id].to(x_embeds.dtype)
    return pad.expand(x_embeds.shape)


BASELINES = {
    "black": black,
    "white": white,
    "gaussian": gaussian,
    "pad_embedding": pad_embedding,
}


def get(name: str):
    """Look up a baseline by name.

        >>> get("black") is black
        True
    """
    if name not in BASELINES:
        raise ValueError(f"unknown baseline {name!r}; valid baselines: {sorted(BASELINES)}")
    return BASELINES[name]
