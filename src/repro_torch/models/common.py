"""Parameter definitions and their initialisation: ``repro.models.common``.

A model is described as a tree (dicts and tuples) of ``ParamDef``s, from
which ``init_params`` draws the tensors. The rule is ``repro``'s, quirks
included: a normal tensor's std is its ``scale`` or 1/√fan_in, where the
fan-in is the product of every axis but the last — so a stacked weight's
leading ``layers`` axis counts, and ``wq`` (d, H, D) has fan-in d·H; an
``embed`` tensor is a unit normal (times ``scale``); ``zeros``/``ones`` are
constant. Each definition carries ``repro``'s logical axis names, which
``sharding.param_specs`` maps onto a mesh; ``abstract_params`` makes the
shape-only tree of the dry run (``meta`` tensors, nothing allocated).
``tree_leaves_with_path``, ``tree_leaves`` and ``tree_unflatten`` walk a
tree in ``jax.tree_util``'s order, as the optimizer, the checkpoints and
the fingerprints do.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Iterator, NamedTuple, Optional

import numpy as np
import torch


class ParamDef(NamedTuple):
    """One parameter tensor: shape, init rule and logical axis names."""

    shape: tuple
    init: str = "normal"  # normal | zeros | ones | embed
    scale: Optional[float] = None  # std override (normal, embed); None: the rule's
    axes: tuple = ()  # one logical axis name (or None) per dimension, as repro's


def fan_in(shape: tuple) -> int:
    """``repro.models.common._fan_in``: every axis but the last (the output
    axis) of a ≥2-D weight."""
    return math.prod(shape[:-1]) if len(shape) > 1 else shape[0]


def tree_map(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """Map ``fn(path, leaf)`` over a tree of dicts and tuples, keeping its
    structure; ``path`` is the tuple of keys and indices down to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and not isinstance(tree, ParamDef):
        return tuple(tree_map(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def tree_leaves_with_path(tree: Any, path: str = "") -> Iterator[tuple[str, Any]]:
    """(path, leaf) of a tree of dicts, tuples (NamedTuples too) and lists
    in ``jax.tree_util``'s flatten order: dict keys sorted, sequences in
    order, ``None`` no leaf; each path as ``jax.tree_util.keystr`` writes
    it, e.g. ``['layers'][0]['wq']``. The order in which checkpoints number
    their leaves, the optimizer walks them and fingerprints hash them."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, f"{path}[{i}]")
    else:
        yield path, tree


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in ``tree_leaves_with_path``'s order."""
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_unflatten(like: Any, leaves: list) -> Any:
    """``like``'s structure (NamedTuple types and dict key order kept) with
    ``leaves`` in ``tree_leaves`` order in place of its own."""
    it = iter(leaves)

    def build(t: Any) -> Any:
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(v) for v in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def stack_defs(defs: Any, n: int) -> Any:
    """The tree with a leading axis of ``n`` on every tensor (the stacked
    ``layers`` axis, which ``repro`` scans)."""
    return tree_map(lambda _, d: d._replace(shape=(n,) + tuple(d.shape), axes=("layers",) + tuple(d.axes)),
                    defs)


def init_params(defs: Any, generator: torch.Generator, *, dtype: torch.dtype = torch.float32,
                device="cuda") -> Any:
    """Draw a ``ParamDef`` tree's tensors from ``generator`` in the tree's
    order, on the generator's device, then place them on ``device`` (a no-op
    when they are there already). The numbers differ from ``repro``'s; the
    rule is the same. The tensors never require grad."""

    def draw(_, d: ParamDef) -> torch.Tensor:
        if d.init in ("zeros", "ones"):
            fill = torch.zeros if d.init == "zeros" else torch.ones
            return fill(d.shape, dtype=dtype, device=device)
        if d.init == "embed":
            std = d.scale or 1.0
        else:
            std = d.scale if d.scale is not None else 1.0 / math.sqrt(max(fan_in(d.shape), 1))
        w = torch.randn(d.shape, generator=generator, device=generator.device)
        return w.mul_(std).to(device=device, dtype=dtype)

    return tree_map(draw, defs)


def abstract_params(defs: Any, *, dtype: torch.dtype = torch.float32) -> Any:
    """The tree of ``meta`` tensors of a ``ParamDef`` tree (``repro``'s
    ``ShapeDtypeStruct`` tree): each definition's shape in ``dtype``, no
    storage allocated — what the dry run counts with."""
    return tree_map(lambda _, d: torch.empty(d.shape, dtype=dtype, device="meta"), defs)


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """A ``repro`` parameter tree (dicts and tuples of arrays) -> the same
    tree of tensors on ``device``; the layouts are shared, so nothing moves:
    every leaf is carried, an encoder-decoder's ``encoder``, ``norm_x`` and
    ``cross`` and a stub frontend's ``frontend_proj`` included."""
    return tree_map(lambda _, a: torch.from_numpy(np.array(a)).to(device), tree)
