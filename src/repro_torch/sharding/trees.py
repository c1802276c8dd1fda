"""Partition specs for runtime trees (TrainState, KV caches) by leaf path:
``repro.sharding.trees`` in PyTorch.

Cache/state leaf names are stable model contracts ("k", "v", "xk", "xv",
"state", "conv", "len"), so specs pattern-match on the path — more robust
than rank heuristics and independent of which arch produced the tree.
"""
from __future__ import annotations

import math
from typing import Any

from repro_torch.models.common import tree_map
from repro_torch.sharding.partition import (DEFAULT_RULES, MeshRules, P, PartitionSpec, _batch_axis, mesh_axes,
                                            param_specs, to_placements)


def train_state_specs(defs: Any, mesh: Any, rules: MeshRules, state_like: Any) -> Any:
    """Specs for TrainState(params, OptState(step, m, v), err)."""
    pspecs = param_specs(defs, mesh, rules)
    opt = type(state_like.opt)(step=P(), m=pspecs, v=pspecs)
    err = pspecs if state_like.err is not None else None
    return type(state_like)(params=pspecs, opt=opt, err=err)


def _divisible(dim: int, sizes: dict, axes) -> bool:
    """``dim`` splits evenly over the mesh axis (or tuple of axes) ``axes``."""
    names = axes if isinstance(axes, tuple) else (axes,)
    if any(a not in sizes for a in names):
        return False
    prod = math.prod(sizes[a] for a in names)
    return dim % prod == 0 and dim >= prod


def cache_specs(cache: Any, mesh: Any, rules: MeshRules = DEFAULT_RULES, *,
                seq_sharded: bool = False) -> Any:
    """Specs for a decode cache tree (``lm.init_cache``'s structure).

    KV leaves: (periods?, B, S, KH, HD) — batch on ('pod','data'), KH on
    'model' when divisible; long-context (seq_sharded) moves S onto 'data'.
    SSM leaves: state (periods?, B, H, P, N) / conv (periods?, B, W, di) —
    H / di on 'model'. The leading periods axis is there when the leaf sits
    under ``cache["layers"]``.
    """
    bax = _batch_axis(mesh, rules)
    sizes = mesh_axes(mesh)

    def leaf_spec(path, x) -> PartitionSpec:
        name = path[-1]
        nd = len(x.shape)
        if name == "len":
            return P()
        off = 1 if "layers" in path else 0
        spec: list[Any] = [None] * nd
        if name in ("k", "v", "xk", "xv"):
            B, S, KH = x.shape[off], x.shape[off + 1], x.shape[off + 2]
            if bax is not None and not seq_sharded and _divisible(B, sizes, bax):
                spec[off] = bax
            if seq_sharded and _divisible(S, sizes, "data"):
                spec[off + 1] = "data"
            if _divisible(KH, sizes, "model"):
                spec[off + 2] = "model"
        elif name == "state":
            B, H = x.shape[off], x.shape[off + 1]
            if bax is not None and _divisible(B, sizes, bax):
                spec[off] = bax
            if _divisible(H, sizes, "model"):
                spec[off + 1] = "model"
        elif name == "conv":
            B, di = x.shape[off], x.shape[-1]
            if bax is not None and _divisible(B, sizes, bax):
                spec[off] = bax
            if _divisible(di, sizes, "model"):
                spec[-1] = "model"
        return P(*spec)

    return tree_map(leaf_spec, cache)


def to_shardings(specs: Any, mesh: Any) -> Any:
    """A spec tree's DTensor placements over ``mesh`` (``to_placements`` per
    spec; NamedTuples such as a TrainState keep their type)."""
    if isinstance(specs, PartitionSpec):
        return to_placements(specs, mesh)
    if specs is None:
        return None
    if isinstance(specs, dict):
        return {k: to_shardings(v, mesh) for k, v in specs.items()}
    if hasattr(specs, "_fields"):
        return type(specs)(*(to_shardings(v, mesh) for v in specs))
    return type(specs)(to_shardings(v, mesh) for v in specs)


__all__ = ["cache_specs", "to_shardings", "train_state_specs"]
