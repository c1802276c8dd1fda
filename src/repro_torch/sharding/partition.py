"""Logical-axis -> partition-spec rules: ``repro.sharding.partition`` in PyTorch.

Every parameter carries logical axis names (``ParamDef.axes``); a
``MeshRules`` table maps each logical axis to an ordered preference list of
mesh axes. Spec construction walks the tensor's axes, assigning the first
mesh axis that (a) is still unused by this tensor and (b) divides the
dimension size. Anything else stays replicated — so one rule table serves
every architecture (GQA with 4 KV heads simply leaves ``kv_heads``
replicated on a 16-way model axis).

Two standard tables:
  DEFAULT_RULES — TP on 'model', batch on ('pod','data'); params replicated
                  across 'data' (pure DP — small/medium configs).
  FSDP_RULES    — adds ZeRO-3: the 'embed' axis of every weight is sharded on
                  'data' too, so optimizer state scales with 1/(data*model).

A spec is the port's own ``PartitionSpec``: a tuple with one entry per
tensor dimension, each a mesh axis name, a tuple of them, or None
(replicated). ``to_placements`` turns one into DTensor placements over a
``DeviceMesh``. Every function reads a mesh through ``mesh_axes`` only, so a
``DeviceMesh`` and a shape-only stand-in (an object with ``axis_names`` and
``devices.shape``, as ``repro``'s tests' ``FakeMesh``) serve alike.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Optional, Sequence

from repro_torch.models.common import tree_map


class PartitionSpec(tuple):
    """One entry per tensor dimension: a mesh axis name, a tuple of them, or
    None. ``PartitionSpec("data", None)`` shards dim 0 on 'data'."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axes(mesh: Any) -> dict[str, int]:
    """The mesh's axis names and sizes, in order: a ``DeviceMesh``'s
    ``mesh_dim_names`` over its shape, or a stand-in's ``axis_names`` over
    ``devices.shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.mesh.shape)))
    return dict(zip(mesh.axis_names, tuple(mesh.devices.shape)))


@dataclass(frozen=True)
class MeshRules:
    """Ordered logical-axis -> candidate-mesh-axes mapping."""

    rules: dict[str, tuple[str, ...]]
    # logical axes whose mesh assignment may be a *tuple* of axes (megasharding)
    batch_axes: tuple[str, ...] = ("pod", "data")

    def candidates(self, logical: Optional[str]) -> tuple[str, ...]:
        if logical is None:
            return ()
        return self.rules.get(logical, ())


# TP everything wide on 'model'; experts EP on 'model'; batch on ('pod','data').
DEFAULT_RULES = MeshRules(
    rules={
        "vocab": ("model",),
        "mlp": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),  # falls back to replicated when not divisible
        "experts": ("model",),
        "inner": ("model",),
        "ssm_heads": ("model",),
        "frontend": (),
        "embed": (),
        "head_dim": (),
        "layers": (),
        "batch": ("pod", "data"),
        "seq": (),
        "kv_seq": (),
    }
)

# ZeRO-3 / FSDP: additionally shard the 'embed' (contracting) axis on 'data'.
FSDP_RULES = replace(DEFAULT_RULES, rules={**DEFAULT_RULES.rules, "embed": ("data",), "layers": ()})

# Sequence-parallel activations (long-context): shard seq on 'data'.
SP_RULES = replace(DEFAULT_RULES, rules={**DEFAULT_RULES.rules, "seq": ("data",), "kv_seq": ("data",)})


def logical_to_spec(axes: Sequence[Optional[str]], shape: Sequence[int], mesh: Any,
                    rules: MeshRules) -> PartitionSpec:
    """Greedy assignment: first fitting unused mesh axis per tensor dim."""
    used: set[str] = set()
    out: list[Any] = []
    sizes = mesh_axes(mesh)
    for logical, dim in zip(axes, shape):
        # batch axis spans ALL its mesh axes jointly (e.g. ('pod','data'))
        if logical == "batch":
            multi = [a for a in rules.batch_axes if a in sizes and a not in used]
            prod = math.prod(sizes[a] for a in multi) if multi else 1
            if multi and dim % prod == 0 and dim >= prod:
                used.update(multi)
                out.append(tuple(multi) if len(multi) > 1 else multi[0])
            else:
                out.append(None)
            continue
        assigned = None
        for cand in rules.candidates(logical):
            if cand in used or cand not in sizes:
                continue
            if dim % sizes[cand] == 0 and dim >= sizes[cand]:
                assigned = cand
                used.add(cand)
                break
        out.append(assigned)
    return P(*out)


def param_specs(defs: Any, mesh: Any, rules: MeshRules = DEFAULT_RULES) -> Any:
    """ParamDef tree -> PartitionSpec tree."""
    return tree_map(lambda _, d: logical_to_spec(d.axes, d.shape, mesh, rules), defs)


def to_placements(spec: PartitionSpec, mesh: Any) -> tuple:
    """DTensor placements of ``spec`` over ``mesh``: per mesh dimension,
    ``Shard(i)`` for the tensor dimension i the spec names it at, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard

    where: dict[str, int] = {}
    for i, entry in enumerate(spec):
        for name in entry if isinstance(entry, tuple) else (entry,):
            if name is not None:
                where[name] = i
    return tuple(Shard(where[a]) if a in where else Replicate() for a in mesh_axes(mesh))


def batch_spec(mesh: Any, rules: MeshRules = DEFAULT_RULES) -> PartitionSpec:
    """Spec for a (global_batch, ...) input: batch over ('pod','data')."""
    axes = [a for a in rules.batch_axes if a in mesh_axes(mesh)]
    if not axes:
        return P(None)
    return P(tuple(axes) if len(axes) > 1 else axes[0])


def _batch_axis(mesh: Any, rules: MeshRules):
    b = batch_spec(mesh, rules)
    return b[0] if len(b) else None


def activation_specs(mesh: Any, rules: MeshRules = DEFAULT_RULES, *,
                     seq_sharded: bool = False) -> dict[str, PartitionSpec]:
    """Named activation specs consumed by the step factories."""
    bax = _batch_axis(mesh, rules)
    names = mesh_axes(mesh)
    seq = None
    if seq_sharded:
        # long-context: batch=1 -> put the sequence on the data axis instead
        seq_axes = [a for a in rules.batch_axes if a in names and a != "pod"]
        seq = seq_axes[0] if seq_axes else None
    model = "model" if "model" in names else None
    return {
        "batch": P(bax),
        "tokens": P(bax, seq),
        "hidden": P(bax, seq, model),
        "kv_cache": P(None, bax, seq, model, None),
    }


def explain_specs(mesh: Any, rules: MeshRules = DEFAULT_RULES) -> tuple:
    """Specs of the ExplainEngine's bucketed stage-2 inputs, the (embeds,
    baseline, aux, mask) argument tuple: every input's leading (bucket
    batch) dim on the mesh's data axes, feature dims replicated — the
    per-position gradient is local to its position."""
    bax = _batch_axis(mesh, rules)
    return (
        P(bax, None, None),  # embeds (B, S, D)
        P(bax, None, None),  # baseline (B, S, D)
        {"target": P(bax), "pos": P(bax)},  # aux (B,)
        P(bax, None),  # mask (B, S)
    )


def dp_size(mesh: Any, rules: MeshRules = DEFAULT_RULES) -> int:
    """Total data-parallel extent of a mesh under ``rules.batch_axes``: the
    divisor every bucket batch is padded up to before the engine can shard
    it (``batching.plan_buckets(batch_multiple=...)``). 1 for ``mesh=None``."""
    if mesh is None:
        return 1
    sizes = mesh_axes(mesh)
    return math.prod(sizes[a] for a in rules.batch_axes if a in sizes)


def mesh_cache_key(mesh: Any) -> tuple:
    """Hashable mesh fingerprint for callable-cache keys: the ordered
    (axis, size) pairs, ``()`` for ``mesh=None``. ``ExplainEngine`` folds it
    into every key, so single-device and sharded entries coexist."""
    if mesh is None:
        return ()
    return tuple(mesh_axes(mesh).items())


def explain_shardings(mesh: Any, *, batch: int, rules: MeshRules = DEFAULT_RULES) -> Optional[tuple]:
    """Placements of ``explain_specs``, or None when the bucket's batch does
    not divide the mesh's data axes (or there is no data parallelism) — the
    fallback the engine serves replicated and counts in
    ``EngineStats.mesh_fallbacks``."""
    dp = dp_size(mesh, rules)
    if dp <= 1 or batch % dp != 0:
        return None
    return _spec_map(lambda s: to_placements(s, mesh), explain_specs(mesh, rules))


def _spec_map(fn, tree):
    if isinstance(tree, PartitionSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _spec_map(fn, v) for k, v in tree.items()}
    return type(tree)(_spec_map(fn, v) for v in tree)


def _leaves(tree: Any) -> list:
    """Tensor-like leaves (anything with ``shape``) of nested dicts, lists
    and tuples (NamedTuples too), in order; None is no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map_leaves(fn, tree: Any) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(fn, v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_leaves(fn, v) for v in tree)
    return fn(tree)


def explain_arg_shardings(mesh: Any, args: Any, rules: MeshRules = DEFAULT_RULES) -> Optional[Any]:
    """Per-leaf layout of an arbitrary engine argument tree: a leaf whose
    leading dim is the (dp-divisible) bucket batch shards on the data axes,
    everything else — scalars, shared (m,) schedules — replicates. The
    batch is the largest leading dim of the tree's ≥1-D leaves. Returns
    None when the mesh has no data parallelism or that batch does not
    divide it (the fallback of ``explain_shardings``)."""
    dp = dp_size(mesh, rules)
    if dp <= 1:
        return None
    batch = max((x.shape[0] for x in _leaves(args) if len(getattr(x, "shape", ())) >= 1), default=0)
    if batch == 0 or batch % dp != 0:
        return None
    bax = _batch_axis(mesh, rules)

    def one(x):
        nd = len(getattr(x, "shape", ()))
        if nd >= 1 and x.shape[0] == batch:
            return P(bax, *([None] * (nd - 1)))
        return P()

    return _map_leaves(one, args)


def explain_reduce_specs(mesh: Any, rules: MeshRules = DEFAULT_RULES) -> dict:
    """The layout of the engine's per-row reductions. δ and IDGI's inner
    products contract over feature axes only, which stay replicated, so
    each rank reduces its own rows in the unsharded order and the adaptive
    ladder takes the same decisions on any mesh:

      folded      — a (B·c, *F) stage-2 gradient block: rows on data axes.
      row_scalar  — a (B,) per-row reduction output (δ, ⟨g,g⟩, ⟨g,x−x′⟩).
    """
    bax = _batch_axis(mesh, rules)
    return {"folded": P(bax, None), "row_scalar": P(bax)}


def spec_for_batch_tree(batch: Any, mesh: Any, rules: MeshRules = DEFAULT_RULES, *,
                        seq_sharded: bool = False) -> Any:
    """PartitionSpec tree matching a batch dict: dim0 = batch, rest replicated.

    When ``seq_sharded`` (long-context decode with batch=1), dim1 of rank>=2
    inputs is sharded on 'data' instead of the batch dim.
    """
    bb = _batch_axis(mesh, rules)
    sizes = mesh_axes(mesh)
    nb = math.prod(sizes[a] for a in (bb if isinstance(bb, tuple) else (bb,))) if bb else 1

    def one(x):
        ndim = len(x.shape)
        if ndim == 0:
            return P()
        if seq_sharded and ndim >= 2 and "data" in sizes and x.shape[1] % sizes["data"] == 0:
            return P(None, "data", *([None] * (ndim - 2)))
        if x.shape[0] % max(nb, 1) == 0 and x.shape[0] >= nb:
            return P(bb, *([None] * (ndim - 1)))
        return P(*([None] * ndim))

    return _map_leaves(one, batch)


__all__ = [
    "DEFAULT_RULES", "FSDP_RULES", "MeshRules", "P", "PartitionSpec", "SP_RULES",
    "activation_specs", "batch_spec", "dp_size", "explain_arg_shardings", "explain_reduce_specs",
    "explain_shardings", "explain_specs", "logical_to_spec", "mesh_axes", "mesh_cache_key",
    "param_specs", "spec_for_batch_tree", "to_placements",
]
