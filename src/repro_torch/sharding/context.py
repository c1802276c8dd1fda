"""Activation sharding constraints: ``repro.sharding.context`` over DTensor.

Why this exists: with FSDP-sharded weights and batch-sharded activations a
partitioner may legally choose to replicate activations and all-reduce
partial sums instead of all-gathering weights. ``repro`` pins activations
with ``with_sharding_constraint``; under DTensor an op's output placement
is chosen by its sharding strategy, and ``constrain`` pins it by
redistributing to the named layout.

Model code is mesh-agnostic: it calls ``constrain(x, "batch", "seq",
"model")`` with LOGICAL names; the active ``ActivationPolicy`` (installed by
the dry run's cells through ``activation_sharding(mesh, ...)``) maps them to
mesh axes and checks divisibility, as ``repro``'s does. With no policy
installed, or on a plain tensor (one device, the serving and training
paths), it returns ``x`` unchanged. So do the two helpers that make
explicit what XLA decides for ``repro``: ``gathered`` (a layer's FSDP
shards gathered before use) and ``per_head`` (attention on each rank's
own rows and heads).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.models.common import tree_map
from repro_torch.sharding.partition import P, mesh_axes, to_placements

_POLICY: contextvars.ContextVar[Optional["ActivationPolicy"]] = contextvars.ContextVar(
    "activation_policy", default=None
)


@dataclass(frozen=True)
class ActivationPolicy:
    mapping: dict  # logical name -> tuple of mesh axis names
    sizes: dict  # mesh axis name -> size


def make_policy(mesh: Any, *, seq_sharded: bool = False) -> ActivationPolicy:
    sizes = mesh_axes(mesh)
    batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
    return ActivationPolicy(
        mapping={
            "batch": () if seq_sharded else batch_axes,
            "seq": (("data",) if "data" in sizes else ()) if seq_sharded else (),
            "model": ("model",) if "model" in sizes else (),
        },
        sizes=sizes,
    )


@contextlib.contextmanager
def activation_sharding(mesh: Any, *, seq_sharded: bool = False):
    token = _POLICY.set(make_policy(mesh, seq_sharded=seq_sharded))
    try:
        yield
    finally:
        _POLICY.reset(token)


def activation_spec(pol: ActivationPolicy, shape: tuple, logical: tuple) -> Optional[P]:
    """``repro``'s spec for a tensor of ``shape`` under ``pol``: each dim
    takes its logical name's mesh axes not used by an earlier dim, or None
    when they do not divide it; None when no dim is sharded."""
    if len(logical) != len(shape):
        raise ValueError(f"constrain: {len(logical)} names {logical} for a {len(shape)}-d tensor {tuple(shape)}")
    used: set[str] = set()
    spec = []
    for dim, name in zip(shape, logical):
        axes = tuple(a for a in pol.mapping.get(name, ()) if a in pol.sizes and a not in used)
        prod = math.prod(pol.sizes[a] for a in axes)
        if axes and dim % prod == 0 and dim >= prod:
            used.update(axes)
            spec.append(axes if len(axes) > 1 else axes[0])
        else:
            spec.append(None)
    return P(*spec) if used else None


def constrain(x: torch.Tensor, *logical: Optional[str], sizes: Optional[tuple] = None,
              force: bool = False) -> torch.Tensor:
    """Pin ``x``'s layout by logical dim names: a DTensor under an active
    policy is redistributed to the spec (``activation_spec``); anything
    else is returned unchanged.

    ``logical`` has one entry per dim: "batch" / "seq" / "model" / None.
    Indivisible dims fall back to replicated (never an error). ``sizes``
    (default ``x.shape``) are the sizes divisibility is judged on: a
    flattened (heads · head_dim) axis is judged by its heads, since a head
    split across ranks could not be unflattened. ``force`` pins a spec that
    shards nothing too (``repro`` leaves such a tensor as it is): x is then
    replicated, for a small tensor whose op DTensor cannot run sharded.
    """
    pol = _POLICY.get()
    if pol is None:
        return x
    spec = activation_spec(pol, tuple(x.shape if sizes is None else sizes), logical)
    if spec is None and force:
        spec = P(*([None] * len(logical)))
    from torch.distributed.tensor import DTensor

    if spec is None or not isinstance(x, DTensor):
        return x
    return _Pin.apply(x, to_placements(spec, x.device_mesh))


def gathered(tree: Any) -> Any:
    """A layer's parameters as it computes with them: under a policy, each
    DTensor's shards over the batch axes (FSDP's "embed" sharding) gathered,
    its tensor-parallel sharding kept; the backward reduce-scatters the
    gradients to the stored layout (ZeRO-3). ``repro`` leaves these gathers
    to XLA; DTensor would otherwise pick per matrix product between
    gathering the weight and gathering the activations by their sizes, so
    a rank's work would change with the microbatch. Plain tensors, and
    every tensor without a policy, are returned as they are."""
    pol = _POLICY.get()
    if pol is None:
        return tree
    from torch.distributed.tensor import DTensor, Replicate

    def one(_, x):
        if not isinstance(x, DTensor):
            return x
        names = x.device_mesh.mesh_dim_names
        pl = tuple(Replicate() if n in ("pod", "data") else p for n, p in zip(names, x.placements))
        return x if pl == tuple(x.placements) else x.redistribute(x.device_mesh, pl)

    return tree_map(one, tree)


def per_head(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``fn(q, k, v)``, an attention over (B, S, H, D) tensors (q's heads a
    multiple of k's and v's) that is independent across batch rows and
    query heads, run on each rank's local shards when ``q`` is a DTensor
    under a policy that does not shard the sequence; anything else runs as
    it is. q, k and v are pinned as ``qkv`` pins them (KV heads on the
    model axis when they divide it). Where the query heads are split and
    the KV heads are not, a rank takes the KV head of each of its query
    heads (``repro``'s expand_kv, restricted to its heads). The result
    carries q's placements. (DTensor cannot flatten a sharded batch axis
    and a sharded head axis into the one batch axis of a matrix product:
    without this it gathers the heads, and every rank attends with all.)"""
    from torch.distributed.tensor import DTensor, Shard

    pol = _POLICY.get()
    if pol is None or not isinstance(q, DTensor) or pol.mapping["seq"]:
        return fn(q, k, v)
    names = ("batch", "seq", "model", None)
    q, k, v = (constrain(t, *names) for t in (q, k, v))
    ql, kl, vl = q.to_local(), k.to_local(), v.to_local()
    n, NQ, NKV = ql.shape[2], q.shape[2], k.shape[2]
    if n != NQ and kl.shape[2] == NKV:  # query heads split, KV heads whole
        dim = next(i for i, p in enumerate(q.placements) if p == Shard(2))
        first = q.device_mesh.get_local_rank(dim) * n
        heads = torch.arange(first, first + n, device=kl.device) // (NQ // NKV)
        kl, vl = kl.index_select(2, heads), vl.index_select(2, heads)
    return DTensor.from_local(fn(ql, kl, vl), q.device_mesh, q.placements, run_check=False)


class _Pin(torch.autograd.Function):
    """``x.redistribute`` to ``placements``, whose gradient is redistributed
    to the same placements: the transpose of ``with_sharding_constraint``
    constrains the cotangent alike (``redistribute``'s own backward would
    return it to x's placements)."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements), None


__all__ = ["ActivationPolicy", "activation_sharding", "activation_spec", "constrain", "gathered", "make_policy",
           "per_head"]
