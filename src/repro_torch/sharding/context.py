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

Where an op has more than one way to run sharded, DTensor's choice moves
with the torch version, and so would a cell's counts. The model code pins
such a site, or computes it on the local shards itself, with explicit
collectives at its edges (the MoE routing, the embedding lookup, the
vocab-parallel loss). The helpers for those: ``replicate`` (a tensor made
whole on every rank), ``layout`` (the policy's placements for a shape),
``block`` (this rank's slice of a sharded dim), ``from_local`` and
``partial`` (a local result wrapped as a DTensor, pending a sum where the
ranks along a mesh dim hold parts of it).
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
    Without ``force`` such an x keeps its shards, but a pending sum
    (``Partial``) is reduced: where it is reduced would otherwise be left to
    DTensor's version.
    """
    pol = _POLICY.get()
    from torch.distributed.tensor import DTensor, Replicate

    if pol is None or not isinstance(x, DTensor):
        return x
    spec = activation_spec(pol, tuple(x.shape if sizes is None else sizes), logical)
    if spec is None and force:
        spec = P(*([None] * len(logical)))
    if spec is not None:
        return _Pin.apply(x, to_placements(spec, x.device_mesh))
    if any(p.is_partial() for p in x.placements):  # a pinned tensor is never left pending a sum
        return _Pin.apply(x, tuple(Replicate() if p.is_partial() else p for p in x.placements))
    return x


def seq_sharded(x: torch.Tensor) -> bool:
    """Whether ``x`` is a DTensor sharded on its dim 1, the sequence of the
    long-context cells' caches, under a policy that shards the sequence."""
    from torch.distributed.tensor import DTensor, Shard

    pol = _POLICY.get()
    return (pol is not None and bool(pol.mapping["seq"]) and isinstance(x, DTensor)
            and any(p == Shard(1) for p in x.placements))


def replicate(x: torch.Tensor) -> torch.Tensor:
    """``x`` whole on every rank: a DTensor is redistributed to
    ``Replicate()`` on every mesh dim (its gradient alike, as ``constrain``
    does), with or without a policy; anything else is returned as it is."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(x, DTensor):
        return x
    pl = (Replicate(),) * x.device_mesh.ndim
    return x if tuple(x.placements) == pl else _Pin.apply(x, pl)


def layout(mesh: Any, shape: tuple, *logical: Optional[str]) -> tuple:
    """The DTensor placements ``constrain`` would pin a tensor of ``shape``
    to under the active policy (replicated where it shards nothing, or with
    no policy)."""
    from torch.distributed.tensor import Replicate

    pol = _POLICY.get()
    spec = None if pol is None else activation_spec(pol, tuple(shape), logical)
    return (Replicate(),) * mesh.ndim if spec is None else to_placements(spec, mesh)


def block(shape: tuple, mesh: Any, placements: tuple, dim: int) -> tuple[int, int]:
    """(offset, length) of this rank's slice of dim ``dim`` of a tensor of
    global ``shape`` under ``placements``."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    local, offset = compute_local_shape_and_global_offset(tuple(shape), mesh, tuple(placements))
    return offset[dim], local[dim]


def partial(placements: tuple, over: tuple) -> tuple:
    """``placements`` with ``Partial()`` (a pending sum) on every mesh dim
    where ``over`` shards a dim and ``placements`` replicate: a local result
    that holds only the terms of this rank's slice of ``over``'s tensor."""
    from torch.distributed.tensor import Partial

    return tuple(Partial() if o.is_shard() and p.is_replicate() else p for p, o in zip(placements, over))


def combine(t: torch.Tensor, mesh: Any, dims: tuple, op: str = "sum") -> torch.Tensor:
    """This rank's part ``t`` (a plain tensor) combined with the other
    ranks' along the mesh dims ``dims``: their sum (an all-reduce) or their
    maximum (an all-gather of the parts); ``t`` itself when ``dims`` is
    empty. The parts may differ along every other mesh dim."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    if not dims:
        return t
    if op == "max":
        pl = tuple(Shard(0) if i in dims else Replicate() for i in range(mesh.ndim))
        ways = math.prod(mesh.size(i) for i in dims)
        return replicate(from_local(t[None], mesh, pl, (ways, *t.shape))).to_local().amax(0)
    pl = tuple(Partial() if i in dims else Replicate() for i in range(mesh.ndim))
    return replicate(from_local(t, mesh, pl, t.shape)).to_local()


def from_local(local: torch.Tensor, mesh: Any, placements: tuple, shape: tuple) -> torch.Tensor:
    """``local`` (this rank's part) as a DTensor of global ``shape``."""
    from torch.distributed.tensor import DTensor

    shape = tuple(shape)
    stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
    return DTensor.from_local(local, mesh, tuple(placements), run_check=False, shape=torch.Size(shape),
                              stride=stride)


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


def on_shards(fn, x: torch.Tensor, *rest: torch.Tensor) -> torch.Tensor:
    """``fn(x, *rest)`` for a function that is independent across the dims
    ``x``'s mesh shards (batch rows, heads) and keeps their sizes: on a
    DTensor it runs on each rank's local shards (``rest`` laid out as x on
    those dims, or whole there: their gradients are then pending the sum
    over x's shards) and its result (or each of a tuple of results) carries
    x's placements; anything else runs as it is."""
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return fn(x, *rest)
    xpl = tuple(x.placements)
    out = fn(x.to_local(), *(t.to_local(grad_placements=partial(tuple(t.placements), xpl)) for t in rest))

    def wrap(t):
        shape = list(t.shape)
        for p, n in zip(xpl, x.device_mesh.mesh.shape):
            if p.is_shard():
                shape[p.dim] *= int(n)
        return from_local(t, x.device_mesh, xpl, tuple(shape))

    return tuple(wrap(t) for t in out) if isinstance(out, tuple) else wrap(out)


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


__all__ = ["ActivationPolicy", "activation_sharding", "activation_spec", "block", "combine", "constrain", "from_local",
           "gathered", "layout", "make_policy", "on_shards", "partial", "per_head", "replicate", "seq_sharded"]
