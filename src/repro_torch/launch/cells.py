"""Dry-run cells: (arch × shape × mesh) -> a step and its abstract
arguments, ``repro.launch.cells`` in the port.

One *cell* is the step function, its arguments as ``meta`` tensors of the
global shapes, and each argument's DTensor placements on a mesh:

    train_*    -> train_step(state, batch)      [FSDP+TP rules]
    prefill_*  -> prefill_step(params, batch)   [FSDP+TP rules]
    decode_*   -> serve_step(params, cache, tok)[FSDP+TP; long_*: +SP]

KV-head TP note: GQA configs with kv_heads < model-axis size get their decode
cache expanded to ``kv_slots = model_size`` head slots so the cache head
axis shards on 'model' (``choose_kv_slots``).

``count_cell`` is the counterpart of ``repro``'s ``lower_cell`` and
``compile``: there is no program to lower, so it runs the step once under
``roofline.op_counts.OpCounter``. On a mesh of more than one rank every
argument becomes a DTensor of ``meta`` local shards with its placements,
and the step runs under the activation policy (``sharding.context``), so
the counts are one rank's. On a 1×1 mesh (``ShapeMesh()``) the arguments
stay plain tensors and no process group is needed: then they may also be
real tensors on a card (``count_cell(cell, args)``), which is how the
meta count is held to the card's. ``repro``'s ``out_shardings`` and
``donate_argnums`` have no counterpart: the port's steps update their
state and cache in place, and DTensor outputs keep the placements their
ops give them.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig, shape_applicable
from repro_torch.models import lm
from repro_torch.models.common import tree_map
from repro_torch.models.registry import Model, input_specs
from repro_torch.roofline.analyze import collective_bytes
from repro_torch.roofline.op_counts import OpCounter, matmul_flops_summary, op_bytes_by_op
from repro_torch.serve.engine import make_serve_step
from repro_torch.sharding import (FSDP_RULES, MeshRules, cache_specs, mesh_axes, param_specs, spec_for_batch_tree,
                                  to_shardings, train_state_specs)
from repro_torch.sharding.context import activation_sharding
from repro_torch.train.step import TrainConfig, abstract_train_state, make_train_step


class ShapeMesh:
    """A mesh by its axis names and sizes only, with no process group: what
    the sharding rules read (``sharding.mesh_axes``). The 1×1 mesh of the
    card's cells."""

    def __init__(self, shape: tuple = (1, 1), axis_names: tuple = ("data", "model")):
        self.axis_names = tuple(axis_names)
        self.devices = SimpleNamespace(shape=tuple(shape), size=math.prod(shape))

    def size(self) -> int:
        """The number of ranks, as ``DeviceMesh.size()``."""
        return self.devices.size


@dataclass
class Cell:
    name: str
    fn: Callable
    args: tuple  # trees of meta tensors at the global shapes
    in_shardings: tuple  # per argument, a tree of DTensor placements
    mesh: Any = None  # a DeviceMesh, or a ShapeMesh
    seq_sharded: bool = False


def _mesh_size(mesh: Any, axis: str) -> int:
    return mesh_axes(mesh).get(axis, 1)


def choose_kv_slots(cfg: ArchConfig, mesh: Any, *, seq_sharded: bool) -> int:
    """Expand KV heads to the model-axis size for TP-sharded caches."""
    if seq_sharded or not cfg.num_kv_heads:
        return 0
    model = _mesh_size(mesh, "model")
    if 0 < cfg.num_kv_heads < model and model % cfg.num_kv_heads == 0:
        return model
    return 0


def build_train_cell(
    cfg: ArchConfig,
    shape: ShapeConfig,
    mesh: Any,
    *,
    rules: MeshRules = FSDP_RULES,
    microbatches: int = 8,
    remat: bool = True,
    grad_compression: bool = False,
) -> Cell:
    tcfg = TrainConfig(microbatches=microbatches, remat=remat, grad_compression=grad_compression)
    state = abstract_train_state(cfg, tcfg)
    batch = input_specs(cfg, shape)
    state_specs = train_state_specs(lm.param_defs(cfg), mesh, rules, state)
    return Cell(
        name=f"{cfg.name}:{shape.name}",
        fn=make_train_step(cfg, tcfg),
        args=(state, batch),
        in_shardings=(to_shardings(state_specs, mesh), to_shardings(spec_for_batch_tree(batch, mesh, rules), mesh)),
        mesh=mesh,
    )


def _cast_abstract(params: Any, dtype: str) -> Any:
    """The meta tree with floating leaves re-typed (the serving dtype)."""
    dt = getattr(torch, dtype)
    return tree_map(lambda _, p: torch.empty(p.shape, dtype=dt, device="meta") if p.is_floating_point() else p,
                    params)


def build_prefill_cell(
    cfg: ArchConfig,
    shape: ShapeConfig,
    mesh: Any,
    *,
    rules: MeshRules = FSDP_RULES,
    serve_dtype: str = "bfloat16",  # production serving default
) -> Cell:
    """The prefill step, whose new cache is made inside the step as the
    rules lay it out (``repro``'s cache ``out_shardings``): each rank's
    zeros of its shard."""
    kv_slots = choose_kv_slots(cfg, mesh, seq_sharded=False)
    batch = input_specs(cfg, shape)
    params = _cast_abstract(lm.abstract_params(cfg), serve_dtype)
    cache = lm.init_cache(cfg, shape.global_batch, shape.seq_len, device="meta", kv_slots=kv_slots)
    cache_placements = to_shardings(cache_specs(cache, mesh, rules), mesh)
    model = Model(cfg)

    def prefill_step(params: Any, batch: dict) -> tuple[torch.Tensor, dict]:
        tokens = batch["tokens"]
        empty = _distribute(cache, lambda shp, dt: torch.zeros(shp, dtype=dt, device=tokens.device),
                            cache_placements, getattr(tokens, "device_mesh", None))
        return model.prefill(params, batch, shape.seq_len, kv_slots=kv_slots, cache=empty)

    return Cell(
        name=f"{cfg.name}:{shape.name}",
        fn=prefill_step,
        args=(params, batch),
        in_shardings=(to_shardings(param_specs(lm.param_defs(cfg), mesh, rules), mesh),
                      to_shardings(spec_for_batch_tree(batch, mesh, rules), mesh)),
        mesh=mesh,
    )


def build_decode_cell(
    cfg: ArchConfig,
    shape: ShapeConfig,
    mesh: Any,
    *,
    rules: MeshRules = FSDP_RULES,
    serve_dtype: str = "bfloat16",  # production serving default
) -> Cell:
    seq_sharded = shape.global_batch < _mesh_size(mesh, "data")  # long_500k
    kv_slots = choose_kv_slots(cfg, mesh, seq_sharded=seq_sharded)
    spec = input_specs(cfg, shape, kv_slots=kv_slots)
    token, cache = spec["token"], spec["cache"]
    params = _cast_abstract(lm.abstract_params(cfg), serve_dtype)
    return Cell(
        name=f"{cfg.name}:{shape.name}",
        fn=make_serve_step(cfg),
        args=(params, cache, token),
        in_shardings=(
            to_shardings(param_specs(lm.param_defs(cfg), mesh, rules), mesh),
            to_shardings(cache_specs(cache, mesh, rules, seq_sharded=seq_sharded), mesh),
            to_shardings(spec_for_batch_tree(token, mesh, rules), mesh),
        ),
        mesh=mesh,
        seq_sharded=seq_sharded,
    )


def build_cell(cfg: ArchConfig, shape: ShapeConfig, mesh: Any, **kw) -> Optional[Cell]:
    """Returns None (with reason recorded by the caller) for skipped cells."""
    ok, _reason = shape_applicable(cfg, shape)
    if not ok:
        return None
    if shape.kind == "train":
        return build_train_cell(cfg, shape, mesh, **kw)
    if shape.kind == "prefill":
        return build_prefill_cell(cfg, shape, mesh, **kw)
    return build_decode_cell(cfg, shape, mesh, **kw)


# ----------------------------------------------------------------- counting


def _distribute(tree: Any, make: Callable, placements: Any = None, mesh: Any = None) -> Any:
    """``tree`` (tensors of the global shapes) with each tensor ``make(shape,
    dtype)``: of its local shard under its ``placements``, as a DTensor over
    ``mesh``, or of the global shape with ``mesh`` None. A CPU leaf (the
    cache's host ``len``) is cloned as it is."""
    from torch.distributed.tensor import DTensor, Shard

    def one(x, pl):
        if x.device.type == "cpu":
            return x.clone()
        if mesh is None:
            return make(tuple(x.shape), x.dtype)
        local = list(x.shape)
        for size, p in zip(mesh.mesh.shape, pl):
            if isinstance(p, Shard):
                local[p.dim] //= int(size)
        return DTensor.from_local(make(tuple(local), x.dtype), mesh, pl, run_check=False, shape=x.shape,
                                  stride=x.stride())

    def walk(t, p):
        if t is None:
            return None
        if isinstance(t, torch.Tensor):
            return one(t, p)
        if isinstance(t, dict):
            return {k: walk(v, None if p is None else p[k]) for k, v in t.items()}
        parts = [walk(a, None if p is None else b) for a, b in zip(t, t if p is None else p)]
        return type(t)(*parts) if hasattr(t, "_fields") else type(t)(parts)

    return walk(tree, placements)


def materialize(args: Any, vocab: int, generator: torch.Generator, device="cuda") -> Any:
    """A cell's ``args`` (meta trees) as real tensors on ``device``, drawn
    from ``generator``: floating leaves uniform in [0, 0.02), integer leaves
    (token ids, the step) uniform in [0, vocab); a host leaf (the cache's
    ``len``) as it is. Counts depend on the shapes only; these values keep
    every step finite."""

    def make(shape, dtype):
        if dtype.is_floating_point:
            x = torch.rand(shape, generator=generator, device=generator.device) * 0.02
        else:
            x = torch.randint(0, vocab, shape, generator=generator, device=generator.device)
        return x.to(device, dtype)

    return _distribute(args, make)


def _is_distributed(mesh: Any) -> bool:
    return mesh is not None and hasattr(mesh, "mesh_dim_names") and mesh.size() > 1


def count_cell(cell: Cell, args: Optional[tuple] = None, counter: Optional[OpCounter] = None) -> dict:
    """Run ``cell.fn`` once under ``OpCounter`` and return one rank's counts:
    ``flops``, ``dots`` (``matmul_flops_summary``, every row), ``bytes accessed`` (the
    ops' bytes), ``bytes_by_op`` (``op_bytes_by_op``, every row), ``collectives``
    (``collective_bytes``), ``argument_bytes`` (the arguments' bytes on a
    rank), ``peak_bytes`` (the peak of live bytes, arguments included) and
    ``ops``.

    On a DeviceMesh of more than one rank each argument becomes a DTensor of
    ``meta`` local shards under ``cell.in_shardings``, and plain tensors the
    step makes (positions, masks) are replicated (DTensor's
    ``implicit_replication``), as each rank would make them. Otherwise the
    step runs on ``args`` (default ``cell.args``: meta tensors), which may
    be real tensors of the same shapes on a card. ``counter`` (default a
    new ``OpCounter``) may be a subclass that logs the ops too
    (``launch.op_trace``)."""
    mesh = cell.mesh
    if _is_distributed(mesh):
        from torch.distributed.tensor.experimental import implicit_replication

        args = _distribute(cell.args, lambda shp, dt: torch.empty(shp, dtype=dt, device="meta"),
                           cell.in_shardings, mesh)
        dtensor_modes = (implicit_replication(),)
    else:
        args = cell.args if args is None else args
        dtensor_modes = ()
    counter = OpCounter() if counter is None else counter
    arg_bytes = counter.hold(args)
    with contextlib.ExitStack() as stack:
        if mesh is not None:
            stack.enter_context(activation_sharding(mesh, seq_sharded=cell.seq_sharded))
        for m in dtensor_modes:
            stack.enter_context(m)
        stack.enter_context(counter)
        out = cell.fn(*args)
    del out
    return {
        "flops": counter.flops,
        "dots": matmul_flops_summary(counter, top=None),
        "bytes accessed": counter.op_bytes,
        "bytes_by_op": op_bytes_by_op(counter, top=None),
        "collectives": collective_bytes(counter.collectives),
        "argument_bytes": arg_bytes,
        "peak_bytes": counter.peak,
        "ops": counter.ops,
    }


__all__ = ["Cell", "ShapeMesh", "build_cell", "build_decode_cell", "build_prefill_cell", "build_train_cell",
           "choose_kv_slots", "count_cell", "materialize"]
