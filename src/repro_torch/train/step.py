"""The train step of ``repro.train.step``: microbatch gradient
accumulation, remat, and int8 gradient compression with error feedback.

``make_train_step(cfg, tcfg)`` returns ``train_step(state, batch) ->
(state, metrics)``, ``repro``'s step, which takes a gradient of
``Model.loss`` (``make_grad_fn``) and then one AdamW step
(``optim.adamw_update_``). The step updates the state in place — the
counterpart of ``repro``'s donated state — so the state passed in is the
one returned, and a caller that needs the old values copies them first.
A failure inside the update raises ``runtime.StateSpoiled`` (from the
original error): the state is then half updated, and
``run_with_recovery`` resumes only from a checkpoint.
``batch`` holds ``tokens`` and ``labels`` (B, S) int tensors on the
parameters' device; metrics are f32 () tensors: ``loss``, ``grad_norm``,
``lr``.

  * grad accumulation: the batch splits into ``microbatches`` consecutive
    slices (``repro``'s reshape to (n_mb, B/n_mb, ...)); the losses and
    the f32 gradients are summed in that order from zero and divided by
    the count;
  * remat: each layer period is recomputed in the backward
    (``lm.forward_hidden_train``);
  * int8 compression + error feedback (``compress_grads``): the gradient
    plus the carried error is quantized per leaf at max|·|/127, rounded
    half to even as ``jnp.round``, and the quantization error carried to
    the next step.

``abstract_train_state`` is the dry run's state of ``meta`` tensors.
Over DTensor (the dry run's sharded cells) a microbatch is a slice of
each rank's local rows, never of the global batch, which would gather it.
``repro``'s ``TrainConfig.compute_dtype``, which nothing reads, is not
ported: the model computes in ``cfg.compute_dtype``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten
from repro_torch.models.registry import Model
from repro_torch.optim import AdamWConfig, OptState, adamw_init, adamw_update_
from repro_torch.runtime.fault import StateSpoiled


@dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    microbatches: int = 1  # grad-accum factor (divides the per-step batch)
    remat: bool = True
    grad_compression: bool = False  # int8 + error feedback


class TrainState(NamedTuple):
    params: Any
    opt: OptState
    err: Optional[Any]  # error-feedback buffers (grad compression) or None


def init_train_state(params: Any, tcfg: TrainConfig) -> TrainState:
    """The state of ``params``: zero moments, step 0, and zero f32 error
    buffers with ``grad_compression``."""
    err = tree_map(lambda _, p: torch.zeros_like(p, dtype=torch.float32), params) if tcfg.grad_compression else None
    return TrainState(params, adamw_init(params), err)


def make_train_state(cfg: ArchConfig, tcfg: TrainConfig, generator: torch.Generator,
                     device="cuda") -> TrainState:
    """``init_train_state`` of fresh weights (``Model.init``) drawn from
    ``generator``."""
    return init_train_state(Model(cfg).init(generator, device=device), tcfg)


def abstract_train_state(cfg: ArchConfig, tcfg: TrainConfig) -> TrainState:
    """The state as ``meta`` tensors (nothing allocated), for the dry run:
    the parameters in ``cfg.param_dtype``, f32 moments, an int32 () step,
    and f32 error buffers under ``grad_compression``."""
    params = Model(cfg).abstract_params()
    f32 = lambda _, p: torch.empty(p.shape, dtype=torch.float32, device="meta")
    opt = OptState(step=torch.empty((), dtype=torch.int32, device="meta"), m=tree_map(f32, params),
                   v=tree_map(f32, params))
    return TrainState(params, opt, tree_map(f32, params) if tcfg.grad_compression else None)


def microbatch(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    """Microbatch ``i`` of ``n`` of a (B, ...) batch leaf: rows [i·B/n,
    (i+1)·B/n), ``repro``'s reshape to (n, B/n, ...). A DTensor sharded on
    its batch dim takes that slice of each rank's local rows instead, so
    the microbatch keeps the batch's sharding without a collective (the
    global slice would gather the batch)."""
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(x, DTensor) and any(p == Shard(0) for p in x.placements):
        loc = x.to_local()
        b = loc.shape[0] // n
        return DTensor.from_local(loc[i * b:(i + 1) * b], x.device_mesh, x.placements, run_check=False)
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


# ------------------------------------------------------- grad compression


def _quantize_int8(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def compress_grads(grads: Any, err: Any) -> tuple[Any, Any]:
    """int8-quantize (grad + carried error) per leaf; return (dequantized,
    new error). ``repro`` models the int8 payload of a data-parallel
    all-reduce this way, so the numerics are what the collective would
    deliver."""

    def one(g, e):
        g32 = g.float() + e
        q, scale = _quantize_int8(g32)
        deq = q.float() * scale
        return deq, g32 - deq

    out = [one(g, e) for g, e in zip(tree_leaves(grads), tree_leaves(err))]
    return (tree_unflatten(grads, [o[0] for o in out]), tree_unflatten(grads, [o[1] for o in out]))


# ------------------------------------------------------------- step factory


def _value_and_grad(model: Model, params: Any, batch: dict, remat: bool) -> tuple[torch.Tensor, list]:
    """(loss, its gradient per leaf of ``params`` in ``tree_leaves`` order);
    a leaf the loss does not reach (a frontend projection on text-only
    batches) gets zeros, as ``jax.grad`` gives."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = model.loss(params, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return loss.detach(), [torch.zeros_like(p) if g is None else _as_param(g, p) for p, g in zip(leaves, grads)]


def _as_param(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient laid out as its parameter (a pending sum over the
    batch shards reduced once, here); any other gradient as it is."""
    if hasattr(g, "placements") and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_grad_fn(cfg: ArchConfig, tcfg: TrainConfig) -> Callable[[Any, dict], tuple[torch.Tensor, Any]]:
    """``grad_fn(params, batch) -> (loss, grads)``: the step's loss and
    gradient tree, accumulated over ``tcfg.microbatches`` as ``repro``
    does."""
    model = Model(cfg)

    def grad_fn(params: Any, batch: dict) -> tuple[torch.Tensor, Any]:
        n_mb = tcfg.microbatches
        if n_mb == 1:
            loss, grads = _value_and_grad(model, params, batch, tcfg.remat)
            return loss, tree_unflatten(params, grads)
        tot_loss = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
        tot = [torch.zeros_like(p, dtype=torch.float32) for p in tree_leaves(params)]
        for i in range(n_mb):
            mb = {k: microbatch(v, i, n_mb) for k, v in batch.items()}
            loss, grads = _value_and_grad(model, params, mb, tcfg.remat)
            tot_loss = tot_loss + loss
            for a, g in zip(tot, grads):
                a.add_(g.float())
            del grads
        return tot_loss / n_mb, tree_unflatten(params, [a.div_(n_mb) for a in tot])

    return grad_fn


def make_train_step(cfg: ArchConfig, tcfg: TrainConfig
                    ) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    grad_fn = make_grad_fn(cfg, tcfg)

    def train_step(state: TrainState, batch: dict) -> tuple[TrainState, dict]:
        loss, grads = grad_fn(state.params, batch)
        err = state.err
        if tcfg.grad_compression:
            grads, err = compress_grads(grads, err)
        try:
            params, opt, metrics = adamw_update_(tcfg.optimizer, grads, state.opt, state.params)
        except Exception as e:
            raise StateSpoiled("the step failed inside the in-place AdamW update") from e
        return TrainState(params, opt, err), {"loss": loss, **metrics}

    return train_step
