"""AdamW + cosine LR schedule + global-norm clipping over parameter trees:
``repro.optim.adamw``.

The optimizer state mirrors the parameter tree (f32 moments ``m`` and
``v``, a () int32 ``step``). Everything is computed in f32 as ``repro``
does it, in its order of operations: the schedule from the int32 step,
the bias corrections ``1 − b ** step`` as f32 powers, then per leaf
m, v, m̂ / (√v̂ + eps) and the decoupled weight decay. Decay applies to a
leaf with two or more axes, judged on the leaf as stored: a stacked norm
scale (periods, d) is decayed, as in ``repro`` (ROADMAP.md keeps this
quirk for parity).

``adamw_update`` is ``repro``'s functional form. ``adamw_update_`` does
the same arithmetic in place under ``torch.no_grad()``: the parameters,
the moments and the gradients (clipped) are overwritten, so a step needs
no second copy of the state; both give the same bits.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor  # () int32
    m: Any  # first-moment tree
    v: Any  # second-moment tree


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_frac * lr, f32 from the
    int32 ``step``."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree: Any) -> torch.Tensor:
    """√(Σ over the leaves of Σ x²), each leaf's sum in f32."""
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)


def clip_by_global_norm(tree: Any, max_norm: float) -> tuple[Any, torch.Tensor]:
    """(the tree scaled to a global norm of at most ``max_norm``, the norm
    before scaling)."""
    gn = global_norm(tree)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda _, g: (g.float() * scale).to(g.dtype), tree), gn


def adamw_init(params: Any) -> OptState:
    """Zero f32 moments shaped like ``params`` and a () int32 step 0 on
    the device of the first leaf."""
    zeros = lambda _, p: torch.zeros_like(p, dtype=torch.float32)
    device = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def _leaf_(cfg: AdamWConfig, lr, b1c, b2c, p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
           v: torch.Tensor) -> None:
    """One leaf's AdamW update in place: m, v and p are overwritten, each
    product and sum rounded where ``repro``'s is."""
    g32 = g.float()
    m.mul_(cfg.b1).add_((1 - cfg.b1) * g32)
    v.mul_(cfg.b2).add_(torch.square(g32).mul_(1 - cfg.b2))
    delta = (m / b1c).div_(torch.sqrt(v / b2c).add_(cfg.eps))
    p32 = p.float()  # p itself when it is f32
    if p.ndim >= 2:  # decoupled weight decay only on >=2D weights (skip norms/biases)
        delta.add_(cfg.weight_decay * p32)
    delta.mul_(lr)
    if p32 is p:
        p.sub_(delta)
    else:
        p.copy_(p32.sub_(delta))


@torch.no_grad()
def adamw_update_(cfg: AdamWConfig, grads: Any, state: OptState, params: Any
                  ) -> tuple[Any, OptState, dict]:
    """One AdamW step in place. ``params``, ``state.m``/``state.v`` and
    ``grads`` (clipped) are overwritten; returns (params, the new state,
    metrics {"grad_norm", "lr"}) as ``repro``'s ``adamw_update``."""
    flat_g = tree_leaves(grads)
    gnorm = global_norm(grads)
    if cfg.clip_norm:
        scale = _clip_scale(gnorm, cfg.clip_norm)
        for g in flat_g:
            if g.dtype == torch.float32:
                g.mul_(scale)
            else:
                g.copy_((g.float() * scale).to(g.dtype))
    step = state.step + 1
    lr = cosine_schedule(cfg, step)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    for p, g, m, v in zip(tree_leaves(params), flat_g, tree_leaves(state.m), tree_leaves(state.v)):
        _leaf_(cfg, lr, b1c, b2c, p, g, m, v)
    return params, OptState(step, state.m, state.v), {"grad_norm": gnorm, "lr": lr}


def adamw_update(cfg: AdamWConfig, grads: Any, state: OptState, params: Any
                 ) -> tuple[Any, OptState, dict]:
    """One AdamW step. Returns (new_params, new_state, metrics); the inputs
    are left as they were."""
    copy = lambda tree: tree_unflatten(tree, [x.detach().clone() for x in tree_leaves(tree)])
    return adamw_update_(cfg, copy(grads), OptState(state.step, copy(state.m), copy(state.v)),
                         copy(params))
