"""The trained classifiers of the paper's experiment: ``benchmarks/common.py``
on the port.

The paper's regime — the class probability rising sharply in a narrow
α-interval along the black→image path — only shows on a *confident* model.
So the paper CNN and the reduced ViT are trained first, on the synthetic
contrast-threshold task (``data.images``), to near-perfect accuracy.

  * ``classifier_step``: the mean cross-entropy of a model's logits, its
    gradient, and one AdamW step in place (``optim.adamw_update_``);
  * ``train_cnn`` (300 steps of 64) and ``train_vit`` (250 of 32, on
    ``reduced_vit()``): AdamW at lr 2e-3, 20 warmup steps, cosine over the
    run, no weight decay, clipping at 1.0, batches with 35% background. The
    weights come from ``generator`` first, then each step's batch, so one
    seed gives the card and the CPU the same run;
  * ``save_params``/``load_params``: ``common.py``'s ``leaf_{i}`` npz layout
    (``repro``'s leaves in ``jax.tree_util`` order, conv weights HWIO), so
    either package loads the other's file;
  * ``load_or_train_cnn``/``load_or_train_vit``: the cached weights, or a
    run that writes them. The caches are ``results/bench_*_params_torch.npz``,
    beside (never over) the JAX side's ``bench_*_params.npz``;
  * ``cnn_prob_fn``, ``eval_batch``, ``accuracy``, ``vit_accuracy`` (256
    held-out images, 30% background), ``prompt_pool`` and ``zipf_sample``.
"""
from __future__ import annotations

from functools import partial
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.configs.paper_cnn import CONFIG as PAPER_CNN
from repro_torch.configs.paper_cnn import CnnConfig
from repro_torch.configs.vit import reduced_vit
from repro_torch.data.images import synthetic_images
from repro_torch.models import cnn, vit
from repro_torch.models.common import params_from_numpy, tree_leaves, tree_map, tree_unflatten
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update_

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results"
CNN_CACHE = RESULTS_DIR / "bench_cnn_params_torch.npz"
VIT_CACHE = RESULTS_DIR / "bench_vit_params_torch.npz"
TRAIN_BACKGROUND = 0.35  # share of dimmed background images in a training batch
HELD_OUT = (99, 0.3)  # the held-out set's seed and background share
EVAL_SEED = 7


def classifier_step(forward: Callable, cfg, ocfg: AdamWConfig, params, opt, imgs: torch.Tensor,
                    labels: torch.Tensor):
    """One training step: the mean cross-entropy of ``forward(cfg, params,
    imgs)`` against ``labels``, its gradient, and one AdamW step. ``params``
    and ``opt`` are updated in place; returns (params, opt, the loss, a ()
    tensor taken before the update)."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    logp = torch.log_softmax(forward(cfg, tree_unflatten(params, leaves), imgs).float(), dim=-1)
    loss = -logp.gather(1, labels[:, None].long()).mean()
    grads = torch.autograd.grad(loss, leaves)
    params, opt, _ = adamw_update_(ocfg, tree_unflatten(params, list(grads)), opt, params)
    return params, opt, loss.detach()


def _model(kind: str):
    if kind == "cnn":
        return PAPER_CNN, cnn.forward, cnn.init_params
    if kind == "vit":
        return reduced_vit(), vit.forward, vit.init_params
    raise ValueError(f"unknown classifier {kind!r}: 'cnn' or 'vit'")


def train_classifier(kind: str, generator: torch.Generator, steps: int, batch: int, lr: float, *,
                     stop: Optional[int] = None, device="cuda"):
    """Train the paper CNN (``kind="cnn"``) or the reduced ViT (``"vit"``)
    for ``steps`` steps of ``batch`` images — or only the first ``stop``
    steps of that schedule. Returns (cfg, params, the per-step losses as an
    f32 tensor on ``device``)."""
    cfg, forward, init = _model(kind)
    params = init(cfg, generator, device=device)
    ocfg = AdamWConfig(lr=lr, warmup_steps=20, total_steps=steps, weight_decay=0.0)
    opt = adamw_init(params)
    losses = []
    for _ in range(steps if stop is None else stop):
        imgs, labels = synthetic_images(generator, batch, cfg, background_frac=TRAIN_BACKGROUND, device=device)
        params, opt, loss = classifier_step(forward, cfg, ocfg, params, opt, imgs, labels)
        losses.append(loss)
    return cfg, params, torch.stack(losses)


def train_cnn(generator: torch.Generator, steps: int = 300, batch: int = 64, lr: float = 2e-3,
              device="cuda"):
    """The paper CNN trained on the task: (params, the final loss)."""
    _, params, losses = train_classifier("cnn", generator, steps, batch, lr, device=device)
    return params, float(losses[-1])


def train_vit(generator: torch.Generator, steps: int = 250, batch: int = 32, lr: float = 2e-3,
              device="cuda"):
    """The reduced ViT trained on the same task (``reduced_vit`` shares the
    CNN's 32×32×3, 10-class shapes): (cfg, params, the final loss)."""
    cfg, params, losses = train_classifier("vit", generator, steps, batch, lr, device=device)
    return cfg, params, float(losses[-1])


# ------------------------------------------------------------------- weights


def save_params(path, params: dict) -> None:
    """Write ``params`` (the CNN's or the ViT's) as ``repro``'s leaves,
    ``leaf_{i}`` in ``jax.tree_util`` order, conv weights HWIO."""
    tree = cnn.params_to_numpy(params) if "stem" in params else tree_map(
        lambda _, t: t.detach().cpu().numpy(), params)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{f"leaf_{i}": a for i, a in enumerate(tree_leaves(tree))})


def _numpy_like(cfg) -> dict:
    """``meta`` tensors of ``cfg``'s parameters in ``repro``'s layout."""
    if isinstance(cfg, CnnConfig):
        hwio = lambda s: (s[2], s[3], s[1], s[0]) if len(s) == 4 else s
        return {layer: {name: torch.empty(hwio(s), device="meta") for name, s in group.items()}
                for layer, group in cnn.param_shapes(cfg).items()}
    return tree_map(lambda _, d: torch.empty(d.shape, device="meta"), vit.param_specs(cfg))


def load_params(path, cfg, device="cuda") -> dict:
    """Read a ``save_params`` file — or one that ``benchmarks/common.py``
    wrote — as the port's parameters of ``cfg`` on ``device``."""
    like = _numpy_like(cfg)
    want = tree_leaves(like)
    with np.load(path) as data:
        if len(data.files) != len(want):
            raise ValueError(f"{path}: {len(data.files)} leaves, {cfg.name} has {len(want)}")
        arrays = [np.asarray(data[f"leaf_{i}"], np.float32) for i in range(len(want))]
    for i, (a, w) in enumerate(zip(arrays, want)):
        if a.shape != tuple(w.shape):
            raise ValueError(f"{path}: leaf_{i} is {a.shape}, {cfg.name} wants {tuple(w.shape)}")
    tree = tree_unflatten(like, arrays)
    return cnn.params_from_numpy(tree, device) if isinstance(cfg, CnnConfig) else params_from_numpy(tree, device)


def load_or_train_cnn(path=None, seed: int = 42, device="cuda") -> dict:
    """The trained paper CNN: read from ``path`` (the port's cache by
    default) when it exists, else trained from ``seed`` and written there."""
    path = Path(path) if path is not None else CNN_CACHE
    if path.exists():
        return load_params(path, PAPER_CNN, device)
    params, loss = train_cnn(torch.Generator().manual_seed(seed), device=device)
    save_params(path, params)
    print(f"# trained bench CNN: final loss {loss:.4f}")
    return params


def load_or_train_vit(path=None, seed: int = 43, device="cuda"):
    """The trained reduced ViT and its config, as ``load_or_train_cnn``."""
    cfg = reduced_vit()
    path = Path(path) if path is not None else VIT_CACHE
    if path.exists():
        return cfg, load_params(path, cfg, device)
    cfg, params, loss = train_vit(torch.Generator().manual_seed(seed), device=device)
    save_params(path, params)
    print(f"# trained bench ViT: final loss {loss:.4f}")
    return cfg, params


# ---------------------------------------------------------------- evaluation


def cnn_prob_fn(params: dict) -> Callable:
    """f(images, targets) -> target-class probability (the paper's f)."""
    return partial(cnn.prob_fn, PAPER_CNN, params)


def eval_batch(n: int = 8, generator: Optional[torch.Generator] = None, device="cuda"):
    """``n`` foreground images (labels 1..9) and their labels; seed 7 unless
    a generator is given."""
    generator = generator if generator is not None else torch.Generator().manual_seed(EVAL_SEED)
    return synthetic_images(generator, n, device=device)


@torch.no_grad()
def _held_out_accuracy(forward: Callable, cfg, params: dict, n: int) -> float:
    device = tree_leaves(params)[0].device
    imgs, labels = synthetic_images(torch.Generator().manual_seed(HELD_OUT[0]), n, cfg,
                                    background_frac=HELD_OUT[1], device=device)
    return float((forward(cfg, params, imgs).argmax(-1) == labels).float().mean())


def accuracy(params: dict, n: int = 256) -> float:
    """The CNN's accuracy on ``n`` held-out images (30% background)."""
    return _held_out_accuracy(cnn.forward, PAPER_CNN, params, n)


def vit_accuracy(params: dict, n: int = 256) -> float:
    """The reduced ViT's accuracy on the same held-out images."""
    return _held_out_accuracy(vit.forward, reduced_vit(), params, n)


# ------------------------------------------------------------------- traffic


def prompt_pool(rng: np.random.Generator, vocab_size: int, n: int, *, lengths=(5, 6, 7)) -> list:
    """``n`` int32 prompts with cycled lengths: the unique-request pool that
    repeat traffic (``zipf_sample``) draws from."""
    return [rng.integers(1, vocab_size, int(lengths[i % len(lengths)])).astype(np.int32) for i in range(n)]


def zipf_sample(rng: np.random.Generator, pool_size: int, n: int, *, alpha: float = 1.1) -> np.ndarray:
    """``n`` indices into a pool, rank-frequency p ∝ (rank+1)^-alpha, every
    draw inside the pool (``np.random.zipf``'s support is unbounded)."""
    p = (np.arange(pool_size, dtype=np.float64) + 1.0) ** -alpha
    p /= p.sum()
    return rng.choice(pool_size, size=n, p=p)
