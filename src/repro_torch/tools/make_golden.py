"""Regenerate the port's golden attribution fixtures under tests/golden_torch/.

    PYTHONPATH=src python -m repro_torch.tools.make_golden --device cpu [--forward-only]

``tools/make_golden.py`` on the port. One .npz per registered attribution
method, produced on the paper CNN (random-init from a fixed seed — no
trained checkpoint dependency) with a fixed input batch and the paper
schedule. ``tests/test_torch_golden.py`` replays the identical pipeline on
the CPU, and ``chip_smoke.py`` on the card through the kernels, and both
compare within ``repro``'s tolerance bands, so engine / schedule / kernel
refactors cannot silently change what users see — also a change that
moves a kernel and its plain version together.

The weights and the batch are drawn by ``numpy.random.default_rng(SEED)``
(``repro`` draws them with ``jax.random``, which the port cannot import,
and torch's generators are not promised to give the same bits on every
torch version): the weights first, in ``repro``'s layout (conv weights
HWIO) and ``jax.tree_util`` leaf order, normal with std 1/√fan_in and zero
biases, then the batch, uniform in [0, 1) in NHWC. The same arrays can
feed ``repro``. The methods' own draws are the port's: the ensembles'
normals from ``torch.Generator().manual_seed(SEED)`` on the CPU
(``golden_draw``: what the ``Explainer`` draws on the CPU, handed to it on
any device, so the card explains the same paths), the RISE and LIME masks
as ``PerturbExplainer`` draws them (on the CPU, then moved).

Regenerate ONLY when an intentional output-changing change lands, and say
so in CHANGES.md — a diff here is the tests' entire point.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.paper_cnn import CONFIG as CNN_CONFIG
from repro_torch.core import perturb
from repro_torch.core.api import Explainer
from repro_torch.core.methods import METHODS
from repro_torch.launch import device_of
from repro_torch.models import cnn

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "tests", "golden_torch")

# Frozen generation config — repro's tools/make_golden.py, value for value.
SEED = 0
BATCH = 2
M = 16
N_INT = 4
SCHEDULE = "paper"
N_SAMPLES = 2
SIGMA = 0.05
TARGETS = (1, 2)
# forward-only (perturbation) fixtures: CNN cell grid + mask budget
N_MASKS = 16
CELL = 4  # 32x32x3 -> 8x8 grid of 4x4x3 cells (S=64 positions)


def _hwio_shapes() -> dict:
    """``cnn.param_shapes`` in ``repro``'s layout: conv weights HWIO."""
    hwio = lambda s: (s[2], s[3], s[1], s[0]) if len(s) == 4 else s
    return {layer: {name: hwio(s) for name, s in group.items()}
            for layer, group in cnn.param_shapes(CNN_CONFIG).items()}


def golden_arrays() -> tuple[dict, np.ndarray, np.ndarray]:
    """(weights as ``repro``'s tree of f32 arrays, the (B, H, W, C) batch,
    the (B,) int32 targets), all from ``default_rng(SEED)``."""
    rng = np.random.default_rng(SEED)
    tree: dict = {}
    shapes = _hwio_shapes()
    for layer in sorted(shapes):
        tree[layer] = {}
        for name in sorted(shapes[layer]):
            shape = shapes[layer][name]
            if name == "b":
                tree[layer][name] = np.zeros(shape, np.float32)
                continue
            fan_in = int(np.prod(shape[:-1]))  # repro's rule: the last axis is the output
            tree[layer][name] = (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
    s = CNN_CONFIG.image_size
    x = rng.random((BATCH, s, s, CNN_CONFIG.channels)).astype(np.float32)
    return tree, x, np.asarray(TARGETS, np.int32)


def golden_inputs(device="cuda"):
    """``(f, x, baseline, targets)`` on ``device``: the CNN's target-class
    probability over ``golden_arrays``' weights, the batch, a zero
    baseline."""
    tree, x, t = golden_arrays()
    params = cnn.params_from_numpy(tree, device=device)
    x = torch.from_numpy(x).to(device)
    f = lambda xs, tt: cnn.prob_fn(CNN_CONFIG, params, xs, tt)
    return f, x, torch.zeros_like(x), torch.from_numpy(t).to(device)


def golden_explainer(f, method: str, device="cuda") -> Explainer:
    return Explainer(
        f,
        method=method,
        schedule=SCHEDULE,
        m=M,
        n_int=N_INT,
        n_samples=N_SAMPLES,
        sigma=SIGMA,
        sample_seed=SEED,
        device=device,
    )


def golden_draw(ex: Explainer, x: torch.Tensor) -> Optional[torch.Tensor]:
    """The ensemble's (B·n, *F) standard normals, drawn on the CPU from
    ``ex.sample_seed`` as the ``Explainer`` draws them there (None for a
    method of one path)."""
    n = ex.ensemble_size
    if n == 1:
        return None
    g = torch.Generator().manual_seed(ex.sample_seed)
    return torch.randn((x.shape[0] * n,) + tuple(x.shape[1:]), generator=g)


def golden_perturb_result(f, x, bl, t, method: str, device="cuda"):
    """Forward-only fixture pipeline: same seeded CNN and input batch,
    attributed over the 4x4x3 cell grid by ``repro_torch.core.perturb`` —
    the scores are per CELL (B, 64), not per pixel."""
    img_shape = tuple(x.shape[1:])
    fc = perturb.cell_fn(f, img_shape, CELL)
    pe = perturb.PerturbExplainer(fc, method=method, n_masks=N_MASKS, seed=SEED, device=device)
    return pe.attribute(perturb.image_to_cells(x, CELL), perturb.image_to_cells(bl, CELL), t)


def golden_result(f, x, bl, t, method: str, device="cuda"):
    """One method's fixture result on ``device``: the perturbation pipeline
    for a forward-only method, else the explainer with ``golden_draw``."""
    if METHODS[method].forward_only:
        return golden_perturb_result(f, x, bl, t, method, device)
    ex = golden_explainer(f, method, device)
    return ex.attribute(x, bl, t, draw=golden_draw(ex, x))


def _write(path: str, res) -> None:
    arr = lambda a: a.detach().float().cpu().numpy()
    np.savez_compressed(
        path,
        attributions=arr(res.attributions),
        f_x=arr(res.f_x),
        f_baseline=arr(res.f_baseline),
        delta=arr(res.delta),
        meta=np.asarray([SEED, BATCH, M, N_INT, N_SAMPLES], np.int64),
    )
    print(f"{os.path.normpath(path)}: |attr| mean {float(res.attributions.abs().mean()):.3e} "
          f"delta {arr(res.delta)}")


def main(argv: Optional[list[str]] = None) -> list[str]:
    """Write the fixtures; returns their paths."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tools.make_golden")
    ap.add_argument(
        "--forward-only", action="store_true",
        help="regenerate ONLY the perturbation-class fixtures "
        "(occlusion/rise/lime); gradient goldens stay untouched",
    )
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the pipeline runs (the committed fixtures come from the CPU)")
    args = ap.parse_args(argv)
    device = device_of(args)
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the CPU's bits then do not depend on the host's core count
    try:
        f, x, bl, t = golden_inputs(device)
        written = []
        for method in sorted(METHODS):
            if args.forward_only and not METHODS[method].forward_only:
                continue
            path = os.path.join(GOLDEN_DIR, f"cnn_{method}.npz")
            _write(path, golden_result(f, x, bl, t, method, device))
            written.append(path)
    finally:
        torch.set_num_threads(threads)
    return written


if __name__ == "__main__":
    main()
    raise SystemExit(0)
