"""Quickstart: Non-Uniform IG (the paper) in five lines of user code.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu] [--params NPZ]

``examples/quickstart.py`` on the port. Loads the trained paper CNN (or
trains it on the synthetic task and caches it, ``train.classifier``),
explains one prediction with the paper's NUIG and with uniform IG at the
same step budget, and prints the convergence deltas and an ASCII heatmap
of the NUIG attribution (paper Fig. 5a in miniature). ``--params`` reads
trained weights from an npz file of either package instead of the cache.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import PAPER_CNN
from repro_torch.core.api import Explainer
from repro_torch.launch import device_of
from repro_torch.train.classifier import cnn_prob_fn, eval_batch, load_or_train_cnn, load_params


def ascii_heatmap(attr: np.ndarray) -> str:
    """(H, W) -> shaded ASCII."""
    a = np.abs(attr)
    a = a / (a.max() + 1e-12)
    chars = " .:-=+*#%@"
    return "\n".join(
        "".join(chars[min(int(v * (len(chars) - 1)), len(chars) - 1)] for v in row) for row in a
    )


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--params", default=None, help="trained CNN weights (npz) in place of the cache")
    return ap


def main(argv: Optional[list[str]] = None) -> dict:
    args = parser().parse_args(argv)
    device = device_of(args)
    params = load_params(args.params, PAPER_CNN, device) if args.params else load_or_train_cnn(device=device)
    f = cnn_prob_fn(params)  # f(images, targets) -> target-class probability
    x, targets = eval_batch(1, device=device)
    baseline = torch.zeros_like(x)  # black image = missingness (paper §II)

    m = 32  # total interpolation steps — paper uses 10-30x more for uniform
    deltas = {}
    for method in ("uniform", "paper"):
        explainer = Explainer(f, schedule=method, m=m, n_int=4, device=device)
        res = explainer.attribute(x, baseline, targets)
        deltas[method] = float(res.delta[0])
        print(f"\nmethod={method:8s} m={m} convergence delta={deltas[method]:.5f}")

    heat = ascii_heatmap(res.attributions[0].sum(-1).cpu().numpy())  # sum over channels
    print("\nNUIG attribution heatmap (target class {}):".format(int(targets[0])))
    print(heat)
    print("\nThe blob the classifier keys on lights up; the paper's schedule")
    print("reaches the same completeness with a fraction of the steps.")
    return {"m": m, "delta": deltas, "target": int(targets[0]), "heatmap": heat}


if __name__ == "__main__":
    main()
    sys.exit(0)
