"""Command lines of the port, as ``repro.launch``: ``explain`` (the
explain engine under mixed-length traffic), ``serve`` (generation, or
generate and explain traffic through one scheduler) and ``train`` (the
training loop).

Each takes ``repro``'s flags and prints ``repro``'s lines, and adds its
own: ``--device {cuda,cpu}`` (default ``cuda``; without a card it exits
non-zero, it never carries on on the CPU) and ``--layers N`` (a depth cut,
as ``chip_smoke.py`` cuts full-width models to fit one card); ``explain``
and ``serve`` also ``--full`` (the named architecture at its published
widths, where ``repro`` always takes ``reduced(...)``), while ``train``
keeps ``repro``'s ``--reduced``. The helpers here are the ones the command
lines share.
"""
from __future__ import annotations

import argparse
from dataclasses import replace

import torch


def add_port_args(ap: argparse.ArgumentParser, *, full: bool = True) -> None:
    """The flags the port adds to ``repro``'s (``--full`` unless ``full``
    is False)."""
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model runs (cuda: the card, and no fallback)")
    if full:
        ap.add_argument("--full", action="store_true",
                        help="the architecture at its published widths, not reduced(...)")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to N layers (0: the config's depth)")


def device_of(args: argparse.Namespace) -> torch.device:
    """``args.device``; exits non-zero with a message when it is ``cuda``
    and there is no card."""
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: torch.cuda.is_available() is False; "
                         "pass --device cpu to run on the CPU")
    return torch.device(args.device)


def sized(cfg, reduce, args: argparse.Namespace):
    """``cfg`` at full width with ``--full``, else ``reduce(cfg)``, cut to
    ``--layers`` when given."""
    cfg = cfg if args.full else reduce(cfg)
    return replace(cfg, num_layers=args.layers) if args.layers else cfg


def use_kernels(dev: torch.device, requested: bool) -> bool:
    """The engine's ``use_kernels``: always on the card (the engine refuses
    False there), ``requested`` on the CPU, where the kernel ops take their
    plain versions and the flag only enters the cache keys, as in
    ``repro``."""
    return True if dev.type == "cuda" else requested


__all__ = ["add_port_args", "device_of", "sized", "use_kernels"]
