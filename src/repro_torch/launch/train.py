"""Training from the command line: ``repro.launch.train`` on the port.

    # the CPU, the reduced config of the family
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced --steps 20

    # the card: llama3-8b at full width, 8 of 32 layers, the flash kernels
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b --layers 8 --attn flash \
        --steps 6 --ckpt-dir build/train_ckpt --ckpt-every 3

The data pipeline feeds the train step (AdamW, microbatches, remat, int8
gradient compression) under ``run_with_recovery``, which checkpoints
every ``--ckpt-every`` steps (``CheckpointManager``, async, the last two
kept) and resumes from the newest valid checkpoint in ``--ckpt-dir``.
The flags and the printed lines are ``repro``'s (``arch=… params=…M
steps=…``, ``resumed from step N``, ``done: … loss a -> b
stragglers=…``); as in ``repro`` the named config trains at its published
widths unless ``--reduced``. The port adds ``--device {cuda,cpu}``
(default ``cuda``, no fallback), ``--layers N`` (a depth cut) and
``--attn {auto,flash}`` (``flash``: the flash kernels, forward and both
backward ones). The weights are ``draw``'s, from a torch generator seeded
with ``--seed`` on the chosen device: their numbers are not ``repro``'s.
The batches are ``repro``'s, bit for bit (``data.SyntheticLM``).
"""
from __future__ import annotations

import argparse
import sys
import time
from dataclasses import replace
from typing import Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS, get_config, reduced
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import add_port_args, device_of
from repro_torch.models.common import tree_leaves
from repro_torch.models.registry import Model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import FaultConfig, StragglerMonitor, run_with_recovery
from repro_torch.train import TrainConfig, init_train_state, make_train_step


def draw(cfg, args: argparse.Namespace, device="cuda") -> dict:
    """The run's weights: ``Model.init`` from a generator on ``device``
    seeded with ``args.seed``."""
    return Model(cfg).init(torch.Generator(device=device).manual_seed(args.seed), device=device)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="llama3-8b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true", help="CPU-scale variant")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--attn", default="auto", choices=("auto", "flash"),
                    help="attention implementation: flash = the flash kernels (forward, dQ, dK/dV)")
    add_port_args(ap, full=False)
    return ap


def run(args: argparse.Namespace):
    """Train as ``args`` say and print ``repro``'s lines; returns (the final
    ``TrainState``, the per-step history of float metrics)."""
    device = device_of(args)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    cfg = replace(cfg, attn_impl=args.attn, **({"num_layers": args.layers} if args.layers else {}))

    tcfg = TrainConfig(
        optimizer=AdamWConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps),
        microbatches=args.microbatches,
        remat=True,
        grad_compression=args.grad_compression,
    )
    state = init_train_state(draw(cfg, args, device), tcfg)
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M steps={args.steps}")

    step_fn = make_train_step(cfg, tcfg)
    data = SyntheticLM(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch, seed=args.seed)
    )

    ckpt = CheckpointManager(args.ckpt_dir, keep_n=2, save_async=True) if args.ckpt_dir else None
    start = 0
    if ckpt is not None:
        restored_step, restored = ckpt.restore_latest(state)
        if restored_step is not None:
            del state  # its memory goes before the next step's
            state, start = restored, restored_step
            print(f"resumed from step {start}")

    monitor = StragglerMonitor(FaultConfig())

    def wrapped(state, batch):
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        new_state, metrics = step_fn(state, b)
        return new_state, {k: float(v) for k, v in metrics.items()}

    t0 = time.time()
    state, history = run_with_recovery(
        wrapped,
        state,
        data,
        num_steps=args.steps,
        ckpt_manager=ckpt,
        ckpt_every=args.ckpt_every,
        monitor=monitor,
        start_step=start,
    )
    dt = time.time() - t0
    losses = [h["loss"] for h in history]
    print(
        f"done: {len(history)} steps in {dt:.1f}s "
        f"({dt/max(len(history),1)*1e3:.0f} ms/step) "
        f"loss {losses[0]:.3f} -> {losses[-1]:.3f} "
        f"stragglers={len(monitor.flagged)}"
    )
    return state, history


def main(argv: Optional[list[str]] = None) -> int:
    run(parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
