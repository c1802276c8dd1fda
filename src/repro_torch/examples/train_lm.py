"""End-to-end training driver on the full substrate stack.

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--device cpu]          # ~10M, quick
    PYTHONPATH=src python -m repro_torch.examples.train_lm --params 100m --steps 300

``examples/train_lm.py`` on the port. Exercises: the synthetic data
pipeline -> the microbatched train step with remat -> AdamW + cosine ->
async checkpointing -> the fault-tolerant driver loop with straggler
monitoring. The --params 100m variant is the "train a ~100M model for a few
hundred steps" run; the default is a scaled-down smoke of the same path.
A second run on the same ``--ckpt-dir`` resumes from its newest checkpoint.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time
from typing import Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCHS
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.launch import device_of
from repro_torch.models.common import tree_leaves
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import FaultConfig, StragglerMonitor, run_with_recovery
from repro_torch.train import TrainConfig, make_train_state, make_train_step

SIZES = {
    # llama-family dims scaled down; all divisible for the production mesh
    "10m": dict(num_layers=4, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64, d_ff=704, vocab_size=8192),
    "100m": dict(num_layers=12, d_model=768, num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048,
                 vocab_size=32768),
}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.train_lm")
    ap.add_argument("--params", default="10m", choices=sorted(SIZES))
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_train_lm_ckpt"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def main(argv: Optional[list[str]] = None) -> dict:
    args = parser().parse_args(argv)
    device = device_of(args)
    cfg = dataclasses.replace(ARCHS["llama3-8b"], name=f"llama-{args.params}", **SIZES[args.params])
    tcfg = TrainConfig(
        optimizer=AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps),
        microbatches=args.microbatches,
        remat=True,
    )
    state = make_train_state(cfg, tcfg, torch.Generator(device=device).manual_seed(0), device=device)
    n = sum(p.numel() for p in tree_leaves(state.params))
    print(f"model: {cfg.name}  params={n/1e6:.1f}M  steps={args.steps}")

    step_fn = make_train_step(cfg, tcfg)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch, seed=0))
    ckpt = CheckpointManager(args.ckpt_dir, keep_n=2, save_async=True)
    start = 0
    restored_step, restored = ckpt.restore_latest(state)
    if restored_step is not None:
        state, start = restored, restored_step
        print(f"resumed from checkpoint step {start}")

    monitor = StragglerMonitor(FaultConfig())

    def wrapped(state, batch):
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        s, m = step_fn(state, b)
        return s, {k: float(v) for k, v in m.items()}

    t0 = time.time()
    state, hist = run_with_recovery(
        wrapped, state, data, num_steps=args.steps,
        ckpt_manager=ckpt, ckpt_every=max(args.steps // 4, 10),
        monitor=monitor, start_step=start,
    )
    dt = time.time() - t0
    losses = [h["loss"] for h in hist]
    if not losses:  # resumed at the last step: nothing left to train
        print(f"done: 0 steps, resumed at step {start} of {args.steps}")
        return {"params_m": n / 1e6, "start": start, "steps": 0, "losses": []}
    ms = dt / len(hist) * 1e3
    print(
        f"done: {len(hist)} steps, {ms:.0f} ms/step, "
        f"loss {losses[0]:.3f} -> {losses[-1]:.3f}, stragglers={len(monitor.flagged)}"
    )
    assert losses[-1] < losses[0], "training must reduce loss"
    return {"params_m": n / 1e6, "start": start, "steps": len(hist), "ms_per_step": ms, "losses": losses,
            "stragglers": len(monitor.flagged)}


if __name__ == "__main__":
    main()
    sys.exit(0)
