"""Batched generation serving on the static-cache engine.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu] [--arch qwen3-moe-30b-a3b]

``examples/serve_lm.py`` on the port: prefill a batch of prompts, decode
greedily, report the throughput. Works for every architecture of
``ARCHS`` (dense, MoE, SSM, hybrid, encoder-decoder, vision frontend) at
its reduced widths; a frontend config gets stub features of ones, as in
``repro``.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import torch

from repro_torch.configs import ARCHS, reduced
from repro_torch.launch import device_of
from repro_torch.models.registry import Model
from repro_torch.serve import ServeEngine


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.serve_lm")
    ap.add_argument("--arch", default="llama3-8b", choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def main(argv: Optional[list[str]] = None) -> dict:
    args = parser().parse_args(argv)
    device = device_of(args)
    cfg = reduced(ARCHS[args.arch])
    params = Model(cfg).init(torch.Generator(device=device).manual_seed(0), device=device)
    g = torch.Generator(device=device).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=g,
                                     device=device, dtype=torch.int32)}
    if cfg.frontend == "vision":
        batch["frontend"] = torch.ones((args.batch, cfg.frontend_tokens, cfg.frontend_dim),
                                       dtype=torch.bfloat16, device=device)
    if cfg.frontend == "audio":
        batch["frontend"] = torch.ones((args.batch, cfg.encoder_seq, cfg.frontend_dim),
                                       dtype=torch.bfloat16, device=device)

    extra = cfg.frontend_tokens if cfg.frontend == "vision" else 0
    engine = ServeEngine(cfg, params, max_len=extra + args.prompt_len + args.tokens, device=device)

    t0 = time.perf_counter()
    out = engine.generate(batch, args.tokens)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    total_tokens = args.batch * args.tokens
    print(
        f"arch={cfg.name}: generated {tuple(out.shape)} in {wall:.2f}s "
        f"({total_tokens/wall:.0f} tok/s incl. prefill)"
    )
    sample = out[0].cpu().numpy()[:16]
    print("sample:", sample, "...")
    return {"arch": cfg.name, "shape": tuple(out.shape), "wall": wall, "tok_s": total_tokens / wall,
            "sample": sample.tolist()}


if __name__ == "__main__":
    main()
    sys.exit(0)
