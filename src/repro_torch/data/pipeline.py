"""Synthetic deterministic data pipeline: ``repro.data.pipeline``, which
is numpy only and is kept here as the port's own copy.

  * deterministic: the batch of global step s is a pure function of (seed,
    s, host index), drawn from ``np.random.SeedSequence([seed, s,
    host_index])``, so restart and resume replay identically and equal
    ``repro``'s batches bit for bit;
  * per-host sharding: each host draws only its slice of the global batch
    (``host_index``/``host_count``); on one card the slice is the batch;
  * prefetch: a depth-2 background thread keeps the next batches ready.

The tokens are Zipf-like draws with a copy task in a prefix window, so the
LM loss has structure to learn. Batches are numpy ``int32`` arrays
(``tokens``, ``labels``); the caller moves them to its device.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1
    copy_frac: float = 0.25  # fraction of the sequence that is a copy task


class SyntheticLM:
    """Deterministic (seed, step) -> batch generator, host-sharded."""

    def __init__(self, cfg: DataConfig):
        assert cfg.global_batch % cfg.host_count == 0
        self.cfg = cfg
        self.local_batch = cfg.global_batch // cfg.host_count
        # Zipf-ish token marginal, fixed by seed
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab_size + 1)
        p = 1.0 / ranks**1.1
        self._p = p / p.sum()
        self._perm = rng.permutation(cfg.vocab_size)

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, cfg.host_index]))
        B, S = self.local_batch, cfg.seq_len
        toks = self._perm[rng.choice(cfg.vocab_size, size=(B, S + 1), p=self._p)].astype(np.int32)
        # copy task: second half of a prefix window repeats the first half
        w = int(S * cfg.copy_frac)
        if w > 1:
            toks[:, w : 2 * w] = toks[:, :w]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class _Prefetcher:
    """Depth-N background prefetch over any batch iterator."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            for item in self._it:
                self._q.put(item)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item


def make_pipeline(cfg: DataConfig, *, start_step: int = 0, prefetch: int = 2
                  ) -> Iterator[dict[str, np.ndarray]]:
    """Resumable prefetching pipeline starting at ``start_step``."""
    ds = SyntheticLM(cfg)

    def gen():
        step = start_step
        while True:
            yield ds.batch_at(step)
            step += 1

    return _Prefetcher(gen(), depth=prefetch) if prefetch else gen()
