"""Retry and straggler detection of ``repro.runtime.fault``, which hold no JAX.

  RetryPolicy       — bounded exponential backoff for transient failures of
                      one work item.
  StragglerMonitor  — wall-time EWMA per item; flags items slower than
                      ``straggler_threshold`` × the running mean.

``MixedScheduler`` runs every model-executing work item under both. Not
ported yet: ``ElasticMesh`` (it builds a ``jax.sharding.Mesh``) and
``run_with_recovery`` (a training driver over a checkpoint manager) wait
on the mesh and the training modules (ROADMAP.md queue 1, item 7).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np


@dataclass(frozen=True)
class FaultConfig:
    max_retries: int = 3
    backoff_base_s: float = 0.1
    backoff_cap_s: float = 30.0
    straggler_threshold: float = 2.0
    straggler_ewma: float = 0.9
    # the EWMA seeds from the MEDIAN of the first k observations: the first
    # item is typically a cold build (10–100× steady state), and because
    # stragglers never update the mean, a first-item seed would leave the
    # monitor blind for the whole run
    straggler_warmup: int = 3


class RetryPolicy:
    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg

    def __call__(self, fn: Callable, *args, on_retry: Optional[Callable] = None, **kw):
        """``fn(*args, **kw)``, retried up to ``max_retries`` times with
        exponential backoff; the last failure is raised."""
        for attempt in range(self.cfg.max_retries + 1):
            try:
                return fn(*args, **kw)
            except Exception as e:  # noqa: BLE001 — transient-fault boundary
                if attempt == self.cfg.max_retries:
                    raise
                if on_retry is not None:
                    on_retry(attempt, e)
                time.sleep(min(self.cfg.backoff_base_s * 2**attempt, self.cfg.backoff_cap_s))
        raise AssertionError("unreachable")


class StragglerMonitor:
    """EWMA of item wall time; ``observe`` returns True for a straggler.

    The first ``cfg.straggler_warmup`` observations are warmup: collected,
    never flagged, and the mean seeds from their median.
    """

    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg
        self.mean: Optional[float] = None
        self.flagged: list[int] = []
        self._step = 0
        self._warm: list[float] = []

    def observe(self, wall_s: float) -> bool:
        self._step += 1
        if self.mean is None:
            self._warm.append(wall_s)
            if len(self._warm) >= max(self.cfg.straggler_warmup, 1):
                self.mean = float(np.median(self._warm))
            return False
        is_straggler = wall_s > self.cfg.straggler_threshold * self.mean
        if is_straggler:
            self.flagged.append(self._step)
        else:  # stragglers do not poison the running mean
            a = self.cfg.straggler_ewma
            self.mean = a * self.mean + (1 - a) * wall_s
        return is_straggler
