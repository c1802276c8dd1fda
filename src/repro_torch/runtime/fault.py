"""Retry, straggler detection, elastic remeshing and the recovering
training loop of ``repro.runtime.fault``.

  RetryPolicy       — bounded exponential backoff for transient failures of
                      one work item.
  StragglerMonitor  — wall-time EWMA per item; flags items slower than
                      ``straggler_threshold`` × the running mean.
  ElasticMesh       — rebuilds a (pod, data, model) mesh after losing
                      ranks: the data axis shrinks to the largest size the
                      survivors support with model parallelism intact; the
                      batch is rescaled checkpoint-consistently.
  run_with_recovery — the training loop: step, checkpoint, and on a failure
                      restore from the checkpoint manager and replay.
  StateSpoiled      — what a step raises when it failed after it began to
                      overwrite its state in place.

``MixedScheduler`` runs every model-executing work item under the first
two.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

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


class StateSpoiled(RuntimeError):
    """A step failed after it began to update its state in place (the
    port's train step overwrites the parameters and moments leaf by leaf):
    the state it was given is neither the old one nor the new one, so a
    retry on it would replay the step on half-updated values.
    ``run_with_recovery`` resumes from it only through a checkpoint
    restore. ``repro``'s step is functional and never spoils its input."""


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


@dataclass
class ElasticMesh:
    """Elastic remeshing after losing ranks.

    ``model_size`` is preserved (TP groups cannot shrink without resharding
    weights); the data axis absorbs the loss. The global batch is rescaled
    to keep the batch a rank constant, and the caller replays data from the
    last checkpoint step so the sample order stays deterministic.
    """

    model_size: int
    data_size: int
    pod_size: int = 1

    @property
    def device_count(self) -> int:
        return self.model_size * self.data_size * self.pod_size

    def after_loss(self, surviving_devices: int) -> "ElasticMesh":
        if surviving_devices >= self.device_count:
            return self
        per_pod = surviving_devices // max(self.pod_size, 1)
        new_data = per_pod // self.model_size
        # drop pods before starving the data axis entirely
        pods = self.pod_size
        while new_data < 1 and pods > 1:
            pods -= 1
            per_pod = surviving_devices // pods
            new_data = per_pod // self.model_size
        if new_data < 1:
            raise RuntimeError(f"cannot rebuild mesh: {surviving_devices} devices < model_size {self.model_size}")
        return ElasticMesh(self.model_size, new_data, pods)

    def rescale_batch(self, global_batch: int, old: "ElasticMesh") -> int:
        """Keep the batch a data rank fixed; round to a multiple of the new DP size."""
        dp_old = old.data_size * old.pod_size
        dp_new = self.data_size * self.pod_size
        per_dp = global_batch // dp_old
        return max(per_dp * dp_new, dp_new)

    def make_mesh(self, devices=None, device_type: str = "cuda"):
        """A ``DeviceMesh`` over the first ``device_count`` ranks of
        ``devices`` (default: every rank of the world), (pod, data, model) or
        (data, model). Every rank of the world takes part in building it: on
        a mesh's controller (rank 0 while its workers serve) the workers are
        brought in through ``sharding.dispatch.run_everywhere``."""
        import torch.distributed as dist

        from repro_torch.launch.mesh import mesh_over
        from repro_torch.sharding import dispatch

        ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
        n = self.device_count
        if len(ranks) < n:
            raise RuntimeError(f"mesh of {n} needs {n} ranks; {len(ranks)} given")
        if self.pod_size > 1:
            shape, names = (self.pod_size, self.data_size, self.model_size), ("pod", "data", "model")
        else:
            shape, names = (self.data_size, self.model_size), ("data", "model")
        build = dispatch.run_everywhere if dispatch.active() else (lambda fn, *a: fn(*a))
        return build(mesh_over, ranks[:n], shape, names, device_type)


def run_with_recovery(
    step_fn: Callable[[Any, Any], tuple[Any, dict]],
    state: Any,
    batches: Any,
    *,
    num_steps: int,
    ckpt_manager=None,
    ckpt_every: int = 0,
    fault_cfg: FaultConfig = FaultConfig(),
    monitor: Optional[StragglerMonitor] = None,
    start_step: int = 0,
) -> tuple[Any, list[dict]]:
    """The training loop: step, checkpoint, and on failure restore + replay.

    ``batches`` is indexable by global step (the deterministic pipeline
    contract: ``batch_at(step)`` or ``[step]``), so replay after a restore
    is exact. A failed step backs off exponentially and, with a checkpoint
    manager, rolls the state and the history back to its newest valid
    checkpoint; more than ``max_retries`` failures in a row raise. A
    ``StateSpoiled`` failure with no checkpoint to restore raises at once.
    """
    history: list[dict] = []
    step = start_step
    failures = 0
    while step < num_steps:
        batch = batches.batch_at(step) if hasattr(batches, "batch_at") else batches[step]
        t0 = time.perf_counter()
        try:
            state, metrics = step_fn(state, batch)
        except Exception as e:  # noqa: BLE001 — transient-fault boundary
            failures += 1
            spoiled = isinstance(e, StateSpoiled)
            if failures > fault_cfg.max_retries or (spoiled and ckpt_manager is None):
                raise
            time.sleep(min(fault_cfg.backoff_base_s * 2 ** (failures - 1), fault_cfg.backoff_cap_s))
            if ckpt_manager is not None:
                restored_step, restored = ckpt_manager.restore_latest(state)
                if restored_step is not None:
                    # roll back and REPLAY: the deterministic pipeline
                    # re-serves identical batches for the replayed steps.
                    # The checkpoint may predate start_step (a manager shared
                    # across runs): clamp the history cut to 0 — a negative
                    # slice would silently KEEP the wrong suffix.
                    state = restored
                    history = history[: max(restored_step - start_step, 0)]
                    step = restored_step
                elif spoiled:
                    raise
            continue
        failures = 0
        wall = time.perf_counter() - t0
        if monitor is not None:
            metrics = dict(metrics)
            metrics["straggler"] = monitor.observe(wall)
        history.append(metrics)
        step += 1
        if ckpt_manager is not None and ckpt_every and step % ckpt_every == 0:
            ckpt_manager.save(step, state)
    if ckpt_manager is not None:
        ckpt_manager.wait()
    return state, history
