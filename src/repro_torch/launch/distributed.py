"""Process-group start-up: ``repro.launch.distributed`` over ``torch.distributed``.

``init_distributed`` reads the world from the environment — torchrun's
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``, or ``repro``'s launch contract ``COORDINATOR_ADDR``
(host:port of process 0), ``NUM_PROCESSES`` and ``PROCESS_ID`` — and starts
the default process group on the backend the caller names: ``nccl`` with a
card a rank, ``gloo`` on the CPU or where ranks share a card (NCCL refuses
two ranks on one device). The backend is never switched behind the
caller's back. A world of one process (no variables set) starts its group
over an in-process store.

    torchrun --nproc-per-node 2 -m repro_torch.launch.explain \\
        --device cpu --dist-backend gloo --mesh 2,1
"""
from __future__ import annotations

import os
from datetime import timedelta
from typing import Any

import torch
import torch.distributed as dist

TIMEOUT_S = 600  # every collective fails after this long instead of hanging


def world_from_env() -> tuple[int, int, int, str]:
    """(rank, world size, local rank, init method) from torchrun's variables
    or ``repro``'s; a world of 1 when neither is set."""
    if "WORLD_SIZE" in os.environ:
        rank, size = int(os.environ.get("RANK", "0")), int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        addr = f"tcp://{os.environ.get('MASTER_ADDR', 'localhost')}:{os.environ.get('MASTER_PORT', '29500')}"
        return rank, size, local, addr
    size = int(os.environ.get("NUM_PROCESSES", "1"))
    rank = int(os.environ.get("PROCESS_ID", "0"))
    return rank, size, rank, f"tcp://{os.environ.get('COORDINATOR_ADDR', 'localhost:29500')}"


def init_distributed(backend: str, *, timeout_s: float = TIMEOUT_S) -> dict:
    """Start the default process group from the environment on ``backend``
    (``nccl`` or ``gloo``) with a finite ``timeout_s``; with ``nccl`` the
    rank's card is ``cuda:LOCAL_RANK``. Returns ``repro``'s summary: this
    process's index, the process count, the devices this process drives and
    the devices of the world (one each)."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    rank, size, local, addr = world_from_env()
    if not dist.is_initialized():
        if backend == "nccl":
            torch.cuda.set_device(local)
        where = {"init_method": addr} if size > 1 else {"store": dist.HashStore()}
        dist.init_process_group(backend, rank=rank, world_size=size, timeout=timedelta(seconds=timeout_s),
                                **where)
    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": 1,
        "global_devices": dist.get_world_size(),
    }


def global_batch_from_process(global_batch: int) -> tuple[int, int]:
    """(local_batch, offset) for this process's slice of the data pipeline."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    i = dist.get_rank() if dist.is_initialized() else 0
    assert global_batch % n == 0, (global_batch, n)
    local = global_batch // n
    return local, i * local


def assemble_global(mesh, specs: Any, local_tensors: Any) -> Any:
    """Global DTensors from each process's local slice along the batch
    (``DTensor.from_local`` with the spec's placements: ``Shard(0)`` on the
    data axes). ``specs`` and ``local_tensors`` are matching dicts, tuples or
    single entries."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding import PartitionSpec, to_placements

    def one(spec, t):
        return DTensor.from_local(t, mesh, to_placements(spec, mesh), run_check=False)

    if isinstance(specs, PartitionSpec):
        return one(specs, local_tensors)
    if isinstance(specs, dict):
        return {k: assemble_global(mesh, specs[k], local_tensors[k]) for k in specs}
    return type(specs)(assemble_global(mesh, s, t) for s, t in zip(specs, local_tensors))


__all__ = ["TIMEOUT_S", "assemble_global", "global_batch_from_process", "init_distributed", "world_from_env"]
