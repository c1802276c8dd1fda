"""Sharded checkpoints of the port, as ``repro.checkpoint``: the same
files, so either package restores the other's."""
from repro_torch.checkpoint.manager import (
    CheckpointManager,
    atomic_dir,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    sha256_file,
)

__all__ = [
    "CheckpointManager",
    "save_checkpoint",
    "restore_checkpoint",
    "latest_step",
    "atomic_dir",
    "sha256_file",
]
