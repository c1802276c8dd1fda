"""Checkpoint helpers of the port: ``repro.checkpoint.manager``'s streaming
file hash and atomic directory write, which warm-state persistence uses."""
from repro_torch.checkpoint.manager import atomic_dir, sha256_file

__all__ = ["atomic_dir", "sha256_file"]
