"""Shared kernel-op plumbing: dispatch by the tensors' device, lazy Triton.

``repro.kernels.common.default_interpret`` chose between a compiled and an
interpreted Pallas kernel from the backend. Here the choice follows the
tensors themselves: CPU tensors take a kernel's plain PyTorch version, CUDA
tensors launch the Triton kernel, and a CUDA launch never falls back — a
missing ``triton`` or a failed launch raises.

Triton is imported only inside the launching functions (``import_triton``),
so every module of the port imports on a machine without it. Its compile
cache goes to ``build/triton`` at the repository root unless
``TRITON_CACHE_DIR`` is already set.
"""
from __future__ import annotations

import os
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
FLOATS = (torch.float32, torch.bfloat16, torch.float16)  # what the kernels take

# Kernel launches by kernel name. Each Triton wrapper adds one per launch and
# nothing else touches the counts, so a run can show which kernels it reached.
LAUNCHES: dict[str, int] = {
    "interpolate": 0,
    "ig_accum": 0,
    "interp_add": 0,
    "accum_cot": 0,
}


def reset_launches() -> None:
    """Set every launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device, False when every one
    lies on the CPU; raises on a mix or on any other device type.

        >>> on_cuda(torch.zeros(2), torch.ones(1))
        False
    """
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"kernel inputs must all lie on the CPU or all on CUDA, got {sorted(kinds)}")


def import_triton():
    """``(triton, triton.language)``, with the compile cache under ``build/``.

    Raises ``RuntimeError`` when Triton is not installed: a CUDA tensor
    never quietly takes the plain version instead of its kernel.
    """
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))
    try:
        import triton
        import triton.language as tl
    except ImportError as e:
        raise RuntimeError("CUDA inputs need the triton package to launch the port's kernels") from e
    return triton, tl


def check_flat(name: str, t: torch.Tensor, shape: tuple, dtypes: tuple) -> torch.Tensor:
    """Validate one kernel operand (shape, dtype, device) and make it contiguous."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: expected dtype in {dtypes}, got {t.dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the Triton kernel needs a CUDA tensor, got {t.device}")
    return t.contiguous()
