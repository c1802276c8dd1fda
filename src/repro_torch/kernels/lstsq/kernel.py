"""CUDA launcher of the batched Gauss–Jordan solve (``csrc/lstsq.cu``).

Replaces ``repro/kernels/lstsq/kernel.py`` ``wls_solve_pallas`` →
``wls_solve_cuda``: A (B, N, N) and rhs (B, N), a prepared system
(``ref.prepare_normal_eqs``), solved per batch row without pivoting, in
float32 or float64. One difference: the Pallas op pads N to the TPU's
sublane multiple of 8 with identity rows, which never couple to the real
block; the CUDA kernel takes any N, so nothing is padded. An N whose system
does not fit in a block's shared memory raises; nothing takes the kernel's
place.

The bound on the card and the design are described in the CUDA source. The
library is built by ``common.load_cuda`` at the first launch; the launch goes
on PyTorch's current stream, adds one to ``common.LAUNCHES["wls_solve"]``
and raises on the error it reports.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import common

SOURCES = ("lstsq/csrc/lstsq.cu",)
_DTYPES = {torch.float32: 0, torch.float64: 1}
_MAX_GRID_X = 2**31 - 1


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built and loaded kernel library (built at the first call)."""
    lib = common.load_cuda("lstsq", SOURCES)
    lib.wls_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                               ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.wls_launch.restype = ctypes.c_int
    lib.wls_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.wls_smem_bytes.restype = ctypes.c_longlong
    lib.wls_error_string.argtypes = [ctypes.c_int]
    lib.wls_error_string.restype = ctypes.c_char_p
    return lib


def wls_solve_cuda(A: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """A (B, N, N), rhs (B, N), both float32 or both float64 on one CUDA
    device -> β (B, N) in their dtype, with (A) β = rhs per row."""
    if A.dim() != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"A: expected (B, N, N), got {tuple(A.shape)}")
    B, N = A.shape[0], A.shape[1]
    if A.dtype not in _DTYPES:
        raise ValueError(f"A: the solve kernel takes {tuple(_DTYPES)}, got {A.dtype}")
    if B > _MAX_GRID_X:
        raise ValueError(f"batch {B} above the launch grid's {_MAX_GRID_X}")
    A = common.check_flat("A", A, (B, N, N), (A.dtype,))
    rhs = common.check_flat("rhs", rhs, (B, N), (A.dtype,))
    out = torch.empty_like(rhs)
    if not out.numel():
        return out
    lib = load_library()
    dt = _DTYPES[A.dtype]
    need = lib.wls_smem_bytes(N, dt)
    have = torch.cuda.get_device_properties(A.device).shared_memory_per_block_optin
    if need > have:
        raise ValueError(f"wls_solve: an {N}×{N} {A.dtype} system needs {need} bytes of shared "
                         f"memory, a block has {have}")
    stream = torch.cuda.current_stream(A.device).cuda_stream
    with torch.cuda.device(A.device):
        err = lib.wls_launch(A.data_ptr(), rhs.data_ptr(), out.data_ptr(), B, N, dt, stream)
    if err:
        raise RuntimeError(f"wls_solve: CUDA error {err}: {lib.wls_error_string(err).decode()}")
    common.LAUNCHES["wls_solve"] += 1
    return out
