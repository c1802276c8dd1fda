"""CUDA launcher of the batched Gauss–Jordan solve (``csrc/lstsq.cu``).

Replaces ``repro/kernels/lstsq/kernel.py`` ``wls_solve_pallas`` →
``wls_solve_cuda``: A (B, N, N) and rhs (B, N), a prepared system
(``ref.prepare_normal_eqs``), solved per batch row without pivoting, in
float32 or float64. One difference: the Pallas op pads N to the TPU's
sublane multiple of 8 with identity rows, which never couple to the real
block; the CUDA kernels take any N, so nothing is padded.

Which kernel runs follows N (``solve_plan``, a pure function): a warp per
system with the sweep in registers up to N = 31 (LIME's 17 included), a
block per system with each thread's rows and columns in registers up to
N = 68 (the CNN zoo's 65), and the whole system in shared memory beyond.
The plan (variant, threads and systems a block, shared-memory bytes) is
worked out here alone and passed whole to the library's ``wls_launch``. An
N whose system does not fit in a block's shared memory raises; nothing
takes the kernel's place. The bound on the card and each design are
described in the CUDA source. The library is built by ``common.load_cuda``
at the first launch; the launch goes on PyTorch's current stream, adds one
to ``common.LAUNCHES["wls_solve"]`` and raises on the error it reports.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import common

SOURCES = ("lstsq/csrc/lstsq.cu",)
_DTYPES = {torch.float32: 0, torch.float64: 1}
_MAX_GRID_X = 2**31 - 1
WARP_MAX_N = 31  # the warp kernel: lane j holds column j of [A | b], N + 1 ≤ 32 lanes
WARP_SYSTEMS = 4  # the warp kernel: systems (one warp each) a block
# the register kernel: side × side threads a system, each holding REGS_R rows
# and REGS_R columns, so up to N = side·REGS_R; side ≤ REGS_MAX_SIDE, the
# block that lstsq.cu's __launch_bounds__ admits (N ≤ 68)
REGS_R, REGS_MAX_SIDE = 4, 17
SHARED_THREADS = 256  # the shared-memory kernel's block
# the library's codes of the variants, smallest systems first
VARIANTS = {"warp": 0, "regs4": 1, "shared": 2}


class SolvePlan(NamedTuple):
    """How ``wls_solve`` runs N×N systems: ``variant`` (a key of
    ``VARIANTS``), ``threads`` and ``systems`` a block, and the bytes of
    shared memory a block takes."""

    variant: str
    threads: int
    systems: int
    smem: int


def variant_plan(variant: str, N: int, dtype: torch.dtype) -> Optional[SolvePlan]:
    """The plan of one variant (a key of ``VARIANTS``) for N×N systems of
    ``dtype``, or None where the variant cannot hold N.

        >>> variant_plan("regs4", 17, torch.float32), variant_plan("warp", 32, torch.float32)
        (SolvePlan(variant='regs4', threads=25, systems=1, smem=328), None)
    """
    size = torch.empty((), dtype=dtype).element_size()
    if variant == "warp":
        return None if N > WARP_MAX_N else SolvePlan(variant, 32 * WARP_SYSTEMS, WARP_SYSTEMS, 0)
    if variant == "shared":
        return SolvePlan(variant, SHARED_THREADS, 1, size * (N * N + 3 * N + 1))
    side = -(-N // REGS_R)  # threads down and across; rows and columns past N are padding
    if side > REGS_MAX_SIDE:
        return None
    # two pivot rows (b_k last) and two pivot columns, double-buffered
    return SolvePlan(variant, side * side, 1, size * (4 * side * REGS_R + 2))


def solve_plan(N: int, dtype: torch.dtype, smem_limit: int) -> SolvePlan:
    """The solve's plan for N×N systems of ``dtype`` (float32 or float64):
    the first variant of ``VARIANTS`` that holds N. Raises ``ValueError``
    when the shared-memory variant's system exceeds ``smem_limit`` bytes,
    the shared memory a block of the card can opt into.

        >>> solve_plan(17, torch.float32, 232_448)
        SolvePlan(variant='warp', threads=128, systems=4, smem=0)
        >>> solve_plan(65, torch.float32, 232_448)
        SolvePlan(variant='regs4', threads=289, systems=1, smem=1096)
        >>> solve_plan(69, torch.float64, 232_448).variant
        'shared'
    """
    plan = next(p for v in VARIANTS if (p := variant_plan(v, N, dtype)) is not None)
    if plan.smem > smem_limit:
        raise ValueError(f"wls_solve: an {N}×{N} {dtype} system needs {plan.smem} bytes of shared "
                         f"memory, a block has {smem_limit}")
    return plan


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built and loaded kernel library (built at the first call)."""
    lib = common.load_cuda("lstsq", SOURCES)
    lib.wls_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_longlong, ctypes.c_void_p]
    lib.wls_launch.restype = ctypes.c_int
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
    limit = torch.cuda.get_device_properties(A.device).shared_memory_per_block_optin
    launch_solve(A, rhs, out, solve_plan(N, A.dtype, limit))
    common.LAUNCHES["wls_solve"] += 1
    return out


def launch_solve(A: torch.Tensor, rhs: torch.Tensor, out: torch.Tensor, plan: SolvePlan) -> None:
    """Solve checked operands into ``out`` with ``plan``'s kernel, a plan
    of ``variant_plan`` for their N and dtype; raises on the error the
    launch reports. Counts nothing (``wls_solve_cuda`` does)."""
    lib = load_library()
    stream = torch.cuda.current_stream(A.device).cuda_stream
    with torch.cuda.device(A.device):
        err = lib.wls_launch(A.data_ptr(), rhs.data_ptr(), out.data_ptr(), A.shape[0], A.shape[1],
                             _DTYPES[A.dtype], VARIANTS[plan.variant], plan.threads, plan.systems,
                             plan.smem, stream)
    if err:
        raise RuntimeError(f"wls_solve: CUDA error {err}: {lib.wls_error_string(err).decode()}")
