"""Shared kernel-op plumbing: dispatch by the tensors' device, lazy builds.

``repro.kernels.common.default_interpret`` chose between a compiled and an
interpreted Pallas kernel from the backend. Here the choice follows the
tensors themselves: CPU tensors take a kernel's plain PyTorch version, CUDA
tensors launch the kernel (Triton or CUDA C++), and a CUDA launch never
falls back — a missing ``triton`` or ``nvcc``, a failed build or a failed
launch raises.

Both kinds of kernel are built at their first launch, never at import, so
every module of the port imports on a machine without a card, ``triton`` or
``nvcc``:

- Triton is imported inside the launching functions (``import_triton``); its
  compile cache goes to ``build/triton`` at the repository root unless
  ``TRITON_CACHE_DIR`` is already set.
- CUDA C++ sources under ``kernels/*/csrc/`` are compiled by ``load_cuda``
  with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
  interface under ``build/cuda/``, named by a hash of the sources and flags,
  and loaded with ``ctypes``. The wrappers launch on PyTorch's current
  stream and raise on any CUDA error the launch reports.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
KERNELS_DIR = Path(__file__).resolve().parent
# -O3 without --use_fast_math: expf/logf must round as the plain versions' do
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17", "--shared",
              "-Xcompiler", "-fPIC")
NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")  # the toolkit's usual home
FLOATS = (torch.float32, torch.bfloat16, torch.float16)  # what the kernels take
SWEEP_ROW_BYTES = (8192, 4096, 2048, 1024, 512)  # a K-sweep's F tiles, bytes a row, widest first
SWEEP_PROGRAMS_PER_SM = 2  # a K-sweep's tile is no wider than leaves each SM this many
DOTS_KB = 4  # idgi_dots: steps (rows of g) a program sweeps together, sharing one diff load
DOTS_ROW_BYTES = 4096  # idgi_dots: a tile's bytes a row, 32 bytes (two loads) a thread a row
DOTS_PROGRAMS_PER_SM = 2  # idgi_dots: split F until each SM has this many programs
DOTS_MIN_CHUNK_TILES = 4  # idgi_dots: an F chunk is never narrower than this many tiles

# Kernel launches by kernel name. Each kernel wrapper adds one per launch and
# nothing else touches the counts, so a run can show which kernels it reached.
LAUNCHES: dict[str, int] = {
    "interpolate": 0,
    "ig_accum": 0,
    "idgi_dots": 0,
    "ig_accum_sq": 0,
    "interp_add": 0,
    "accum_cot": 0,
    "flash_fwd": 0,
    "flash_bwd_dq": 0,
    "flash_bwd_dkv": 0,
    "wls_solve": 0,
}
# interp_add's launches by carry rank, counted beside LAUNCHES: 2 is the
# (B, F) carry broadcast over the steps, 3 the (B, K, F) per-step carry
CARRY_RANKS: dict[int, int] = {2: 0, 3: 0}


def reset_launches() -> None:
    """Set every launch count to 0."""
    for counts in (LAUNCHES, CARRY_RANKS):
        for name in counts:
            counts[name] = 0


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


@functools.cache
def sm_count(device: torch.device | str = "cuda") -> int:
    """The number of SMs of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def sweep_tile(B: int, F: int, dtype: torch.dtype, sms: int) -> tuple[int, int]:
    """(BLOCK_F, num_warps) of a K-sweep over (B, K, F): one program per
    (row, F tile), each thread summing its own columns over K with 16-byte
    loads. The tile is the widest of ``SWEEP_ROW_BYTES`` bytes a row that
    gives at least ``SWEEP_PROGRAMS_PER_SM`` programs to each of ``sms``
    SMs, else the narrowest (one warp, one 16-byte load a thread a row); a
    thread takes 64 bytes of a row (four loads) where the tile has 2048
    bytes or more. In f32 that is 128 to 2048 columns, in bf16 256 to 4096.

        >>> sweep_tile(16, 150_528, torch.float32, 132), sweep_tile(16, 3072, torch.float32, 132)
        ((2048, 4), (128, 1))
        >>> sweep_tile(16, 150_528, torch.bfloat16, 132), sweep_tile(16, 3072, torch.bfloat16, 132)
        ((4096, 4), (256, 1))
    """
    cols = [nbytes // dtype.itemsize for nbytes in SWEEP_ROW_BYTES]
    block = next((c for c in cols if B * -(-F // c) >= SWEEP_PROGRAMS_PER_SM * sms), cols[-1])
    return block, max(1, block * dtype.itemsize // 2048)


class DotsPlan(NamedTuple):
    """How ``idgi_dots`` cuts (B, K, F): one program per (row, block of
    ``kb`` steps, F chunk), ``split`` chunks of ``chunk`` columns (the last
    one ragged), each swept in ``block_f``-wide tiles on ``num_warps``."""

    kb: int
    split: int
    chunk: int
    block_f: int
    num_warps: int


def dots_plan(B: int, K: int, F: int, dtype: torch.dtype, sms: int) -> DotsPlan:
    """The plan of ``idgi_dots`` over (B, K, F) on ``sms`` SMs: ``DOTS_KB``
    steps a program (past K masked), so one load of diff serves that many
    rows of g; a tile of ``DOTS_ROW_BYTES`` bytes a row on 4 warps, 32
    bytes (two 16-byte loads) a thread a row; and F split into chunks of
    whole tiles until each SM has ``DOTS_PROGRAMS_PER_SM`` programs, but no
    chunk narrower than ``DOTS_MIN_CHUNK_TILES`` tiles. With a split the
    chunks' partial sums take a second, small pass.

        >>> dots_plan(16, 16, 150_528, torch.float32, 132)
        DotsPlan(kb=4, split=5, chunk=30720, block_f=1024, num_warps=4)
        >>> dots_plan(16, 64, 3072, torch.float32, 132)
        DotsPlan(kb=4, split=1, chunk=3072, block_f=1024, num_warps=4)
        >>> dots_plan(16, 16, 150_528, torch.bfloat16, 132).split, dots_plan(16, 64, 3072, torch.bfloat16, 132)
        (5, DotsPlan(kb=4, split=1, chunk=4096, block_f=2048, num_warps=4))
    """
    cdiv = lambda a, b: -(-a // b)
    block = DOTS_ROW_BYTES // dtype.itemsize
    tiles = max(1, cdiv(F, block))
    want = cdiv(DOTS_PROGRAMS_PER_SM * sms, B * cdiv(K, DOTS_KB))
    split = max(1, min(want, tiles // DOTS_MIN_CHUNK_TILES))
    per = cdiv(tiles, split)  # whole tiles a chunk; no chunk is left empty
    return DotsPlan(DOTS_KB, cdiv(tiles, per), per * block, block, DOTS_ROW_BYTES // (32 * 32))


def check_flat(name: str, t: torch.Tensor, shape: tuple, dtypes: tuple) -> torch.Tensor:
    """Validate one kernel operand (shape, dtype, device) and make it contiguous."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: expected dtype in {dtypes}, got {t.dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel needs a CUDA tensor, got {t.device}")
    return t.contiguous()


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default directory. Raises ``RuntimeError`` when none exists."""
    home = os.environ.get("CUDA_HOME")
    for cand in (Path(home) / "bin" / "nvcc" if home else None, shutil.which("nvcc"), NVCC_DEFAULT):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("CUDA inputs need nvcc (CUDA_HOME, PATH or /usr/local/cuda/bin) "
                       "to build the port's CUDA kernels")


@functools.cache
def load_cuda(name: str, sources: tuple[str, ...], parts: int = 1) -> ctypes.CDLL:
    """Build (at first use) and load the shared library ``name`` from
    ``sources``, paths relative to ``kernels/``.

    The library lands in ``build/cuda/<name>-<hash>.so``, the hash taken over
    the sources, the headers beside them and the flags, so an edited source
    rebuilds and an unchanged one is loaded as it is. The build writes a
    temporary file and renames it, so processes building at once never load
    half a library. Raises ``RuntimeError`` with nvcc's output if it fails.

    With ``parts`` > 1 each source is compiled ``parts`` times at once, with
    ``-DKERNEL_PART=0`` to ``parts - 1`` (the source says which kernels each
    part holds), and the objects are linked into the library: the build
    takes about as long as its slowest part, not the sum of them.
    """
    paths = [KERNELS_DIR / s for s in sources]
    deps = sorted({h for p in paths for h in p.parent.glob("*.cuh")} | set(paths))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    if parts > 1:
        digest.update(f"parts {parts}".encode())
    for p in deps:
        digest.update(p.name.encode() + p.read_bytes())
    out = BUILD_DIR / "cuda" / f"{name}-{digest.hexdigest()[:16]}.so"
    if not out.exists():
        nvcc = find_nvcc()
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        if parts == 1:
            _nvcc([[nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]], tmp)
        else:
            flags = [f for f in NVCC_FLAGS if f != "--shared"]
            objs = [out.with_name(f"{out.stem}.{os.getpid()}.{j}.{i}.o")
                    for j in range(len(paths)) for i in range(parts)]
            try:
                _nvcc([[nvcc, *flags, f"-DKERNEL_PART={i}", "-c", "-o", str(objs[j * parts + i]), str(p)]
                       for j, p in enumerate(paths) for i in range(parts)], tmp)
                _nvcc([[nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, objs)]], tmp)
            finally:
                for o in objs:
                    o.unlink(missing_ok=True)
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))


def _nvcc(cmds: list[list[str]], tmp: Path) -> None:
    """Run the nvcc commands all at once; on any failure remove ``tmp`` and
    raise ``RuntimeError`` with the first failed command and its output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for c in cmds]
    outs = [p.communicate() for p in procs]
    for cmd, proc, (so, se) in zip(cmds, procs, outs):
        if proc.returncode:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{so}{se}")
