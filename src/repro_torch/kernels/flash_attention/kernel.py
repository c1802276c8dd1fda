"""CUDA launchers of the three flash attention kernels (``csrc/flash_attention.cu``).

Replace ``repro/kernels/flash_attention/kernel.py``:
``flash_attention_fwd_pallas`` → ``flash_fwd_cuda``,
``flash_attention_bwd_dq_pallas`` → ``flash_bwd_dq_cuda`` and
``flash_attention_bwd_dkv_pallas`` → ``flash_bwd_dkv_cuda``. Each takes and
returns what its Pallas kernel does, in the kernels' layout — q/o/do/dq
(B, NQ, Sq, D), k/v/dk/dv (B, NKV, Sk, D), lse/delta (B, NQ, Sq) f32, kvlen
(B,) or (B, 1) int32 — with two differences: the sequence lengths need not
be multiples of a block (the kernels mask the ragged tiles instead of the
wrapper padding them), and any strides are taken as long as the head dim is
contiguous, so the op passes transposed views of the model's (B, S, H, D)
tensors and copies nothing. Outputs are allocated with their input's
strides. The Pallas block sizes are TPU tiles and are not taken. In bf16 up
to head dim 128 the forward and dQ give each warp a 16-row strip with every
output column (4 warps, 64 rows a block) and sweep K/V in 32-key bf16
tiles brought in by ``cp.async``, with bf16 products on the tensor cores
(P and dS as a hi/lo bf16 pair). Otherwise all three kernels give each
warp a 16-row strip (8 warps, 128 rows a block up to head dim 64; 4 warps,
32 rows above, two warps to a strip) and sweep the other side in 16-row
tiles brought in by ``cp.async``, with every product on the tensor cores in
3xTF32 (about f32 accuracy); the forward keeps its online softmax per strip
and adds each tile's P·V to O in f32.

The bound on the card, the design and the masks are described in the CUDA
source. The library is built by ``common.load_cuda`` at the first launch;
each launch goes on PyTorch's current stream, adds one to its count in
``common.LAUNCHES`` and raises on the error the launch reports.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import common

SOURCES = ("flash_attention/csrc/flash_attention.cu",)
PARTS = 7  # the source's FLASH_PARTS: compiled side by side (``common.load_cuda``)
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FWD, _DQ, _DKV = 0, 1, 2
_MAX_GRID_YZ = 65535  # the grid's y (heads) and z (batch) limit


class _Params(ctypes.Structure):
    """The CUDA source's ``Params``, field for field (all 8 bytes wide)."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in
         ("q", "k", "v", "dout", "o", "dq", "dk", "dv", "lse", "delta", "kvlen")]
        + [("st", ctypes.c_longlong * 24)]
        + [(n, ctypes.c_longlong) for n in ("B", "NQ", "NKV", "Sq", "Sk", "D", "causal")]
        + [("scale", ctypes.c_double)]
    )


@functools.cache
def load_library(sources: tuple[str, ...] = SOURCES) -> ctypes.CDLL:
    """The built and loaded kernel library (built at the first call). Other
    ``sources`` (absolute paths, with this library's ``Params`` and parts)
    build a second library beside it, for ``bench`` to time one against the
    other; the launchers always take the default."""
    lib = common.load_cuda("flash_attention" if sources == SOURCES else "flash_attention_other",
                           sources, PARTS)
    lib.flash_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.flash_launch.restype = ctypes.c_int
    lib.flash_error_string.argtypes = [ctypes.c_int]
    lib.flash_error_string.restype = ctypes.c_char_p
    lib.flash_params_size.argtypes = []
    lib.flash_params_size.restype = ctypes.c_int
    lib.flash_parts.argtypes = []
    lib.flash_parts.restype = ctypes.c_int
    if lib.flash_parts() != PARTS:
        raise RuntimeError(f"flash_attention library: {lib.flash_parts()} parts, the wrapper builds {PARTS}")
    if lib.flash_params_size() != ctypes.sizeof(_Params):
        raise RuntimeError(f"flash_attention library: Params is {lib.flash_params_size()} bytes, "
                           f"the wrapper's {ctypes.sizeof(_Params)}")
    return lib


def _operand(name: str, t: torch.Tensor, shape: tuple, dtype) -> torch.Tensor:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected dtype {dtype}, got {t.dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the CUDA kernel needs a CUDA tensor, got {t.device}")
    return t if t.stride(-1) == 1 else t.contiguous()


def _check(q, k, v, kvlen):
    """Validated (q, k, v, kvlen (B,) int32) and the dims (B, NQ, NKV, Sq, Sk, D)."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q, k: expected (B, H, S, D), got {tuple(q.shape)}, {tuple(k.shape)}")
    B, NQ, Sq, D = q.shape
    NKV, Sk = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES:
        raise ValueError(f"q: the flash kernels take {tuple(_DTYPES)}, got {q.dtype}")
    if not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {D}: the flash kernels take 1..{MAX_HEAD_DIM}")
    if NKV == 0 or NQ % NKV:
        raise ValueError(f"{NQ} query heads are not a multiple of {NKV} kv heads")
    if B > _MAX_GRID_YZ or max(NQ, NKV) > _MAX_GRID_YZ:
        raise ValueError(f"batch {B} or heads {NQ} above the launch grid's {_MAX_GRID_YZ}")
    q = _operand("q", q, (B, NQ, Sq, D), q.dtype)
    k = _operand("k", k, (B, NKV, Sk, D), q.dtype)
    v = _operand("v", v, (B, NKV, Sk, D), q.dtype)
    if kvlen.numel() != B or kvlen.dtype != torch.int32 or kvlen.device != q.device:
        raise ValueError(f"kvlen: expected {B} int32 lengths on {q.device}, got "
                         f"{tuple(kvlen.shape)} {kvlen.dtype} on {kvlen.device}")
    return q, k, v, kvlen.reshape(B).contiguous(), (B, NQ, NKV, Sq, Sk, D)


def _launch(which: int, name: str, dims: tuple, causal: bool, kvlen: torch.Tensor,
            tensors: dict, rows: dict) -> None:
    """Fill ``Params`` and launch kernel ``which`` on the current stream."""
    B, NQ, NKV, Sq, Sk, D = dims
    p = _Params(B=B, NQ=NQ, NKV=NKV, Sq=Sq, Sk=Sk, D=D, causal=int(causal), scale=D**-0.5,
                kvlen=kvlen.data_ptr())
    for i, field in enumerate(("q", "k", "v", "dout", "o", "dq", "dk", "dv")):
        t = tensors.get(field)
        if t is not None:
            setattr(p, field, t.data_ptr())
            p.st[3 * i: 3 * i + 3] = t.stride()[:3]
    for field, t in rows.items():  # lse, delta: (B, NQ, Sq) contiguous f32
        setattr(p, field, t.data_ptr())
    lib = load_library()
    stream = torch.cuda.current_stream(kvlen.device).cuda_stream
    with torch.cuda.device(kvlen.device):
        err = lib.flash_launch(which, ctypes.byref(p), _DTYPES[tensors["q"].dtype], stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}: {lib.flash_error_string(err).decode()}")
    common.LAUNCHES[name] += 1


def _rows(name: str, t: torch.Tensor, shape: tuple) -> torch.Tensor:
    return _operand(name, t, shape, torch.float32).contiguous()


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kvlen: torch.Tensor, *,
                   causal: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """``(o, lse)``: attention (B, NQ, Sq, D) in q's dtype and strides, and
    the (B, NQ, Sq) f32 logsumexp the backward recomputes P from."""
    q, k, v, kvlen, dims = _check(q, k, v, kvlen)
    B, NQ, _, Sq, _, _ = dims
    o = torch.empty_like(q)
    lse = torch.empty((B, NQ, Sq), dtype=torch.float32, device=q.device)
    if o.numel():
        _launch(_FWD, "flash_fwd", dims, causal, kvlen, {"q": q, "k": k, "v": v, "o": o},
                {"lse": lse})
    return o, lse


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, kvlen, *, causal: bool = True) -> torch.Tensor:
    """dQ (B, NQ, Sq, D) in q's dtype and strides."""
    q, k, v, kvlen, dims = _check(q, k, v, kvlen)
    B, NQ, _, Sq, _, _ = dims
    do = _operand("do", do, q.shape, q.dtype)
    rows = {"lse": _rows("lse", lse, (B, NQ, Sq)), "delta": _rows("delta", delta, (B, NQ, Sq))}
    dq = torch.empty_like(q)
    if dq.numel():
        _launch(_DQ, "flash_bwd_dq", dims, causal, kvlen,
                {"q": q, "k": k, "v": v, "dout": do, "dq": dq}, rows)
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, kvlen, *,
                       causal: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV), each (B, NKV, Sk, D) in k's dtype and strides."""
    q, k, v, kvlen, dims = _check(q, k, v, kvlen)
    B, NQ, _, Sq, _, _ = dims
    do = _operand("do", do, q.shape, q.dtype)
    rows = {"lse": _rows("lse", lse, (B, NQ, Sq)), "delta": _rows("delta", delta, (B, NQ, Sq))}
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if dk.numel():
        _launch(_DKV, "flash_bwd_dkv", dims, causal, kvlen,
                {"q": q, "k": k, "v": v, "dout": do, "dk": dk, "dv": dv}, rows)
    return dk, dv
