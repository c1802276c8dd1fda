"""What one rank's ops cost, counted as they run: the port's counterpart of
``repro.roofline.hlo_flops``, which parses the compiled HLO text.

The port has no compiled program to read, so ``OpCounter``, a
``TorchDispatchMode``, watches the eager program instead. It runs on the
``meta`` device (shapes only, nothing allocated) as well as on a card, and
records for every aten op that reaches it:

  * FLOPs by ``torch.utils.flop_counter``'s formulas (matmuls, convolutions,
    attention kernels; elementwise ops count none, as in XLA's ``flops``);
  * the matrix products' FLOPs by shape fingerprint (``matmul_flops_summary``,
    ``dot_flops_summary``'s keys);
  * the bytes each op reads and writes, its tensor inputs and outputs at
    their element counts (``op_bytes_by_op``, ``entry_bytes_by_op``'s
    counterpart). Eager PyTorch launches one kernel for each such op, so
    this is the eager program's traffic, without fusion. View ops (views,
    reshapes, transposes, expands) and allocations move nothing, as
    ``_FREE_OPS`` in ``repro``;
  * the live bytes: each new storage from its op until its last tensor
    dies, on top of the ``hold``-registered arguments, and their peak;
  * the operand bytes of each collective, by ``repro``'s kinds.

Over DTensor (``launch.cells.count_cell``), an op on DTensors is left to
DTensor (``NotImplemented``), which runs it on each rank's local shards and
any redistribution as functional collectives: the counter sees those local
ops, so every number is one rank's. DTensor's sharding propagation runs the
op once more on fake tensors of the global shapes to learn the output's
shape; those calls run under ``FakeTensorMode`` and are not counted.
"""
from __future__ import annotations

import weakref
from collections import defaultdict
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.analyze import COLLECTIVE_OPS

aten = torch.ops.aten

_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd", "c10d", "_dtensor")
# op-name fragment -> kind; the first hit wins
_COLLECTIVE_NAMES = (("all_gather", "all-gather"), ("allgather", "all-gather"),
                     ("reduce_scatter", "reduce-scatter"), ("all_reduce", "all-reduce"),
                     ("allreduce", "all-reduce"), ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                     ("permute", "collective-permute"), ("send", "collective-permute"),
                     ("recv", "collective-permute"), ("broadcast", "collective-permute"))
# ops that launch no kernel: allocations, metadata, host reads, waits
_FREE_OPS = {aten.empty.memory_format, aten.empty_strided.default, aten.empty_like.default,
             aten.new_empty.default, aten.new_empty_strided.default, aten._unsafe_view.default,
             aten._local_scalar_dense.default, aten.lift_fresh.default}
_MATMULS = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm}


def _tensors(tree: Any) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _type(t: torch.Tensor) -> str:
    return f"{str(t.dtype).removeprefix('torch.')}{list(t.shape)}"


def _collective_kind(func) -> str | None:
    """``repro``'s kind of a collective op (``torch.ops._c10d_functional``
    and kin), None for any other op or a wait."""
    if func.namespace not in _COLLECTIVE_NS or "wait" in func.__name__:
        return None
    return next((kind for frag, kind in _COLLECTIVE_NAMES if frag in func.__name__), None)


def _moves_nothing(func) -> bool:
    """A view, an allocation, a metadata op or a collective's wait."""
    return func.is_view or func in _FREE_OPS or (func.namespace in _COLLECTIVE_NS and "wait" in func.__name__)


class OpCounter(TorchDispatchMode):
    """Counts the ops that run while it is entered (``with OpCounter() as c:``).

    ``flops`` (the sum of the registry's formulas), ``matmuls`` (fingerprint -> [flops, count]), ``op_bytes`` (total) and
    ``bytes_by_op`` ("op -> out type" -> [bytes, count]), ``collectives``
    (kind -> operand bytes), ``live`` and ``peak`` (bytes), ``ops``."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.matmuls: dict[str, list] = defaultdict(lambda: [0, 0])
        self.op_bytes = 0
        self.bytes_by_op: dict[str, list] = defaultdict(lambda: [0, 0])
        self.collectives = dict.fromkeys(COLLECTIVE_OPS, 0)
        self.ops = 0
        self.live = 0
        self.peak = 0
        self._storages: dict[int, int] = {}

    # ------------------------------------------------------------- live bytes

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    def _track(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage live until ``t`` dies; 0 if already counted."""
        key = t.untyped_storage()._cdata
        if key in self._storages:
            return 0
        n = t.untyped_storage().nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._free, key)
        return n

    def hold(self, tree: Any) -> int:
        """Count the tensors of ``tree`` (a call's arguments, local shards of
        DTensors) live from now; returns their bytes."""
        from torch.distributed.tensor import DTensor

        return sum(self._track(t._local_tensor if isinstance(t, DTensor) else t) for t in _tensors(tree))

    # ---------------------------------------------------------------- dispatch

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it on the local shards, which come back here
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out  # DTensor's shape propagation on global fake tensors
        self.ops += 1
        packet = func._overloadpacket
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if packet in flop_registry:
            f = int(flop_registry[packet](*args, **kwargs, out_val=out))
            self.flops += f
            if packet in _MATMULS and outs:
                a, b = (ins[1], ins[2]) if packet in (aten.addmm, aten.baddbmm) else (ins[0], ins[1])
                row = self.matmuls[f"{_type(a)} . {_type(b)} -> {_type(outs[0])}"]
                row[0] += f
                row[1] += 1
        kind = _collective_kind(func)
        if kind is not None:
            self.collectives[kind] += sum(_nbytes(t) for t in ins)
        if not _moves_nothing(func):
            nb = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
            self.op_bytes += nb
            row = self.bytes_by_op[f"{packet} -> {', '.join(_type(t) for t in outs)[:80]}"]
            row[0] += nb
            row[1] += 1
        if not func.is_view:
            held = {t.untyped_storage()._cdata for t in ins}
            for t in outs:
                if t.untyped_storage()._cdata not in held:
                    self._track(t)
        return out


def matmul_flops_summary(counter: OpCounter, top: int | None = 12) -> dict:
    """``repro``'s ``dot_flops_summary`` of the counted matrix products:
    ``total_dot_flops``, ``num_dots`` and the ``top`` fingerprints by FLOPs
    (``shape``, ``flops``, ``count``, ``frac``)."""
    total = sum(f for f, _ in counter.matmuls.values())
    rows = sorted(counter.matmuls.items(), key=lambda kv: -kv[1][0])[:top]
    return {
        "total_dot_flops": total,
        "num_dots": sum(n for _, n in counter.matmuls.values()),
        "top": [{"shape": fp, "flops": f, "count": n, "frac": f / total if total else 0}
                for fp, (f, n) in rows],
    }


def op_bytes_by_op(counter: OpCounter, top: int | None = 15) -> list[dict]:
    """The ops that move the most bytes, grouped by (op, output type):
    ``repro``'s ``entry_bytes_by_op`` rows (``op``, ``bytes``, ``count``,
    ``frac``); every row when ``top`` is None."""
    total = counter.op_bytes
    rows = sorted(counter.bytes_by_op.items(), key=lambda kv: -kv[1][0])[:top]
    return [{"op": k, "bytes": b, "count": n, "frac": b / total if total else 0} for k, (b, n) in rows]


__all__ = ["OpCounter", "matmul_flops_summary", "op_bytes_by_op"]
