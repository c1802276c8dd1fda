"""Data-parallel dispatch of stage-2 calls over a ``torch.distributed`` world.

``repro`` is single-controller: one Python process plans the buckets, runs
the tuner, the caches, the scheduler's clocks and rate limits, and drives
every device of the mesh. The port keeps that. Rank 0 is the controller and
runs all host logic; ranks 1…N−1 run ``worker_loop``. Every rank planning
for itself (SPMD) is not an option: the tuner's timings, the straggler
EWMA and the token bucket read clocks, so ranks would branch apart and a
collective would wait forever.

One sharded call (``call``), for a callable that rank 0 has cached under a
key that rebuilds it (``ExplainEngine._build``, ``Explainer._build``):

  1. rank 0 broadcasts the header: the target's name and recipe (the
     constructor arguments that shape its callables), the key, the argument
     tree with its tensors replaced by slots, and each slot's local shape;
  2. rank 0 sends every rank of the mesh one buffer: its rows of each
     batch-leading tensor (``explain_arg_shardings``' per-leaf rule; ranks
     that share a data index get the same rows) and the other tensors whole;
  3. every rank rebuilds the callable from (recipe, key) — never pickled —
     and runs it on its rows: on the card, each rank launches the port's
     kernels;
  4. the ranks exchange a status (a failure anywhere raises on rank 0 and
     leaves every worker waiting for the next header), then rank 0 gathers
     the outputs by rows from the ranks at model index 0.

Tensors travel as one uint8 buffer a rank each way. Over gloo they are
staged through host memory (gloo does not take CUDA tensors for every
operation); over NCCL they stay on the card. ``stop`` ends every worker's
loop; rank 0 serves inside ``controller()``, which sends it on the way
out, also when rank 0 raises. ``STATS`` counts the calls and the seconds
spent sending, running on rank 0, waiting for the other ranks and
gathering.
"""
from __future__ import annotations

import itertools
import time
import traceback
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.sharding.partition import DEFAULT_RULES, MeshRules, _leaves, _map_leaves, explain_arg_shardings


@dataclass
class DispatchStats:
    """Rank 0's counters: sharded calls, seconds spent sending (header and
    rows), running its own rows, waiting for every rank's status (the
    slowest rank's remaining work), and gathering the outputs, and the
    bytes sent and gathered."""

    calls: int = 0
    send_s: float = 0.0
    run_s: float = 0.0
    wait_s: float = 0.0
    gather_s: float = 0.0
    bytes_sent: int = 0
    bytes_gathered: int = 0

    def reset(self) -> None:
        self.__init__()


STATS = DispatchStats()


class _Slot(int):
    """A tensor's place in the flattened argument tree of a header."""


@dataclass(frozen=True)
class Layout:
    """Where the ranks of a ``DeviceMesh`` sit: each member rank's data index
    (its row chunk, ravelled over the batch axes in mesh order) and whether it
    is at model index 0 (it sends its rows back)."""

    dp: int
    data_index: dict  # rank -> row chunk
    representative: dict  # rank -> at index 0 of every other axis

    @classmethod
    def of(cls, mesh: Any, rules: MeshRules = DEFAULT_RULES) -> "Layout":
        ranks = mesh.mesh
        names = list(mesh.mesh_dim_names)
        batch = [i for i, n in enumerate(names) if n in rules.batch_axes]
        dp = 1
        for i in batch:
            dp *= ranks.shape[i]
        data_index, rep = {}, {}
        for c in itertools.product(*(range(n) for n in ranks.shape)):
            r = int(ranks[c])
            d = 0
            for i in batch:
                d = d * ranks.shape[i] + c[i]
            data_index[r] = d
            rep[r] = all(c[i] == 0 for i in range(len(c)) if i not in batch)
        return cls(dp, data_index, rep)


def _stage(backend: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` where the collective takes it: host memory over gloo."""
    return t.cpu() if backend == "gloo" else t


def _pack(tensors: list) -> torch.Tensor:
    """Tensors as one flat uint8 buffer (each contiguous, in order)."""
    if not tensors:
        return torch.zeros(0, dtype=torch.uint8)
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in tensors])


def _unpack(buf: torch.Tensor, metas: list, device) -> list:
    """The tensors ``_pack`` packed, from (shape, dtype) pairs, on ``device``."""
    out, off = [], 0
    for shape, dtype in metas:
        n = torch.Size(shape).numel() * torch.empty((), dtype=dtype).element_size()
        # a copy first: a slice at an odd offset cannot be viewed as a wider type
        out.append(buf[off:off + n].clone().view(dtype).reshape(shape).to(device))
        off += n
    return out


def _nbytes(metas: list) -> int:
    return sum(torch.Size(s).numel() * torch.empty((), dtype=d).element_size() for s, d in metas)


def _row_leaves(out: Any, rows: int) -> list:
    """The output's tensor leaves, each gathered by rows. A stage-2
    callable returns per-row results only (``IGResult``, ``IGState``, the
    expanded ``Schedule``, the forward-only attributions): a tensor leaf
    without ``rows`` leading rows raises rather than being concatenated
    across ranks or left at one rank's value."""
    leaves = [t for t in _leaves(out) if isinstance(t, torch.Tensor)]
    bad = [tuple(t.shape) for t in leaves if t.ndim == 0 or t.shape[0] != rows]
    if bad:
        raise ValueError(f"a sharded call returned tensors that are not per-row ({rows} rows a rank): {bad}")
    return leaves


def _status(err: Optional[str]) -> list:
    statuses = [None] * dist.get_world_size()
    dist.all_gather_object(statuses, err)
    return statuses


def call(target: str, recipe: dict, key: tuple, args: tuple, mesh: Any, local_fn: Callable,
         rules: MeshRules = DEFAULT_RULES) -> Any:
    """Run ``local_fn(*args)`` data-parallel over ``mesh``: each rank of the
    mesh on its rows of every batch-leading tensor of ``args`` (which must
    resolve under ``explain_arg_shardings``), rank 0 on its own with
    ``local_fn``, the workers with the callable ``target``'s recipe and
    ``key`` rebuild. Returns the output with its rows gathered in data order,
    on rank 0's device. Raises on rank 0 when any rank's call raised."""
    if not _SERVING:
        raise RuntimeError("a sharded call outside dispatch.controller(): the workers are not serving")
    backend = dist.get_backend()
    layout = Layout.of(mesh, rules)
    t0 = time.perf_counter()
    specs = explain_arg_shardings(mesh, args, rules)
    if specs is None:
        raise ValueError(f"arguments do not divide dp={layout.dp}")
    tensors = []

    def slot(x):
        if isinstance(x, torch.Tensor):
            tensors.append(x)
            return _Slot(len(tensors) - 1)
        return x

    skeleton = _map_leaves(slot, args)
    spec_leaves = [s for s, x in zip(_spec_leaves(specs, args), _leaves(args)) if isinstance(x, torch.Tensor)]
    sharded = [len(s) > 0 and s[0] is not None for s in spec_leaves]
    batch = next(t.shape[0] for t, s in zip(tensors, sharded) if s)
    rows = batch // layout.dp
    metas = [((rows,) + tuple(t.shape[1:]) if s else tuple(t.shape), t.dtype) for t, s in zip(tensors, sharded)]
    me = dist.get_rank()
    header = {"op": "call", "target": target, "recipe": recipe, "key": key, "skeleton": skeleton,
              "metas": metas, "members": sorted(layout.data_index), "rows": rows,
              "representative": layout.representative}
    dist.broadcast_object_list([header], src=0)

    def chunk(d):
        return [t[d * rows:(d + 1) * rows] if s else t for t, s in zip(tensors, sharded)]

    packed, works = {}, []
    for r, d in sorted(layout.data_index.items()):
        if r == me:
            continue
        if d not in packed:
            packed[d] = _stage(backend, _pack(chunk(d)))
        works.append(dist.isend(packed[d], dst=r))
        STATS.bytes_sent += packed[d].numel()
    for w in works:
        w.wait()
    t1 = time.perf_counter()

    own = layout.data_index[me]
    err, out = None, None
    try:
        out = local_fn(*_fill(skeleton, chunk(own)))
        mine = _row_leaves(out, rows)
        if any(t.is_cuda for t in mine):
            torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 — reported after every rank's status is in
        err = e
    t2 = time.perf_counter()
    statuses = _status(None if err is None else repr(err))
    t_wait = time.perf_counter()
    if err is not None:
        raise err
    failed = [(r, s) for r, s in enumerate(statuses) if s is not None]
    if failed:
        raise RuntimeError(f"dispatch of {key!r}: rank {failed[0][0]} raised:\n{failed[0][1]}")

    parts = {own: mine}
    out_metas = [(tuple(t.shape), t.dtype) for t in mine]
    dev = tensors[0].device
    for r, d in sorted(layout.data_index.items()):
        if r == me or not layout.representative[r] or d in parts:
            continue
        buf = torch.empty(_nbytes(out_metas), dtype=torch.uint8,
                          device="cpu" if backend == "gloo" else dev)
        dist.recv(buf, src=r)
        STATS.bytes_gathered += buf.numel()
        parts[d] = _unpack(buf, out_metas, dev)
    whole = iter([torch.cat([parts[d][i] for d in range(layout.dp)]) for i in range(len(mine))])
    result = _map_leaves(lambda t: next(whole) if isinstance(t, torch.Tensor) else t, out)
    t3 = time.perf_counter()
    STATS.calls += 1
    STATS.send_s += t1 - t0
    STATS.run_s += t2 - t1
    STATS.wait_s += t_wait - t2
    STATS.gather_s += t3 - t_wait
    return result


def _spec_leaves(specs: Any, args: Any) -> list:
    """The per-leaf specs of ``explain_arg_shardings`` in ``_leaves(args)``'s
    order (a spec is itself a tuple, so it is read off beside its leaf)."""
    out = []

    def walk(s, a):
        if a is None:
            return
        if isinstance(a, dict):
            for k in a:
                walk(s[k], a[k])
        elif isinstance(a, (tuple, list)):
            for si, ai in zip(s, a):
                walk(si, ai)
        else:
            out.append(s)

    walk(specs, args)
    return out


def _fill(skeleton: Any, tensors: list) -> Any:
    return _map_leaves(lambda x: tensors[x] if isinstance(x, _Slot) else x, skeleton)


def stop() -> None:
    """End every worker's ``worker_loop`` (rank 0, once serving is over)."""
    dist.broadcast_object_list([{"op": "stop"}], src=0)


def worker_loop(targets: dict[str, Callable[[dict], Any]], device="cuda") -> int:
    """Serve rank 0's sharded calls until it sends ``stop``; returns the
    number of calls served. ``targets`` maps a target's name to a factory
    of its recipe whose object rebuilds a callable from a key with
    ``_build(key)`` (an ``ExplainEngine`` or an ``Explainer`` over this
    rank's own model); objects and callables are built once and cached."""
    backend = dist.get_backend()
    me = dist.get_rank()
    objects: dict[tuple, Any] = {}
    fns: dict[tuple, Callable] = {}
    served = 0
    while True:
        box = [None]
        dist.broadcast_object_list(box, src=0)
        header = box[0]
        if header["op"] == "stop":
            return served
        if header["op"] == "run":  # a collective every rank takes part in
            _run_here(header)
            continue
        member = me in header["members"]
        err, rows = None, None
        if member:
            buf = torch.empty(_nbytes(header["metas"]), dtype=torch.uint8,
                              device="cpu" if backend == "gloo" else device)
            dist.recv(buf, src=0)
            try:
                okey = (header["target"], repr(sorted(header["recipe"].items())))
                if okey not in objects:
                    objects[okey] = targets[header["target"]](dict(header["recipe"]))
                fkey = okey + (header["key"],)
                if fkey not in fns:
                    fns[fkey] = objects[okey]._build(header["key"])
                out = fns[fkey](*_fill(header["skeleton"], _unpack(buf, header["metas"], device)))
                rows = _row_leaves(out, header["rows"])
                served += 1
            except Exception:  # noqa: BLE001 — reported to rank 0, which raises
                err = traceback.format_exc()
        statuses = _status(err)
        if member and header["representative"][me] and all(s is None for s in statuses):
            dist.send(_stage(backend, _pack(rows)), dst=0)


def run_everywhere(fn: Callable, *args) -> Any:
    """Call ``fn(*args)`` on every rank (a module-level function: the workers
    import it by name), for what every rank must take part in, such as
    building a ``DeviceMesh``; returns rank 0's result. Called on rank 0
    while the workers are in ``worker_loop``."""
    dist.broadcast_object_list([{"op": "run", "fn": (fn.__module__, fn.__qualname__), "args": args}], src=0)
    return fn(*args)


def _run_here(header: dict) -> None:
    import importlib

    mod, name = header["fn"]
    obj = importlib.import_module(mod)
    for part in name.split("."):
        obj = getattr(obj, part)
    obj(*header["args"])


_SERVING = False


@contextmanager
def controller():
    """Rank 0's serving span, while every other rank is in ``worker_loop``:
    inside it rank 0 may ``call`` and ``run_everywhere``; on leaving it,
    normally or by an exception, the workers are stopped."""
    global _SERVING
    _SERVING = True
    try:
        yield
    finally:
        _SERVING = False
        stop()


def active() -> bool:
    """Inside rank 0's ``controller`` span."""
    return _SERVING


__all__ = ["DispatchStats", "Layout", "STATS", "active", "call", "controller", "run_everywhere", "stop",
           "worker_loop"]
