"""Content fingerprints of (config, parameters): ``repro.core.fingerprint``.

The result cache (``serve.result_cache``) and warm state
(``serve.warm_state``) both ask "is this the same model?" byte for byte. The
fingerprint is sha256 over the config's ``repr`` and, for every parameter
leaf, its tree path, dtype name, shape and raw bytes — the bytes ``repro``
hashes, so the same weights give the same fingerprint in both packages:

  * leaves in ``jax.tree_util.tree_flatten_with_path`` order (dict keys
    sorted, tuples in order, ``None`` an empty subtree), each path written
    as ``jax.tree_util.keystr`` writes it, e.g. ``['layers'][0]['wq']``;
  * the dtype as numpy names it (``float32``, ``bfloat16``), bf16 leaves
    hashed as their raw 16-bit words;
  * a leaf on the card moves to the host once, in chunks through two
    pinned buffers, each hashed while the next one copies: no host copy of
    a whole leaf, let alone of the tree, is ever built.

sha256 runs on one host core, so for the real weights it costs seconds;
callers compute it once (``ExplainEngine.model_fingerprint`` is lazy and
cached). ``params_digest`` is the cheap check that two processes hold the
same weights (a mesh's ranks): integer sums over each leaf's bytes, taken
where the leaf lives, in one pass over memory.
"""
from __future__ import annotations

import functools
import hashlib
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.models.common import tree_leaves_with_path


_CHUNK = 64 << 20  # bytes a leaf on the card moves to the host at a time


def _leaf_meta(leaf: Any) -> tuple[str, tuple]:
    """(numpy dtype name, shape) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch."), tuple(leaf.shape)
    a = np.asarray(leaf)
    return str(a.dtype), a.shape


def _hash_leaf(h: Any, leaf: Any, bufs: list) -> None:
    """Feed one leaf's raw bytes to ``h``. A leaf on the card streams
    through two pinned host buffers of ``_CHUNK`` bytes (``bufs``, filled
    lazily): the copy of one chunk runs while the host hashes the one
    before, and no host copy of the whole leaf exists."""
    if isinstance(leaf, torch.Tensor) and leaf.device.type == "cuda":
        flat = leaf.detach().contiguous().reshape(-1).view(torch.uint8)
        n = flat.numel()
        if not bufs:
            bufs += [torch.empty(_CHUNK, dtype=torch.uint8, pin_memory=True) for _ in range(2)]
        stream = torch.cuda.current_stream(leaf.device)
        pending = None
        for i, start in enumerate(range(0, n, _CHUNK)):
            m = min(_CHUNK, n - start)
            buf = bufs[i % 2]  # free: its last chunk was hashed in the previous step
            buf[:m].copy_(flat[start:start + m], non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
            if pending is not None:
                pending[2].synchronize()
                h.update(pending[0][: pending[1]].numpy())
            pending = (buf, m, done)
        if pending is not None:
            pending[2].synchronize()
            h.update(pending[0][: pending[1]].numpy())
        return
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().contiguous()
        a = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()  # numpy has no bf16
    else:
        a = np.asarray(leaf)  # not ascontiguousarray: it makes a 0-d leaf 1-d
        a = a if a.flags.c_contiguous else a.copy(order="C")
    if a.size:
        h.update(a.reshape(-1).view(np.uint8))


def config_fingerprint(cfg: Any) -> str:
    """sha256 hex of the config's ``repr`` (a frozen dataclass: fields in
    class order, primitive values)."""
    return hashlib.sha256(repr(cfg).encode()).hexdigest()


def params_fingerprint(params: Any) -> str:
    """sha256 hex over every leaf's (tree path, dtype, shape, bytes).

        >>> import torch
        >>> params_fingerprint({"w": torch.zeros(2)}) == params_fingerprint({"w": torch.zeros(2)})
        True
        >>> params_fingerprint({"w": torch.zeros(2)}) == params_fingerprint({"v": torch.zeros(2)})
        False
    """
    h = hashlib.sha256()
    bufs: list = []
    for path, leaf in tree_leaves_with_path(params):
        name, shape = _leaf_meta(leaf)
        h.update(path.encode())
        h.update(name.encode())
        h.update(str(shape).encode())
        _hash_leaf(h, leaf, bufs)
    return h.hexdigest()


def model_fingerprint(cfg: Any, params: Any) -> str:
    """One identity for (architecture, weights): what the caches key on."""
    h = hashlib.sha256()
    h.update(config_fingerprint(cfg).encode())
    h.update(params_fingerprint(params).encode())
    return h.hexdigest()


_DIGEST_CHUNK = 1 << 24  # bytes a chunk: its weighted sum stays below 2**63
_DIGEST_MOD = 65521  # the position weights run 1 … 65521


def params_digest(params: Any) -> str:
    """sha256 hex over every leaf's (tree path, dtype, shape) and two sums
    of its raw bytes: a plain one and one weighted by position (1 + the
    byte's index mod 65521), each taken in int64 chunks on the leaf's own
    device (exact, so equal weights give equal digests on any device) and
    added up in Python. Weights drawn from another seed or read from another
    file give another digest; unlike ``params_fingerprint`` no byte crosses
    to the host.

        >>> import torch
        >>> params_digest({"w": torch.ones(3)}) == params_digest({"w": torch.ones(3)})
        True
        >>> params_digest({"w": torch.ones(3)}) == params_digest({"w": torch.tensor([1.0, 1.0, 1.5])})
        False
    """
    h = hashlib.sha256()
    for path, leaf in tree_leaves_with_path(params):
        name, shape = _leaf_meta(leaf)
        t = leaf.detach() if isinstance(leaf, torch.Tensor) else torch.as_tensor(np.asarray(leaf))
        flat = t.contiguous().reshape(-1).view(torch.uint8)
        plain = weighted = 0
        for start in range(0, flat.numel(), _DIGEST_CHUNK):
            c = flat[start:start + _DIGEST_CHUNK].to(torch.int64)
            pos = torch.arange(start, start + c.numel(), device=c.device) % _DIGEST_MOD + 1
            plain += int(c.sum())
            weighted += int((c * pos).sum())
        h.update(f"{path} {name} {shape} {plain} {weighted};".encode())
    return h.hexdigest()


def reachable_tensors(f: Callable, depth: int = 6) -> list:
    """The tensors a model function closes over, in a fixed order: through
    its closure cells, defaults, ``functools.partial`` arguments, a bound
    method's ``nn.Module``, a module's ``state_dict`` and containers of
    these, to ``depth`` levels. What ``params_digest`` of a function
    (``Explainer(f)``) reads: ``Model.target_logprob_fn(params)`` reaches
    ``params``."""
    out: list = []
    seen: set = set()

    def walk(x: Any, d: int) -> None:
        if d < 0 or id(x) in seen:
            return
        seen.add(id(x))
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, torch.nn.Module):
            walk(dict(x.state_dict()), d - 1)
        elif isinstance(x, dict):
            for k in sorted(x, key=repr):
                walk(x[k], d - 1)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v, d - 1)
        elif isinstance(x, functools.partial):
            walk((x.func, x.args, x.keywords), d - 1)
        elif callable(x):
            self_ = getattr(x, "__self__", None)
            if isinstance(self_, torch.nn.Module):
                walk(self_, d - 1)
            cells = getattr(x, "__closure__", None) or ()
            walk([c.cell_contents for c in cells if _filled(c)], d - 1)
            walk(getattr(x, "__defaults__", None) or (), d - 1)

    walk(f, depth)
    return out


def _filled(cell: Any) -> bool:
    try:
        cell.cell_contents
    except ValueError:  # a cell not yet assigned
        return False
    return True
