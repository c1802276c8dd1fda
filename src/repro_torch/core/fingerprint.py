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
cached).
"""
from __future__ import annotations

import hashlib
from typing import Any

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
