"""Fault-tolerant sharded checkpointing: ``repro.checkpoint.manager``, on
the same files, so a checkpoint written by one package restores in the
other.

Layout (one directory per step):
    <dir>/step_000123.tmp-<nonce>/   — written first
        shard_00000.npz ...          — leaves, packed greedily into ~512 MB shards
        manifest.json                — leaf->shard map, dtype names, sha256 per shard
    <dir>/step_000123/               — atomic rename when complete

Leaves are numbered in ``jax.tree_util``'s flatten order (``tree_leaves``:
dict keys sorted, tuples and NamedTuple fields in order, ``None`` no
leaf): a ``TrainState`` numbers its params, ``opt.step``, ``opt.m``,
``opt.v``, then ``err``. A leaf numpy cannot hold (bfloat16, the float8
types) is stored as the unsigned integers of its bytes with its torch
dtype's name in the manifest, which are ``ml_dtypes``' names, as
``repro`` writes it; it is read back through a torch view.

Guarantees, ``repro``'s:
  * atomicity: a crash mid-write leaves only .tmp dirs, never a
    half-valid step dir; restore ignores .tmp;
  * integrity: per-shard sha256 in the manifest; a corrupted shard fails
    validation and restore falls back to the previous step;
  * resume: ``latest_step`` picks the newest *valid* checkpoint;
  * async save: ``CheckpointManager(save_async=True)`` copies the tree to
    the host in ``save`` — a copy even of CPU tensors, so that a step
    updating the state in place cannot reach what the thread writes — and
    writes it from a background thread (``wait()`` joins).

Shards are written, hashed and read by a pool of threads (numpy's
writes, ``hashlib`` and file reads release the GIL); the files are the
ones a sequential writer makes. A leaf is read straight from its stored
npz member into its array, one read of its bytes: the shard's sha256 has
already vouched for them, so zipfile's chunked copy and CRC are skipped. ``serve.warm_state`` writes its files with ``atomic_dir`` and
``sha256_file``.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import struct
import tempfile
import threading
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, Optional

import numpy as np
import torch

from repro_torch.models.common import tree_leaves, tree_unflatten

_MANIFEST = "manifest.json"
_SHARD_BYTES = 512 * 1024 * 1024
_WORKERS = min(8, os.cpu_count() or 1)  # threads writing or hashing shards
# a leaf numpy has no dtype for is stored as unsigned integers of its width,
# moved between torch and numpy as integers both of them hold
_INT_OF = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
_NUMPY_FLOATS = (torch.float16, torch.float32, torch.float64)  # the float types numpy holds itself


def _savable(leaf: Any) -> tuple[np.ndarray, str]:
    """(an array npz can store, the leaf's dtype name) of a tensor or array."""
    if not isinstance(leaf, torch.Tensor):
        a = np.asarray(leaf)
        return a, a.dtype.name
    t = leaf.detach().cpu()
    name = str(t.dtype).removeprefix("torch.")
    if not t.dtype.is_floating_point or t.dtype in _NUMPY_FLOATS:
        return t.numpy(), name
    return t.contiguous().view(_INT_OF[t.element_size()]).numpy().view(f"u{t.element_size()}"), name


def _unview(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A stored array back to a tensor of ``dtype_name`` (a view, no copy)."""
    if a.dtype.name == dtype_name:
        return torch.from_numpy(a)
    as_int = _INT_OF[a.dtype.itemsize]
    return torch.from_numpy(a.view(str(as_int).removeprefix("torch."))).view(getattr(torch, dtype_name))


def sha256_file(path: str) -> str:
    """Streaming sha256 hex digest of one file (a manifest's shard hash)."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


@contextlib.contextmanager
def atomic_dir(final: str) -> Iterator[str]:
    """Yield a temporary directory beside ``final``; on a clean exit it
    replaces ``final`` in one ``os.replace``, on an exception it is removed
    and ``final`` is left as it was, so a crash mid-write never leaves a
    half-written directory behind."""
    parent = os.path.dirname(final) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=os.path.basename(final) + ".tmp-", dir=parent)
    try:
        yield tmp
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic on POSIX


def save_checkpoint(directory: str, step: int, tree: Any) -> str:
    """Write a sharded, content-hashed, atomically-renamed checkpoint."""
    final = os.path.join(directory, f"step_{step:08d}")
    with atomic_dir(final) as tmp:
        _write_checkpoint_files(tmp, step, tree)
    return final


def _nbytes(leaf: Any) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return np.asarray(leaf).nbytes


def _write_checkpoint_files(tmp: str, step: int, tree: Any) -> None:
    leaves = tree_leaves(tree)
    names = [f"leaf_{i:05d}" for i in range(len(leaves))]
    # greedy pack leaves into ~_SHARD_BYTES shard files
    shards: list[list[int]] = [[]]
    size = 0
    for i, leaf in enumerate(leaves):
        nbytes = _nbytes(leaf)
        if size + nbytes > _SHARD_BYTES and shards[-1]:
            shards.append([])
            size = 0
        shards[-1].append(i)
        size += nbytes

    leaf_to_shard, leaf_dtypes = {}, {}

    def write(si: int) -> tuple[str, str]:
        fname = f"shard_{si:05d}.npz"
        arrs = {}
        for i in shards[si]:
            arrs[names[i]], leaf_dtypes[names[i]] = _savable(leaves[i])
            leaf_to_shard[names[i]] = fname
        np.savez(os.path.join(tmp, fname), **arrs)
        return fname, sha256_file(os.path.join(tmp, fname))

    with ThreadPoolExecutor(_WORKERS) as pool:
        shard_hashes = dict(pool.map(write, range(len(shards))))
    manifest = {
        "step": step,
        "num_leaves": len(leaves),
        "leaf_to_shard": {n: leaf_to_shard[n] for n in names},
        "leaf_dtypes": {n: leaf_dtypes[n] for n in names},
        "shard_hashes": shard_hashes,
        "time": time.time(),
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)


def _validate(path: str) -> bool:
    mpath = os.path.join(path, _MANIFEST)
    if not os.path.exists(mpath):
        return False
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        files = [(os.path.join(path, fname), digest) for fname, digest in manifest["shard_hashes"].items()]
        if not all(os.path.exists(fpath) for fpath, _ in files):
            return False
        with ThreadPoolExecutor(_WORKERS) as pool:
            return all(pool.map(lambda fd: sha256_file(fd[0]) == fd[1], files))
    except (json.JSONDecodeError, KeyError, OSError):
        return False


def _steps(directory: str) -> list[int]:
    """The steps of the finished step directories (no .tmp), ascending."""
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and ".tmp-" not in d)


def latest_step(directory: str) -> Optional[int]:
    """Newest step with a *valid* checkpoint (corrupted ones are skipped)."""
    if not os.path.isdir(directory):
        return None
    for s in reversed(_steps(directory)):
        if _validate(os.path.join(directory, f"step_{s:08d}")):
            return s
    return None


def restore_checkpoint(directory: str, step: int, like: Any) -> Any:
    """Restore into the structure of ``like``: each leaf a new tensor of
    ``like``'s leaf's dtype on its device."""
    path = os.path.join(directory, f"step_{step:08d}")
    if not _validate(path):
        raise ValueError(f"checkpoint at {path} is missing or corrupt")
    return _read(path, like)


def _read(path: str, like: Any) -> Any:
    """The leaves of a validated checkpoint directory in ``like``'s
    structure; the shards are read by a pool of threads."""
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    leaves_like = tree_leaves(like)
    if manifest["num_leaves"] != len(leaves_like):
        raise AssertionError("tree structure mismatch")  # repro's assert, kept under -O
    names = [f"leaf_{i:05d}" for i in range(len(leaves_like))]
    by_shard: dict[str, list[int]] = {}
    for i, name in enumerate(names):
        by_shard.setdefault(manifest["leaf_to_shard"][name], []).append(i)
    out: list = [None] * len(names)

    def read(fname: str) -> None:
        fpath = os.path.join(path, fname)
        with zipfile.ZipFile(fpath) as zf, open(fpath, "rb", buffering=0) as f:
            for i in by_shard[fname]:
                a = _read_member(f, zf.getinfo(names[i] + ".npy"))
                t = _unview(a, manifest["leaf_dtypes"][names[i]])
                out[i] = t.to(device=leaves_like[i].device, dtype=leaves_like[i].dtype)

    with ThreadPoolExecutor(_WORKERS) as pool:
        list(pool.map(read, by_shard))
    return tree_unflatten(like, out)


def _read_member(f: Any, info: zipfile.ZipInfo) -> np.ndarray:
    """The array of one stored (uncompressed) .npy member of an npz, read
    from the open file ``f`` into a new array in one pass."""
    if info.compress_type != zipfile.ZIP_STORED:
        raise ValueError(f"shard member {info.filename} is compressed")
    f.seek(info.header_offset)
    name_len, extra_len = struct.unpack("<HH", f.read(30)[26:30])  # the local file header
    f.seek(info.header_offset + 30 + name_len + extra_len)
    version = np.lib.format.read_magic(f)
    read_header = np.lib.format.read_array_header_1_0 if version == (1, 0) else np.lib.format.read_array_header_2_0
    shape, fortran_order, dtype = read_header(f)
    if fortran_order or dtype.hasobject:
        raise ValueError(f"shard member {info.filename} is not a C-order array of numbers")
    a = np.empty(shape, dtype)
    view, got = memoryview(a.reshape(-1).view(np.uint8)), 0
    while got < len(view):  # one read() returns at most ~2 GB
        n = f.readinto(view[got:])
        if not n:
            raise ValueError(f"shard member {info.filename} is truncated")
        got += n
    return a


def _host_copy(leaf: Any) -> Any:
    """A host copy of one leaf that no later in-place update reaches."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


class CheckpointManager:
    """keep_n retention + optional async save + resume."""

    def __init__(self, directory: str, *, keep_n: int = 3, save_async: bool = False):
        self.directory = directory
        self.keep_n = keep_n
        self.save_async = save_async
        self._thread: Optional[threading.Thread] = None

    def save(self, step: int, tree: Any) -> None:
        host_tree = tree_unflatten(tree, [_host_copy(x) for x in tree_leaves(tree)])  # device->host now
        if self.save_async:
            self.wait()
            self._thread = threading.Thread(target=self._save_and_gc, args=(step, host_tree),
                                            daemon=True)
            self._thread.start()
        else:
            self._save_and_gc(step, host_tree)

    def _save_and_gc(self, step: int, tree: Any) -> None:
        save_checkpoint(self.directory, step, tree)
        self._gc()

    def _gc(self) -> None:
        if not os.path.isdir(self.directory):
            return
        for s in _steps(self.directory)[: -self.keep_n] if self.keep_n else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_latest(self, like: Any) -> tuple[Optional[int], Any]:
        """(the newest valid step, its tree in ``like``'s structure), or
        (None, ``like``) when there is none; the checkpoint is hashed once,
        by ``latest_step``."""
        step = latest_step(self.directory)
        if step is None:
            return None, like
        return step, _read(os.path.join(self.directory, f"step_{step:08d}"), like)
