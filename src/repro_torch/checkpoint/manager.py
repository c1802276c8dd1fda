"""``repro.checkpoint.manager``'s ``sha256_file`` and ``atomic_dir``.

Only these two are ported: ``serve.warm_state`` writes its files with them.
The sharded checkpoint itself (save, restore, the manager) waits on
ROADMAP.md queue 1, item 7.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
import shutil
import tempfile
from typing import Iterator


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
