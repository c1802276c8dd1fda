"""Content-addressed attribution result cache: ``repro.serve.result_cache``.

The main explain traffic is repeats: the same (input, baseline, method)
arriving again. This module stores finished result dicts under a sha256
content key (``ExplainEngine.request_cache_key``: the engine's context —
model fingerprint, method, schedule, budgets, program flags, baseline id,
the autotune entries — and the request's own bytes) and replays them bit
for bit. The bucket and batch a request lands in are not keyed: padding
invariance makes results independent of them.

``get`` returns a fresh copy (arrays copied), so a caller can never change
the stored bytes; eviction is LRU under a byte budget, with hit, miss and
eviction counters that ``EngineStats`` mirrors.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np

DEFAULT_BUDGET_BYTES = 256 * 1024 * 1024


def _entry_bytes(result: dict) -> int:
    """The resident size ``repro`` counts for one result dict."""
    n = 0
    for k, v in result.items():
        n += len(k) + 48  # dict slot + key overhead
        n += int(v.nbytes) if isinstance(v, np.ndarray) else 32
    return n


def _copy_result(result: dict) -> dict:
    """Arrays copied; scalars and tuples are immutable."""
    return {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in result.items()}


class ResultCache:
    """Byte-budget LRU of finished attribution result dicts.

        >>> import numpy as np
        >>> rc = ResultCache(max_bytes=1 << 20)
        >>> rc.put("k", {"token_scores": np.ones(4, np.float32)})
        >>> hit = rc.get("k")
        >>> hit["token_scores"][0] = 0.0   # a caller's change...
        >>> rc.get("k")["token_scores"][0]  # ...never reaches the cache
        np.float32(1.0)
        >>> rc.get("absent") is None
        True
        >>> rc.hits, rc.misses
        (2, 1)
    """

    def __init__(self, max_bytes: int = DEFAULT_BUDGET_BYTES):
        if max_bytes <= 0:
            raise ValueError(f"a result cache needs a positive byte budget, got {max_bytes}")
        self.max_bytes = int(max_bytes)
        self._entries: OrderedDict[str, tuple[dict, int]] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.bytes = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def get(self, key: str) -> Optional[dict]:
        """A fresh copy of the stored result, or None; counts the hit or
        miss and refreshes the entry's recency on a hit."""
        ent = self._entries.get(key)
        if ent is None:
            self.misses += 1
            return None
        self.hits += 1
        self._entries.move_to_end(key)
        return _copy_result(ent[0])

    def put(self, key: str, result: dict) -> None:
        """Store a copy of ``result``, evicting the least recent entries past
        the budget. An entry larger than the whole budget is refused (counted
        as an eviction); putting a key again replaces its entry."""
        size = _entry_bytes(result)
        if size > self.max_bytes:
            self.evictions += 1
            return
        old = self._entries.pop(key, None)
        if old is not None:
            self.bytes -= old[1]
        self._entries[key] = (_copy_result(result), size)
        self.bytes += size
        while self.bytes > self.max_bytes:
            _, (_, esize) = self._entries.popitem(last=False)
            self.bytes -= esize
            self.evictions += 1
