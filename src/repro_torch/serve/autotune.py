"""The per-bucket stage-2 configuration of ``repro.serve.autotune``, as plain data.

Only ``HotpathConfig`` and ``bucket_key`` are ported: the engine keys its
callables by the bucket's config. The tuner, its on-disk cache and its
cost model (``repro`` ranks candidates by XLA's ``cost_analysis``) wait on
ROADMAP.md queue 1, item 5, so every bucket runs the engine-wide chunk.
``block_k``/``block_f`` and the attention blocks are TPU tile sizes: the
port's kernels take their own and ignore them.
"""
from __future__ import annotations

from dataclasses import dataclass

DEFAULT_BLOCK_K = 8
DEFAULT_BLOCK_F = 512


@dataclass(frozen=True)
class HotpathConfig:
    """One stage-2 configuration for a bucket (``chunk`` is the one the port
    uses; the rest are ``repro``'s tile sizes, kept for its keys)."""

    chunk: int
    block_k: int = DEFAULT_BLOCK_K
    block_f: int = DEFAULT_BLOCK_F
    attn_block_q: int = 0
    attn_block_k: int = 0


def bucket_key(
    bucket: tuple[int, int],
    accum: str,
    schedule: str,
    m: int,
    n_int: int,
    fused: bool,
    attn: str = "auto",
) -> str:
    """``repro``'s cache key of one bucket's tuned config: the bucket shape,
    the accumulator class, the schedule family, (m, n_int), fused or not,
    and a ``+flash`` suffix for flash models.

        >>> bucket_key((4, 32), "riemann", "paper", 64, 4, True, attn="flash")
        'B4xS32/riemann/paper/m64/n4/fused+flash'
    """
    tag = "fused" if fused else "unfused"
    if attn != "auto":
        tag += f"+{attn}"
    return f"B{bucket[0]}xS{bucket[1]}/{accum}/{schedule}/m{m}/n{n_int}/{tag}"
