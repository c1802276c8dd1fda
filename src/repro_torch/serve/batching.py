"""Shape-bucketed request batching for the ExplainEngine — a copy of
``repro.serve.batching`` (numpy only; DESIGN.md §6 describes the design).

Mixed-length prompts cannot share one compiled executable unless their shapes
agree, and compiling per exact length would recompile on nearly every request.
The classic serving answer is a *bucket ladder*: right-pad every request's
token sequence up to the smallest ladder rung ≥ its length (powers of two by
default), and pad the batch axis up to a batch ladder rung, so steady-state
traffic touches a small closed set of shapes — each compiled exactly once.

Padding is masked, not free: the plan carries a per-position real-token mask
that the NUIG pipeline threads through the stage-1 probe and stage-2
accumulation, so padded positions receive exactly zero attribution and δ is
computed over real tokens only. Batch-pad rows duplicate a real request (a
fully-masked row would make the probe degenerate) and are dropped on output.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np

# Default sequence-bucket ladder: powers of two. Configurable per engine.
DEFAULT_SEQ_BUCKETS: tuple[int, ...] = (8, 16, 32, 64, 128, 256, 512, 1024)
# Default batch-bucket ladder: keeps (B, S) — not just S — a small closed set.
DEFAULT_BATCH_BUCKETS: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)


def pow2_ladder(max_size: int, *, start: int = 8) -> tuple[int, ...]:
    """Powers-of-two rungs start, 2·start, ... up to ≥ max_size."""
    out = [start]
    while out[-1] < max_size:
        out.append(out[-1] * 2)
    return tuple(out)


def bucket_for(size: int, ladder: Sequence[int]) -> int:
    """Smallest ladder rung ≥ size."""
    for b in ladder:
        if size <= b:
            return b
    raise ValueError(f"size {size} exceeds bucket ladder max {max(ladder)}")


def pad_rows(
    rows: Sequence[int],
    batch_buckets: Optional[Sequence[int]],
    *,
    multiple: int = 1,
) -> tuple[list[int], int]:
    """Pad a row-index list up the batch ladder by repeating the last row.

    The adaptive escalation path re-batches still-unconverged rows mid-flight
    (DESIGN.md §7); padding them to a ladder rung keeps hop executables on
    the same closed (B, S) shape set as plan-time batches. Pad slots repeat a
    real row (same reason as ``plan_buckets``: a fully-masked row would make
    the δ check degenerate) and are dropped on output.

    ``multiple`` is ``repro``'s mesh-divisibility contract (DESIGN.md §9):
    the padded B is additionally rounded up to a multiple of the mesh's
    data-parallel extent. It is 1 on one card.

    Returns ``(padded_rows, B)`` with ``padded_rows[:len(rows)] == rows``.
    """
    rows = list(rows)
    assert rows, "pad_rows needs at least one row"
    B = bucket_for(len(rows), batch_buckets) if batch_buckets else len(rows)
    if multiple > 1:
        B = ((B + multiple - 1) // multiple) * multiple
    return rows + [rows[-1]] * (B - len(rows)), B


class BucketBatch(NamedTuple):
    """One padded, maskable batch of same-bucket requests."""

    bucket: tuple[int, int]  # (B_padded, S_padded) — the compile-cache shape
    indices: tuple[int, ...]  # request-list positions of the real rows
    tokens: np.ndarray  # (B, S) int32, right-padded with pad_id
    lens: np.ndarray  # (B,) int32 true lengths (pad rows repeat a real row)
    targets: np.ndarray  # (B,) int32
    mask: np.ndarray  # (B, S) float32, 1.0 on real tokens
    # feature-space requests (e.g. ViT patch features): (B, S, *F) float32,
    # zero-padded; None for token-only traffic
    features: Optional[np.ndarray] = None
    # known endpoint values f(x) donated by the decode path (probe-reuse
    # contract, DESIGN.md §11): (B,) float32, pad rows repeating a real row;
    # None when the engine must compute the endpoint itself. Requests with
    # and without a known endpoint never share a bucket (different compiled
    # probe signatures), so ``plan_buckets`` groups by (S, has_fx).
    f_x: Optional[np.ndarray] = None


def plan_buckets(
    requests: Sequence,
    *,
    seq_buckets: Sequence[int] = DEFAULT_SEQ_BUCKETS,
    batch_buckets: Optional[Sequence[int]] = DEFAULT_BATCH_BUCKETS,
    max_batch: int = 0,
    pad_id: int = 0,
    batch_multiple: int = 1,
) -> list[BucketBatch]:
    """Group heterogeneous ExplainRequests into padded shape buckets.

    requests: objects with ``.tokens`` (1-D int array) and ``.target`` (int);
    an optional ``.features`` ((S, *F) float array, e.g. ViT patch features)
    rides the plan zero-padded — all requests in a plan must agree on whether
    they carry features (mixed traffic would need per-bucket model facades).
    max_batch caps real rows per batch (0 = unlimited); batch_buckets=None
    disables batch-axis padding (B = number of grouped rows).
    ``batch_multiple`` rounds every padded B up to a multiple of the mesh's
    data-parallel extent (``repro``'s mesh-divisible padding); 1 on one card.
    """
    groups: dict[tuple[int, bool], list[int]] = {}
    for i, r in enumerate(requests):
        has_fx = getattr(r, "f_x", None) is not None
        key = (bucket_for(len(r.tokens), seq_buckets), has_fx)
        groups.setdefault(key, []).append(i)

    out: list[BucketBatch] = []
    for S, has_fx in sorted(groups):
        idx = groups[(S, has_fx)]
        step = max_batch if max_batch else len(idx)
        if batch_buckets:
            step = min(step, max(batch_buckets))  # never outgrow the ladder
        for lo in range(0, len(idx), step):
            rows = idx[lo : lo + step]
            padded_rows, B = pad_rows(rows, batch_buckets, multiple=batch_multiple)
            tokens = np.full((B, S), pad_id, np.int32)
            lens = np.empty((B,), np.int32)
            targets = np.empty((B,), np.int32)
            mask = np.zeros((B, S), np.float32)
            features = None
            fx = np.empty((B,), np.float32) if has_fx else None
            has_feat = getattr(requests[padded_rows[0]], "features", None) is not None
            for j, ri in enumerate(padded_rows):
                t = np.asarray(requests[ri].tokens, np.int32)
                tokens[j, : len(t)] = t
                lens[j] = len(t)
                targets[j] = int(requests[ri].target)
                mask[j, : len(t)] = 1.0
                if has_fx:
                    fx[j] = float(requests[ri].f_x)
                f = getattr(requests[ri], "features", None)
                if (f is not None) != has_feat:
                    raise ValueError(
                        "plan_buckets: mixed feature/token requests in one plan"
                    )
                if f is not None:
                    f = np.asarray(f, np.float32)
                    if features is None:
                        features = np.zeros((B, S) + f.shape[1:], np.float32)
                    features[j, : f.shape[0]] = f
            out.append(
                BucketBatch(
                    (B, S), tuple(rows), tokens, lens, targets, mask, features, fx
                )
            )
    return out
