"""Roofline-priced per-bucket tuner of the stage-2 chunk: ``repro.serve.autotune``.

The chunk (how many interpolation steps fold into one model call) trades
memory for fewer passes over the weights, and the right value depends on
the bucket shape and the device, so it is tuned per ``(bucket, device
kind)`` and persisted:

  1. every candidate of ``chunk_candidates(m)`` is priced by
     ``roofline.hotpath_cost`` (the analytic count that stands in for
     ``repro``'s ``cost_analysis``) under ``hardware_for(device_kind)``;
  2. a candidate whose predicted peak exceeds the device's memory is
     dropped before any launch (``"pruned": "memory"``). ``repro`` needs no
     such check, since XLA refuses to compile such a program; the port has
     no compile step, and chunk 64 on a 16×128 llama3-8b bucket would run
     the card out of memory (ROADMAP.md queue 3);
  3. the ``max_measured`` best survivors by bound (ties: fewer bytes) are
     timed on real bucket inputs, synchronised, median of ``rounds``; the
     rest are reported ``"pruned": "roofline"``;
  4. the winners land in ``results/autotune_<device>.json`` keyed by
     ``bucket_key``, which ``ExplainEngine(autotune=True)`` loads.

``block_k``/``block_f`` and the attention blocks of ``HotpathConfig`` are
TPU tile sizes: the port's kernels choose their own tiles, so the tuner
sweeps the chunk alone. The adaptive m-ladder is not tuned, as in
``repro``: escalation needs one chunk along the whole ladder, so adaptive
serving keeps the engine-wide chunk. A tuned chunk changes the order of the
sums and so the bits, which is why ``AutotuneCache.entries_fingerprint``
rides the result-cache key.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np
import torch

from repro_torch.roofline import hardware_for, hotpath_cost, hotpath_terms

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


def device_kind(device: Any = "cuda") -> str:
    """The sanitized kind of ``device`` (the cache file's suffix): the card's
    name for a CUDA device, ``"cpu"`` for the host. Callers pass the
    engine's device.

        >>> device_kind("cpu")
        'cpu'
    """
    device = torch.device(device)
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
    return re.sub(r"[^a-z0-9]+", "_", kind.lower()).strip("_")


def cache_path(results_dir: str, kind: str) -> str:
    """``<results_dir>/autotune_<device kind>.json``."""
    return os.path.join(results_dir, f"autotune_{kind}.json")


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


@dataclass
class AutotuneCache:
    """On-disk ``bucket_key -> tuned config + measurements`` map of one
    device kind (``repro``'s ``device`` field; its file format)."""

    kind: str = ""
    entries: dict = field(default_factory=dict)

    @classmethod
    def load(cls, results_dir: str, kind: str) -> "AutotuneCache":
        """The cache of device kind ``kind``; a missing file is empty.

        Never raises on a bad file: a corrupted or truncated payload, one
        that is not a dict, or one tuned for another device kind warns and
        comes back empty. A broken file may cost tuning again, never serving.
        """
        path = cache_path(results_dir, kind)
        if not os.path.exists(path):
            return cls(kind=kind)
        try:
            with open(path) as fh:
                payload = json.load(fh)
            if not isinstance(payload, dict) or not isinstance(payload.get("entries", {}), dict):
                raise ValueError(f"malformed payload {type(payload).__name__}")
        except (json.JSONDecodeError, ValueError, OSError) as e:
            warnings.warn(f"AutotuneCache: unreadable cache at {path} ({e}); starting with an empty cache",
                          stacklevel=2)
            return cls(kind=kind)
        recorded = payload.get("device", kind)
        if recorded != kind:
            warnings.warn(f"AutotuneCache: {path} was tuned for device {recorded!r}, not {kind!r}; "
                          "ignoring its entries", stacklevel=2)
            return cls(kind=kind)
        return cls(kind=kind, entries=payload.get("entries", {}))

    def entries_fingerprint(self) -> str:
        """sha256 of the entries (``repro``'s bytes): it rides the
        result-cache key, since a tuned chunk changes the attribution bits."""
        blob = json.dumps(self.entries, sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()

    def save(self, results_dir: str) -> str:
        os.makedirs(results_dir, exist_ok=True)
        path = cache_path(results_dir, self.kind)
        with open(path, "w") as fh:
            json.dump({"device": self.kind, "entries": self.entries}, fh, indent=1)
        return path

    def config_for(self, key: str) -> Optional[HotpathConfig]:
        e = self.entries.get(key)
        if e is None:
            return None
        return HotpathConfig(
            chunk=int(e["chunk"]),
            block_k=int(e.get("block_k", DEFAULT_BLOCK_K)),
            block_f=int(e.get("block_f", DEFAULT_BLOCK_F)),
            attn_block_q=int(e.get("attn_block_q", 0)),
            attn_block_k=int(e.get("attn_block_k", 0)),
        )

    def put(self, key: str, cfg: HotpathConfig, metrics: dict) -> None:
        self.entries[key] = {
            "chunk": cfg.chunk, "block_k": cfg.block_k, "block_f": cfg.block_f,
            "attn_block_q": cfg.attn_block_q, "attn_block_k": cfg.attn_block_k,
            **metrics,
        }


def chunk_candidates(m: int) -> list[int]:
    """Power-of-two divisors of ``m`` (ascending, ``m`` itself last).

        >>> chunk_candidates(8)
        [1, 2, 4, 8]
        >>> chunk_candidates(12)
        [1, 2, 4, 12]
    """
    out = [c for c in (2**i for i in range(m.bit_length())) if m % c == 0]
    if m not in out:
        out.append(m)
    return out


def _median_latency(call, args: tuple, rounds: int, device: torch.device) -> float:
    """Median wall seconds of ``call(*args)`` over ``rounds`` calls after one
    warm call, each ended by a synchronise on a CUDA device."""

    def once():
        out = call(*args)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    once()
    ts = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        once()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def autotune_engine(
    engine,
    requests: Sequence,
    *,
    rounds: int = 3,
    max_measured: int = 3,
    results_dir: str = "results",
    save: bool = True,
) -> dict:
    """Tune the chunk of each bucket that ``requests`` touch.

    ``engine`` is an ``ExplainEngine`` serving an LM (``ArchConfig``) with a
    gradient method; tune with the traffic you serve. Candidates run as
    standalone callables, so the engine's cache and stats are untouched.
    Returns a report (per bucket: every candidate's predicted bytes, FLOPs,
    bound and peak, its measured median seconds or why it was pruned, the
    measured peak of each timed candidate on a CUDA device, and the
    winner); with ``save`` the winners go to
    ``results/autotune_<device>.json`` for ``ExplainEngine(autotune=True)``.
    """
    from repro_torch.serve.batching import plan_buckets

    dev = engine.device
    kind = device_kind(dev)
    hw = hardware_for(kind)
    cache = AutotuneCache.load(results_dir, kind)
    # explain()'s plan exactly: path ensembles replicate requests before
    # bucketing, so the tuned shapes come from the expanded traffic
    n = engine.n_samples
    expanded = list(requests) if n == 1 else [r for r in requests for _ in range(n)]
    plan = plan_buckets(expanded, seq_buckets=engine.seq_buckets, batch_buckets=engine.batch_buckets,
                        max_batch=engine.max_batch, pad_id=engine.pad_id, batch_multiple=engine.dp)
    report = {"device": kind, "hw": hw.name, "buckets": {}}
    seen: set[tuple[int, int]] = set()
    for bb in plan:
        if bb.bucket in seen:
            continue
        seen.add(bb.bucket)
        with_fx = bb.f_x is not None
        probes = engine._forwards_a_row(with_fx=with_fx)
        cands = []
        for chunk in chunk_candidates(engine.m):
            cost = hotpath_cost(engine.cfg, bb.bucket, engine.m, chunk, engine.cfg.compute_dtype,
                                probe_forwards=probes, fused=engine.fused)
            c = {"cfg": HotpathConfig(chunk), "peak_bytes": cost["peak bytes"], **hotpath_terms(cost, hw)}
            if cost["peak bytes"] > hw.hbm_bytes:
                c["pruned"] = "memory"  # never launched: it would not fit
            cands.append(c)
        admitted = sorted((c for c in cands if "pruned" not in c),
                          key=lambda c: (c["bound_s"], c["memory_s"]))
        if not admitted:
            raise ValueError(f"autotune: no chunk of m={engine.m} fits bucket {bb.bucket} in "
                             f"{hw.hbm_bytes / 1e9:.0f} GB by the cost model")
        args = engine._bucket_inputs(bb)
        for c in admitted[max_measured:]:
            c["pruned"] = "roofline"
        for c in admitted[:max_measured]:
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            c["latency_s"] = _median_latency(engine._attr_fn_at(c["cfg"], with_fx=with_fx), args,
                                             rounds, dev)
            if dev.type == "cuda":
                c["measured_peak_bytes"] = float(torch.cuda.max_memory_allocated(dev))
        best = min(admitted[:max_measured], key=lambda c: c["latency_s"])
        key = bucket_key(bb.bucket, engine._spec.accum, engine.schedule, engine.m, engine.n_int,
                         engine.fused, attn=engine.attn)
        cache.put(key, best["cfg"], {
            "bytes_accessed": best["bytes_accessed"],
            "latency_s": best["latency_s"],
            "bound_s": best["bound_s"],
            "dominant": best["dominant"],
        })
        report["buckets"][key] = {
            "winner": vars(best["cfg"]) | {"latency_s": best["latency_s"]},
            "candidates": [
                {**vars(c["cfg"]), **{k: c[k] for k in ("bytes_accessed", "flops", "bound_s", "peak_bytes")},
                 **{k: c.get(k) for k in ("latency_s", "measured_peak_bytes", "pruned")}}
                for c in cands
            ],
        }
    if save:
        report["path"] = cache.save(results_dir)
    return report
