"""Warm-start persistence: ``repro.serve.warm_state`` in the replay form.

``repro`` persists its compiled XLA executables, so a restarted engine
explains with zero compiles. The port has no executable to serialize: a
miss is a Python closure build (``ExplainEngine._build``), and what a new
torch process pays is first-launch work — loading each Triton
specialization and the CUDA extension, cuBLAS's first call at each GEMM
shape, the caching allocator's growth. So the warm state persists the key
set with each key's argument shapes and dtypes (recorded when the key was
built), the autotune entries and the adaptive hop-zero δ-history, and
``load_warm_state`` rebuilds every key and replays it once on seeded
synthetic inputs of its recorded shapes, so the first real round runs warm.
No request data is stored.

Files, written with ``checkpoint.manager.atomic_dir`` (a temporary
directory and one ``os.replace``):

  * ``state.json`` — the autotune device and entries, the δ-history, and
    each key with its argument spec;
  * ``manifest.json`` — the format, the torch version, the device kind,
    ``ExplainEngine.warm_context()``, the key count and each file's sha256.

Any mismatch falls back cold with a warning, where ``repro`` does: an
unreadable manifest or state, an unknown format, a corrupted shard, another
model or other knobs (the context). Entries tuned for another device kind
are dropped with a warning and the rest restores. No directory at all is a
quiet cold start (a first boot). A warm state can make a restart slow
again, never wrong.

    eng = ExplainEngine(cfg, params, ...)
    eng.explain(traffic)                   # build the key set
    save_warm_state(eng, "build/warm")
    ...a new process...
    eng2 = ExplainEngine(cfg, params, ...) # same model and knobs
    report = load_warm_state(eng2, "build/warm")
    eng2.explain(traffic)                  # no miss, warm launches
"""
from __future__ import annotations

import json
import os
import warnings
from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.checkpoint.manager import atomic_dir, sha256_file
from repro_torch.core.ig import IGState
from repro_torch.core.schedule import Schedule
from repro_torch.serve.autotune import HotpathConfig, device_kind

_MANIFEST = "manifest.json"
_STATE = "state.json"
_FORMAT = 1
_NAMED = {"Schedule": Schedule, "IGState": IGState}  # the NamedTuples in argument trees


def arg_spec(tree: Any) -> Any:
    """The JSON form of an argument tree's shapes and dtypes: a tensor is
    ``{"shape", "dtype"}``, a dict ``{"dict": ...}``, a tuple ``{"tuple":
    [...]}``, a ``Schedule``/``IGState`` ``{name: [...]}``."""
    if isinstance(tree, torch.Tensor):
        return {"shape": list(tree.shape), "dtype": str(tree.dtype).removeprefix("torch.")}
    if isinstance(tree, dict):
        return {"dict": {k: arg_spec(v) for k, v in tree.items()}}
    if isinstance(tree, tuple):
        name = type(tree).__name__
        if name in _NAMED:
            return {name: [arg_spec(v) for v in tree]}
        if hasattr(tree, "_fields"):
            raise TypeError(f"arg_spec: NamedTuple {name} has no spec form")
        return {"tuple": [arg_spec(v) for v in tree]}
    if tree is None:
        return None
    raise TypeError(f"arg_spec: no spec form for {type(tree).__name__}")


def synthetic_args(spec: Any, g: torch.Generator, *, device: Any = "cuda", zero: bool = False) -> Any:
    """Seeded inputs of a spec's shapes and dtypes on ``device``: floats
    uniform in [0, 1) (valid interpolation nodes and masks), integers and
    booleans 0 (valid token ids and positions); an ``IGState`` all 0."""
    if spec is None:
        return None
    if "shape" in spec:
        dtype = getattr(torch, spec["dtype"])
        if zero or not dtype.is_floating_point:
            return torch.zeros(spec["shape"], dtype=dtype, device=device)
        return torch.rand(spec["shape"], generator=g).to(device=device, dtype=dtype)
    if "dict" in spec:
        return {k: synthetic_args(v, g, device=device, zero=zero) for k, v in spec["dict"].items()}
    if "tuple" in spec:
        return tuple(synthetic_args(v, g, device=device, zero=zero) for v in spec["tuple"])
    (name, leaves), = spec.items()
    return _NAMED[name](*(synthetic_args(v, g, device=device, zero=zero or name == "IGState") for v in leaves))


def _encode_key(key: Any) -> Any:
    """A cache key as JSON: tuples become lists, a ``HotpathConfig`` a
    tagged dict (no key holds a list, so decoding is exact)."""
    if isinstance(key, HotpathConfig):
        return {"HotpathConfig": vars(key)}
    if isinstance(key, tuple):
        return [_encode_key(k) for k in key]
    return key


def _decode_key(obj: Any) -> Any:
    if isinstance(obj, dict):
        return HotpathConfig(**obj["HotpathConfig"])
    if isinstance(obj, list):
        return tuple(_decode_key(o) for o in obj)
    return obj


@dataclass
class WarmRestoreReport:
    """What ``load_warm_state`` did: ``restored`` with ``executables`` keys
    rebuilt and replayed (``via="replay"``), or cold with a ``reason``."""

    restored: bool
    via: str = ""
    executables: int = 0
    reason: str = ""


def _cold(reason: str) -> WarmRestoreReport:
    warnings.warn(f"warm_state: {reason}; starting cold (correctness is unaffected)", stacklevel=3)
    return WarmRestoreReport(restored=False, reason=reason)


def save_warm_state(engine: Any, directory: str) -> str:
    """Persist the engine's key set with its argument specs, the autotune
    entries and the δ-history; returns ``directory``. A crash mid-save
    leaves any earlier warm state as it was."""
    # the δ-history may imply elevated starting rungs that serving never
    # built: close the set first
    if engine.hop_zero:
        engine.precompile_hop_zero_starts()
    tuned = engine._autotune_cache
    state = {
        "autotune_device": tuned.kind if tuned else "",
        "autotune_entries": tuned.entries if tuned else {},
        "delta_hist": {f"{s}:{meth}": list(map(int, hist)) for (s, meth), hist in engine._delta_hist.items()},
        "keys": [{"key": _encode_key(k), "args": engine._arg_specs[k]} for k in engine._cache],
    }
    with atomic_dir(directory) as tmp:
        with open(os.path.join(tmp, _STATE), "w") as fh:
            json.dump(state, fh)
        manifest = {
            "format": _FORMAT,
            "torch_version": torch.__version__,
            "device_kind": device_kind(engine.device),
            "context": engine.warm_context(),
            "n_executables": len(state["keys"]),
            "files": {_STATE: sha256_file(os.path.join(tmp, _STATE))},
        }
        with open(os.path.join(tmp, _MANIFEST), "w") as fh:
            json.dump(manifest, fh, indent=1)
    return directory


def load_warm_state(engine: Any, directory: str) -> WarmRestoreReport:
    """Validate a warm state and restore it into ``engine``, in ``repro``'s
    order: the autotune entries (keys carry each bucket's resolved config,
    so the engine must resolve what the saving engine did), the δ-history,
    then the key set, every key rebuilt and replayed once on synthetic
    inputs from ``torch.Generator().manual_seed(0)``. Replay goes around
    ``stats``, the δ-history and the result cache. Every validation failure
    falls back cold with a warning, before the engine is touched."""
    mpath = os.path.join(directory, _MANIFEST)
    if not os.path.isfile(mpath):
        return WarmRestoreReport(restored=False, reason="no warm state")
    try:
        with open(mpath) as fh:
            manifest = json.load(fh)
    except (json.JSONDecodeError, OSError) as e:
        return _cold(f"unreadable manifest ({e})")
    if not isinstance(manifest, dict) or manifest.get("format") != _FORMAT:
        return _cold(f"unknown format {manifest.get('format') if isinstance(manifest, dict) else None!r}")
    for name, digest in manifest.get("files", {}).items():
        path = os.path.join(directory, name)
        if not os.path.isfile(path) or sha256_file(path) != digest:
            return _cold(f"corrupted or missing shard {name!r}")
    if manifest.get("context") != engine.warm_context():
        return _cold("engine context mismatch (different model or knobs)")
    try:
        with open(os.path.join(directory, _STATE)) as fh:
            state = json.load(fh)
        hist = {}
        for skey, values in state.get("delta_hist", {}).items():
            s, meth = skey.split(":", 1)
            hist[(int(s), meth)] = [int(v) for v in values]
        keys = [(_decode_key(e["key"]), e["args"]) for e in state.get("keys", [])]
    except (json.JSONDecodeError, OSError, KeyError, TypeError, ValueError) as e:
        return _cold(f"unreadable state ({e})")

    entries = state.get("autotune_entries") or {}
    if engine._autotune_cache is not None and entries:
        here = device_kind(engine.device)
        if state.get("autotune_device") != here:
            warnings.warn(f"warm_state: autotune entries were tuned for {state.get('autotune_device')!r}, "
                          f"not {here!r}; ignoring them", stacklevel=2)
        else:
            engine._autotune_cache.entries = dict(entries)
    engine._delta_hist.update(hist)
    g = torch.Generator().manual_seed(0)
    for key, spec in keys:
        fn = engine._cache[key] = engine._build(key)
        engine._arg_specs[key] = spec
        fn(*synthetic_args(spec, g, device=engine.device))
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    return WarmRestoreReport(restored=True, via="replay", executables=len(keys))
