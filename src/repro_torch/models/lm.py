"""The language model of ``repro.models.lm``: the llama-style stacks of
full-attention layers, gemma3's pattern of sliding-window (local) layers
between full-attention ones, the MoE stacks (qwen3-moe), the attention-free
Mamba-2 stack (mamba2) and the hybrid of all three (jamba).

Parameters keep ``repro``'s tree: ``embed`` (``embedding`` (V, d), and
``unembed`` (d, V) unless tied), ``final_norm``, ``layers`` — a tuple over
the layer pattern of dicts whose tensors carry a leading period axis — and
``rem``, the remainder layers. A Python loop over the periods replaces
``repro``'s ``lax.scan``, so ``params_from_numpy`` (``models.common``)
maps ``repro``'s tree as it is.

Entry points: ``param_defs`` / ``init_params`` (parameters),
``embed_inputs`` / ``hidden_from_embeds`` (the embedding-space hooks IG
differentiates through), ``logits``, and serving: ``init_cache``,
``prefill``, ``decode_step`` and ``decode_snapshot`` (what a retried
decode chunk restores). ``repro``'s MoE auxiliary loss is not returned: it
feeds only the training loss, which is not ported yet, nor are the
encoder and the stub frontends.

The decode cache is ``repro``'s tree: ``layers`` (per pattern entry, k and
v stacked over the periods, (P, B, slots, NKV, D): ``max_len`` slots for a
full-attention layer, a ring of min(w, max_len) for a local one; a mamba
layer's f32 state (P, B, H, hd, N) and conv tail (P, B, W − 1, channels)),
``rem`` and ``len``, the one valid length of the batch. Its tensors are written in place, the
port's counterpart of ``repro``'s donated cache: no step copies the cache,
and a cache passed to ``decode_step`` is the one it returns. ``len`` is a
() int32 tensor on the CPU: the host drives the loop and indexes the cache
with it, so reading it waits for no device work.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks
# params_from_numpy is re-exported: the bridge that carries repro's weights across
from repro_torch.models.common import init_params as init_tree, params_from_numpy  # noqa: F401
from repro_torch.models.common import stack_defs, tree_map
from repro_torch.models.layers import embed, embed_def, rmsnorm, rmsnorm_def, unembed


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a config this LM cannot build: a
    layer without a mixer, a local layer without a window, a frontend or an
    encoder."""
    ok = all(s.mixer in ("attn", "mamba") or (s.mixer == "local" and cfg.sliding_window)
             for s in cfg.pattern)
    if not ok or cfg.frontend or cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: the port's LM builds attention, sliding-window and Mamba-2 layers with "
            "dense, MoE or no FFN, without frontend or encoder only")


def param_defs(cfg: ArchConfig) -> dict:
    check_supported(cfg)
    return {
        "embed": embed_def(cfg),
        "final_norm": rmsnorm_def(cfg.d_model),
        "layers": tuple(stack_defs(blocks.layer_def(cfg, spec), cfg.num_periods)
                        for spec in cfg.pattern),
        "rem": tuple(blocks.layer_def(cfg, spec) for spec in cfg.remainder_specs),
    }


def init_params(cfg: ArchConfig, generator: torch.Generator, device="cuda") -> dict:
    """Fresh weights with ``repro``'s rule (``models.common.init_params``),
    drawn on the generator's device — a CUDA generator draws on the card."""
    return init_tree(param_defs(cfg), generator, dtype=getattr(torch, cfg.param_dtype),
                     device=device)


def embed_inputs(cfg: ArchConfig, params: Any, batch: dict) -> torch.Tensor:
    """Token inputs -> backbone embeddings (B, S, d) in the compute dtype."""
    return embed(params["embed"], batch["tokens"], cfg, getattr(torch, cfg.compute_dtype))


def hidden_from_embeds(
    cfg: ArchConfig,
    params: Any,
    e: torch.Tensor,
    *,
    lengths: Optional[torch.Tensor] = None,  # (B,) ragged valid lengths
) -> torch.Tensor:
    """Backbone over embeddings -> final-normed hidden states (B, S, d).
    ``lengths`` reach the attention as its valid key lengths (the flash
    op's ``kvlen``)."""
    pos = torch.arange(e.shape[1], device=e.device).expand(e.shape[:2])
    x = e
    for i in range(cfg.num_periods):
        for spec, lp in zip(cfg.pattern, params["layers"]):
            x = blocks.apply_layer(cfg, spec, tree_map(lambda _, t: t[i], lp), x,
                                   positions=pos, kv_len=lengths)
    for spec, lp in zip(cfg.remainder_specs, params["rem"]):
        x = blocks.apply_layer(cfg, spec, lp, x, positions=pos, kv_len=lengths)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


def logits(cfg: ArchConfig, params: Any, h: torch.Tensor) -> torch.Tensor:
    return unembed(params["embed"], h, cfg)


# ----------------------------------------------------------------- serving


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda") -> dict:
    """The empty decode cache, in the compute dtype, on ``device``."""
    dt = getattr(torch, cfg.compute_dtype)
    one = lambda spec: blocks.layer_cache(cfg, spec, batch, max_len, dt, device)
    stack = lambda _, t: t.new_zeros((cfg.num_periods,) + tuple(t.shape))
    return {
        "layers": tuple(tree_map(stack, one(spec)) for spec in cfg.pattern),
        "rem": tuple(one(spec) for spec in cfg.remainder_specs),
        "len": torch.zeros((), dtype=torch.int32),
    }


def _per_layer(cfg: ArchConfig, tree: dict):
    """(spec, entry) of ``tree`` (params or a cache) for every layer that
    runs, in order: each period's slice of the stacked pattern entries (views),
    then the remainder's."""
    for i in range(cfg.num_periods):
        for spec, t in zip(cfg.pattern, tree["layers"]):
            yield spec, tree_map(lambda _, x: x[i], t)
    yield from zip(cfg.remainder_specs, tree["rem"])


def _layers(cfg: ArchConfig, params: Any, cache: dict):
    """(spec, layer params, layer cache) in the order the layers run; the
    cache entries are views into the stacked tensors."""
    for (spec, lp), (_, lc) in zip(_per_layer(cfg, params), _per_layer(cfg, cache)):
        yield spec, lp, lc


@torch.no_grad()
def prefill(cfg: ArchConfig, params: Any, batch: dict, max_len: int) -> tuple[torch.Tensor, dict]:
    """Run the prompt, fill a new cache, return the last position's logits
    (B, 1, V). Raises ``ValueError`` when the prompt is longer than the
    cache (``repro`` asserts it)."""
    e = embed_inputs(cfg, params, batch)
    B, S, _ = e.shape
    if S > max_len:
        raise ValueError(f"prefill length {S} exceeds cache max_len {max_len}")
    pos = torch.arange(S, device=e.device).expand(B, S)
    cache = init_cache(cfg, B, max_len, device=e.device)
    x = e
    for spec, lp, lc in _layers(cfg, params, cache):
        x, _ = blocks.apply_layer_prefill(cfg, spec, lp, x, lc, positions=pos)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    cache["len"] = torch.tensor(S, dtype=torch.int32)
    return logits(cfg, params, x[:, -1:]), cache


@torch.no_grad()
def decode_step(cfg: ArchConfig, params: Any, cache: dict, token: torch.Tensor
                ) -> tuple[torch.Tensor, dict]:
    """token (B, 1) -> (logits (B, 1, V), the cache one longer). Raises
    ``ValueError`` when the cache of a full-attention layer that runs is
    full, where ``repro``'s clamped write would overwrite its last slot;
    local layers' rings never fill and a mamba layer keeps a state, so a
    model without full-attention layers (mamba2) has no cap."""
    pos = int(cache["len"])
    cap = next((lc["k"].shape[1] for spec, lc in _per_layer(cfg, cache) if spec.mixer == "attn"), None)
    if cap is not None and pos >= cap:
        raise ValueError(f"decode at position {pos}: the cache holds {cap} tokens")
    x = embed(params["embed"], token, cfg, getattr(torch, cfg.compute_dtype))
    for spec, lp, lc in _layers(cfg, params, cache):
        x, _ = blocks.apply_layer_decode(cfg, spec, lp, x, lc, pos)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    new_cache = {"layers": cache["layers"], "rem": cache["rem"],
                 "len": torch.tensor(pos + 1, dtype=torch.int32)}
    return logits(cfg, params, x), new_cache


def decode_snapshot(cfg: ArchConfig, cache: dict, n: int) -> Callable[[], None]:
    """Save the state of ``cache`` that a decode chunk of ``n`` steps
    overwrites and still reads: its length, in each local layer's ring the
    slots the steps write, and each mamba layer's state and conv tail
    (``blocks.decode_snapshot``). Returns the
    callable that puts it back, so that a chunk retried after a fault
    decodes what its first attempt would have."""
    length = cache["len"].clone()
    restores = [blocks.decode_snapshot(spec, lc, int(length), n) for spec, lc in _per_layer(cfg, cache)]

    def restore():
        cache["len"] = length.clone()
        for r in restores:
            r()

    return restore
