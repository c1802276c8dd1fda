"""The language model of ``repro.models.lm``: the llama-style stacks of
full-attention layers, gemma3's pattern of sliding-window (local) layers
between full-attention ones, the MoE stacks (qwen3-moe), the attention-free
Mamba-2 stack (mamba2), the hybrid of all three (jamba), the
encoder-decoder over stub audio frames (whisper) and the backbone with stub
vision patches prepended (internvl2).

Parameters keep ``repro``'s tree: ``embed`` (``embedding`` (V, d), and
``unembed`` (d, V) unless tied), ``final_norm``, ``layers`` — a tuple over
the layer pattern of dicts whose tensors carry a leading period axis — and
``rem``, the remainder layers; an encoder-decoder adds ``encoder``
(``layers``, stacked over the encoder's depth, and ``final_norm``) and each
decoder layer its ``norm_x`` and ``cross``; a stub frontend adds
``embed.frontend_proj``. A Python loop over the periods replaces
``repro``'s ``lax.scan``, so ``params_from_numpy`` (``models.common``)
maps ``repro``'s tree as it is.

Entry points: ``param_defs`` / ``init_params`` / ``abstract_params``
(parameters; the last as ``meta`` tensors for the dry run),
``embed_inputs`` / ``hidden_from_embeds`` (the embedding-space hooks IG
differentiates through), ``encode`` (the encoder over stub frames),
``forward_hidden`` (the backbone over a batch with its frontend),
``logits``, serving: ``init_cache``, ``prefill``, ``decode_step`` and
``decode_snapshot`` (what a retried decode chunk restores), and training:
``forward_hidden_train`` (the backbone with ``repro``'s summed MoE
auxiliary loss, each period optionally recomputed in the backward) and
``loss``. The explain and serve entry points leave the auxiliary loss out.

The decode cache is ``repro``'s tree: ``layers`` (per pattern entry, k and
v stacked over the periods, (P, B, slots, NKV, D): ``max_len`` slots for a
full-attention layer, a ring of min(w, max_len) for a local one; a mamba
layer's f32 state (P, B, H, hd, N) and conv tail (P, B, W − 1, channels)),
``rem`` and ``len``, the one valid length of the batch; a decoder layer
of an encoder-decoder also holds its cross-attention's keys and values of
the encoder output, ``xk``/``xv`` (P, B, encoder_seq, NKV, D). Its tensors are written in place, the
port's counterpart of ``repro``'s donated cache: no step copies the cache,
and a cache passed to ``decode_step`` is the one it returns. ``len`` is a
() int32 tensor on the CPU: the host drives the loop and indexes the cache
with it, so reading it waits for no device work.

As in ``repro``, the embeddings and the residual stream after each layer of
a period stay batch- (or sequence-) sharded and replicated over the
tensor-parallel axis (``sharding.context.constrain``, which acts on the dry
run's sharded cells only).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.models import blocks
# params_from_numpy is re-exported: the bridge that carries repro's weights across
from repro_torch.models.common import init_params as init_tree, params_from_numpy  # noqa: F401
from repro_torch.models.common import abstract_params as abstract_tree, stack_defs, tree_map
from repro_torch.models.layers import (embed, embed_def, project_frontend, rmsnorm, rmsnorm_def,
                                       softmax_xent_chunked, unembed)
from repro_torch.sharding.context import constrain

ENC_SPEC = LayerSpec("attn", "dense")  # every encoder layer


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a config whose layers this LM
    cannot build: a layer without a mixer or a local layer without a
    window."""
    ok = all(s.mixer in ("attn", "mamba") or (s.mixer == "local" and cfg.sliding_window)
             for s in cfg.pattern)
    if not ok:
        raise NotImplementedError(
            f"{cfg.name}: the port's LM builds attention, sliding-window and Mamba-2 layers with "
            "dense, MoE or no FFN only")


def param_defs(cfg: ArchConfig) -> dict:
    check_supported(cfg)
    cross = cfg.is_encdec
    defs = {
        "embed": embed_def(cfg),
        "final_norm": rmsnorm_def(cfg.d_model),
        "layers": tuple(stack_defs(blocks.layer_def(cfg, spec, cross=cross), cfg.num_periods)
                        for spec in cfg.pattern),
        "rem": tuple(blocks.layer_def(cfg, spec, cross=cross) for spec in cfg.remainder_specs),
    }
    if cfg.is_encdec:
        defs["encoder"] = {"layers": stack_defs(blocks.layer_def(cfg, ENC_SPEC), cfg.encoder_layers),
                           "final_norm": rmsnorm_def(cfg.d_model)}
    return defs


def init_params(cfg: ArchConfig, generator: torch.Generator, device="cuda") -> dict:
    """Fresh weights with ``repro``'s rule (``models.common.init_params``),
    drawn on the generator's device — a CUDA generator draws on the card."""
    return init_tree(param_defs(cfg), generator, dtype=getattr(torch, cfg.param_dtype),
                     device=device)


def abstract_params(cfg: ArchConfig) -> dict:
    """``param_defs``' tree of ``meta`` tensors in ``cfg.param_dtype``: the
    dry run's parameters."""
    return abstract_tree(param_defs(cfg), dtype=getattr(torch, cfg.param_dtype))


def embed_inputs(cfg: ArchConfig, params: Any, batch: dict) -> torch.Tensor:
    """Token (+ stub frontend) inputs -> backbone embeddings (B, S, d) in the
    compute dtype. A vision config prepends the projected patches of
    ``batch["frontend"]`` (B, frontend_tokens, frontend_dim) when the batch
    has them; audio frames feed the encoder instead (``encode``)."""
    dt = getattr(torch, cfg.compute_dtype)
    e = embed(params["embed"], batch["tokens"], cfg, dt)
    if cfg.frontend == "vision" and "frontend" in batch:
        e = torch.cat([project_frontend(params["embed"], batch["frontend"], dt), e], dim=1)
    return constrain(e, "batch", "seq", None)


def _residual(cfg: ArchConfig, i: int, x: torch.Tensor) -> torch.Tensor:
    """``repro``'s pin of the residual stream after layer ``i`` when it is a
    period's layer (not a remainder layer's)."""
    return constrain(x, "batch", "seq", None) if i < cfg.num_periods * len(cfg.pattern) else x


def encode(cfg: ArchConfig, params: Any, frontend: torch.Tensor) -> torch.Tensor:
    """The encoder (whisper) over stub frame features (B, S_enc,
    frontend_dim): their projection, then ``encoder_layers`` non-causal
    attention layers (the flash op under ``attn_impl="flash"``) and the
    final norm -> (B, S_enc, d) in the compute dtype."""
    x = project_frontend(params["embed"], frontend, getattr(torch, cfg.compute_dtype))
    pos = torch.arange(x.shape[1], device=x.device).expand(x.shape[:2])
    enc = params["encoder"]
    for i in range(cfg.encoder_layers):
        x = blocks.apply_layer(cfg, ENC_SPEC, tree_map(lambda _, t: t[i], enc["layers"]), x,
                               positions=pos, causal=False)
    return rmsnorm(enc["final_norm"], x, cfg.norm_eps)


def hidden_from_embeds(
    cfg: ArchConfig,
    params: Any,
    e: torch.Tensor,
    *,
    enc_out: Optional[torch.Tensor] = None,
    lengths: Optional[torch.Tensor] = None,  # (B,) ragged valid lengths
) -> torch.Tensor:
    """Backbone over embeddings -> final-normed hidden states (B, S, d).
    ``lengths`` reach the attention as its valid key lengths (the flash
    op's ``kvlen``); with ``enc_out`` the decoder layers cross-attend to it,
    without it they skip their cross-attention, as in ``repro``."""
    pos = torch.arange(e.shape[1], device=e.device).expand(e.shape[:2])
    x = e
    for i, (spec, lp) in enumerate(_per_layer(cfg, params)):
        x = _residual(cfg, i, blocks.apply_layer(cfg, spec, lp, x, positions=pos, enc_out=enc_out,
                                                 kv_len=lengths))
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


def forward_hidden(cfg: ArchConfig, params: Any, batch: dict) -> torch.Tensor:
    """The backbone over a batch (``tokens``, and ``frontend`` for a
    frontend config): the encoder's output for an encoder-decoder, the
    patches prepended for a vision config -> hidden states (B, S, d)."""
    enc_out = encode(cfg, params, batch["frontend"]) if cfg.is_encdec else None
    return hidden_from_embeds(cfg, params, embed_inputs(cfg, params, batch), enc_out=enc_out)


def logits(cfg: ArchConfig, params: Any, h: torch.Tensor) -> torch.Tensor:
    return unembed(params["embed"], h, cfg)


# ----------------------------------------------------------------- training


def _unbound_periods(cfg: ArchConfig, layers: tuple) -> list:
    """The stacked pattern entries split into one tuple a period, each leaf
    ``unbind`` once: its backward writes the stacked gradient once, where a
    ``select`` a period would write a zero stack a period and sum them."""
    cols: dict = {}

    def split(path, x):
        cols[path] = x.unbind(0)

    tree_map(split, layers)
    return [tree_map(lambda path, _: cols[path][i], layers) for i in range(cfg.num_periods)]


def forward_hidden_train(cfg: ArchConfig, params: Any, batch: dict, *, remat: bool = False
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """The backbone over a batch for training -> (final-normed hidden states
    (B, S, d), the f32 () MoE auxiliary loss summed over the layers as in
    ``repro``: within a period, then over the periods, then the remainder).
    With ``remat`` each period runs under ``torch.utils.checkpoint``
    (non-reentrant), ``repro``'s ``jax.checkpoint`` of a period: its
    activations are recomputed in the backward, so its flash forward runs
    twice a step."""
    enc_out = encode(cfg, params, batch["frontend"]) if cfg.is_encdec else None
    e = embed_inputs(cfg, params, batch)
    pos = torch.arange(e.shape[1], device=e.device).expand(e.shape[:2])
    zero = lambda: torch.zeros((), dtype=torch.float32, device=e.device)

    def layer(spec, lp, x, aux):
        x, a = blocks.apply_layer_with_aux(cfg, spec, lp, x, positions=pos, enc_out=enc_out)
        return x, aux if a is None else aux + a

    def period(x, lps):
        aux = zero()
        for spec, lp in zip(cfg.pattern, lps):
            x, aux = layer(spec, lp, x, aux)
            x = constrain(x, "batch", "seq", None)  # residual stays DP/SP
        return x, aux

    x, auxs = e, []
    for lps in _unbound_periods(cfg, params["layers"]):
        x, a = checkpoint(period, x, lps, use_reentrant=False) if remat else period(x, lps)
        auxs.append(a)
    aux = torch.sum(torch.stack(auxs)) if auxs else zero()
    for spec, lp in zip(cfg.remainder_specs, params["rem"]):
        x, aux = layer(spec, lp, x, aux)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def loss(cfg: ArchConfig, params: Any, batch: dict, *, remat: bool = False) -> torch.Tensor:
    """Next-token cross-entropy (``softmax_xent_chunked``) + the MoE
    auxiliary loss; f32 (). ``batch["labels"]`` (B, S_text): a vision
    config labels only the text positions, after its patches."""
    h, aux = forward_hidden_train(cfg, params, batch, remat=remat)
    if cfg.frontend == "vision":  # only text positions carry labels
        h = h[:, -batch["labels"].shape[1]:]
    return softmax_xent_chunked(params["embed"], h, batch["labels"], cfg) + aux


# ----------------------------------------------------------------- serving


def init_cache(cfg: ArchConfig, batch: int, max_len: int, device="cuda", *, kv_slots: int = 0) -> dict:
    """The empty decode cache, in the compute dtype, on ``device``; with
    ``kv_slots``, ``repro``'s TP-expanded KV head count (``blocks.layer_cache``)."""
    dt = getattr(torch, cfg.compute_dtype)
    one = lambda spec: blocks.layer_cache(cfg, spec, batch, max_len, dt, device, kv_slots=kv_slots)
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
def prefill(cfg: ArchConfig, params: Any, batch: dict, max_len: int, *, kv_slots: int = 0,
            cache: Optional[dict] = None) -> tuple[torch.Tensor, dict]:
    """Run the prompt, fill a new cache (of ``kv_slots`` expanded KV heads,
    see ``init_cache``; or ``cache``, an empty one the caller made, as the
    dry run's sharded cells do), return the last position's logits (B, 1, V). The sequence counts a vision config's prepended patches; an
    encoder-decoder encodes ``batch["frontend"]`` first and caches each
    decoder layer's cross keys and values of it. Raises ``ValueError`` when
    the sequence is longer than the cache (``repro`` asserts it) or the
    frames are not ``encoder_seq`` long."""
    enc_out = encode(cfg, params, batch["frontend"]) if cfg.is_encdec else None
    if enc_out is not None and enc_out.shape[1] != cfg.encoder_seq:
        raise ValueError(f"{enc_out.shape[1]} encoder frames; {cfg.name} caches {cfg.encoder_seq}")
    e = embed_inputs(cfg, params, batch)
    B, S, _ = e.shape
    if S > max_len:
        raise ValueError(f"prefill length {S} exceeds cache max_len {max_len}")
    pos = torch.arange(S, device=e.device).expand(B, S)
    if cache is None:
        cache = init_cache(cfg, B, max_len, device=e.device, kv_slots=kv_slots)
    x = e
    for i, (spec, lp, lc) in enumerate(_layers(cfg, params, cache)):
        x, _ = blocks.apply_layer_prefill(cfg, spec, lp, x, lc, positions=pos, enc_out=enc_out)
        x = _residual(cfg, i, x)
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
    for i, (spec, lp, lc) in enumerate(_layers(cfg, params, cache)):
        x, _ = blocks.apply_layer_decode(cfg, spec, lp, x, lc, pos)
        x = _residual(cfg, i, x)
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
