"""The language model of ``repro.models.lm``, for the dense llama-style LMs.

Parameters keep ``repro``'s tree: ``embed`` (``embedding`` (V, d), and
``unembed`` (d, V) unless tied), ``final_norm``, ``layers`` — a tuple over
the layer pattern of dicts whose tensors carry a leading period axis — and
``rem``, the remainder layers. A Python loop over the periods replaces
``repro``'s ``lax.scan``, so ``params_from_numpy`` (``models.common``)
maps ``repro``'s tree as it is.

Entry points: ``param_defs`` / ``init_params`` (parameters),
``embed_inputs`` / ``hidden_from_embeds`` (the embedding-space hooks IG
differentiates through) and ``logits``. ``repro``'s MoE auxiliary loss is 0
for these layers and is not returned. Not ported yet: the encoder, the stub
frontends, the training loss and prefill/decode with their cache.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import blocks
# params_from_numpy is re-exported: the bridge that carries repro's weights across
from repro_torch.models.common import init_params as init_tree, params_from_numpy  # noqa: F401
from repro_torch.models.common import stack_defs, tree_map
from repro_torch.models.layers import embed, embed_def, rmsnorm, rmsnorm_def, unembed


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` for a config this LM cannot build."""
    layers = {(s.mixer, s.ffn) for s in cfg.pattern}
    if layers != {("attn", "dense")} or cfg.frontend or cfg.is_encdec or cfg.sliding_window:
        raise NotImplementedError(
            f"{cfg.name}: the port's LM builds full-attention dense layers without frontend "
            "or encoder only; the other architectures wait on ROADMAP.md queue 1, items 4 "
            "and 7 (local attention, MoE, SSM, frontends, the encoder)")


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
