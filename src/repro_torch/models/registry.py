"""Model facades of ``repro.models.registry``: a config -> the functions the
explain engine serves through.

``Model`` binds an ``ArchConfig`` to ``models.lm``; ``VitFacade`` binds a
``VitConfig`` to ``models.vit``. Both expose ``target_logprob_at_fn``, the
bucketed serving output, and an embedding hook (``embed_inputs`` for token
models, ``embed_features`` for patch models); ``Model`` also binds the
decode cache's ``init_cache``, ``prefill`` and ``decode_step`` (full-attention
layers' static cache, local layers' rings, mamba layers' state and conv
tail, cross-attention keys and values), and ``forward_hidden``, the
backbone over a batch with its stub frontend (``frontend``: whisper's
frames, internvl2's patches). The target functions explain the token
stream only, as in ``repro``: no encoder output, no patches. ``loss`` is
the training loss (``lm.loss``). ``input_specs`` gives the dry run's
inputs of a (config, shape) cell as ``meta`` tensors.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models import lm, vit


class Model:
    """Thin namespace binding cfg -> the functional LM API."""

    def __init__(self, cfg: ArchConfig):
        lm.check_supported(cfg)
        self.cfg = cfg

    def param_defs(self) -> dict:
        return lm.param_defs(self.cfg)

    def init(self, generator: torch.Generator, device="cuda") -> dict:
        return lm.init_params(self.cfg, generator, device=device)

    def abstract_params(self) -> dict:
        return lm.abstract_params(self.cfg)

    def embed_inputs(self, params, batch: dict) -> torch.Tensor:
        return lm.embed_inputs(self.cfg, params, batch)

    def hidden_from_embeds(self, params, e: torch.Tensor, **kw) -> torch.Tensor:
        return lm.hidden_from_embeds(self.cfg, params, e, **kw)

    def forward_hidden(self, params, batch: dict) -> torch.Tensor:
        return lm.forward_hidden(self.cfg, params, batch)

    def logits(self, params, h: torch.Tensor) -> torch.Tensor:
        return lm.logits(self.cfg, params, h)

    def loss(self, params, batch: dict, *, remat: bool = False) -> torch.Tensor:
        return lm.loss(self.cfg, params, batch, remat=remat)

    def prefill(self, params, batch: dict, max_len: int, *, kv_slots: int = 0, cache=None):
        return lm.prefill(self.cfg, params, batch, max_len, kv_slots=kv_slots, cache=cache)

    def decode_step(self, params, cache: dict, token: torch.Tensor):
        return lm.decode_step(self.cfg, params, cache, token)

    def decode_snapshot(self, cache: dict, n: int):
        return lm.decode_snapshot(self.cfg, cache, n)

    def init_cache(self, batch: int, max_len: int, device="cuda", *, kv_slots: int = 0) -> dict:
        return lm.init_cache(self.cfg, batch, max_len, device=device, kv_slots=kv_slots)

    def target_logprob_fn(self, params, *, target_pos: int = -1):
        """f(embeds, target ids) -> (B,) next-token log-prob at ``target_pos``."""

        def f(e: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
            h = lm.hidden_from_embeds(self.cfg, params, e)
            lg = lm.logits(self.cfg, params, h[:, target_pos]).float()
            rows = torch.arange(e.shape[0], device=e.device)
            return torch.log_softmax(lg, dim=-1)[rows, target.long()]

        return f

    def target_logprob_at_fn(self, params):
        """Per-example-position variant for shape-bucketed serving.

        f(embeds, aux) -> (B,), aux = {"target": (B,) token ids, "pos": (B,)
        position of each row's last real token}: the logits are taken at
        ``h[rows, pos]`` only, so no (B, S, V) tensor exists. On the flash
        path the rows' lengths pos + 1 reach the kernels as ``kvlen``, as in
        ``repro``; the plain path needs no mask: causal right padding is
        already exact for attention, and for an SSM, which is causal too.
        Not for a MoE layer: its capacity is sized from all the call's
        tokens, padding included, and they compete for the experts' slots,
        so padding and batchmates can displace a real token's choice, as in
        ``repro``. Neither path masks that."""
        flash = self.cfg.attn_impl == "flash"

        def f(e: torch.Tensor, aux: dict) -> torch.Tensor:
            lengths = aux["pos"] + 1 if flash else None
            h = lm.hidden_from_embeds(self.cfg, params, e, lengths=lengths)
            rows = torch.arange(e.shape[0], device=e.device)
            lg = lm.logits(self.cfg, params, h[rows, aux["pos"].long()]).float()
            return torch.log_softmax(lg, dim=-1)[rows, aux["target"].long()]

        return f


class VitFacade:
    """The engine surface of ``models.vit`` (``repro``'s ``VitModel``)."""

    def __init__(self, cfg):
        self.cfg = cfg

    def embed_inputs(self, params, batch: dict) -> torch.Tensor:
        """Refused, as ``repro``'s ``VitModel.embed_inputs``: requests for a
        ViT carry ``features=patchify(cfg, image)``."""
        raise TypeError(vit.NO_TOKEN_EMBEDDING)

    def embed_features(self, params, feats: torch.Tensor) -> torch.Tensor:
        return vit.embed_features(self.cfg, params, feats)

    def target_logprob_at_fn(self, params):
        return vit.target_logprob_at_fn(self.cfg, params)


def model_for(cfg: Any):
    """Config -> model facade: ArchConfig -> ``Model`` (``NotImplementedError``
    for a layer kind the port's LM cannot build), VitConfig ->
    ``VitFacade``."""
    if isinstance(cfg, ArchConfig):
        return Model(cfg)
    if getattr(cfg, "patch_size", 0):
        return VitFacade(cfg)
    raise TypeError(f"no model facade for config type {type(cfg).__name__}")


def input_specs(cfg: ArchConfig, shape: ShapeConfig, *, kv_slots: int = 0) -> dict:
    """The inputs of the step the dry run counts for one cell, as ``meta``
    tensors (``repro``'s ``ShapeDtypeStruct`` stand-ins): a train batch
    (``tokens``, ``labels``, and a frontend's ``frontend`` features), a
    prefill batch, or a decode step's ``token`` (B, 1) and its cache of
    ``seq_len`` slots (``lm.init_cache`` on ``meta``, with ``kv_slots``
    expanded KV heads; an encoder-decoder's holds its cross-attention's
    ``xk``/``xv``; its ``len`` is the CPU scalar the host reads)."""
    B, S = shape.global_batch, shape.seq_len
    i32, cdt = torch.int32, getattr(torch, cfg.compute_dtype)
    sds = lambda shp, dt: torch.empty(shp, dtype=dt, device="meta")

    def frontend_spec():
        if cfg.frontend == "audio":
            return sds((B, cfg.encoder_seq, cfg.frontend_dim), cdt)
        return sds((B, cfg.frontend_tokens, cfg.frontend_dim or cfg.d_model), cdt)

    s_text = S - cfg.frontend_tokens if cfg.frontend == "vision" else S
    if shape.kind == "train":
        batch = {"tokens": sds((B, s_text), i32), "labels": sds((B, s_text), i32)}
    elif shape.kind == "prefill":
        batch = {"tokens": sds((B, s_text), i32)}
    else:  # decode: one new token against a cache of seq_len
        return {"token": sds((B, 1), i32), "cache": lm.init_cache(cfg, B, S, device="meta", kv_slots=kv_slots)}
    if cfg.frontend:
        batch["frontend"] = frontend_spec()
    return batch
