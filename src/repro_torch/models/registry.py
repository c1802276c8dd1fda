"""Model facades of ``repro.models.registry``: a config -> the functions the
explain engine serves through.

``Model`` binds an ``ArchConfig`` to ``models.lm``; ``VitFacade`` binds a
``VitConfig`` to ``models.vit``. Both expose ``target_logprob_at_fn``, the
bucketed serving output, and an embedding hook (``embed_inputs`` for token
models, ``embed_features`` for patch models); ``Model`` also binds the
decode cache's ``init_cache``, ``prefill`` and ``decode_step`` (full-attention
layers' static cache, local layers' rings, mamba layers' state and conv
tail). ``repro``'s
dry-run input specs and training loss are not ported here.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
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

    def embed_inputs(self, params, batch: dict) -> torch.Tensor:
        return lm.embed_inputs(self.cfg, params, batch)

    def hidden_from_embeds(self, params, e: torch.Tensor, **kw) -> torch.Tensor:
        return lm.hidden_from_embeds(self.cfg, params, e, **kw)

    def logits(self, params, h: torch.Tensor) -> torch.Tensor:
        return lm.logits(self.cfg, params, h)

    def prefill(self, params, batch: dict, max_len: int):
        return lm.prefill(self.cfg, params, batch, max_len)

    def decode_step(self, params, cache: dict, token: torch.Tensor):
        return lm.decode_step(self.cfg, params, cache, token)

    def decode_snapshot(self, cache: dict, n: int):
        return lm.decode_snapshot(self.cfg, cache, n)

    def init_cache(self, batch: int, max_len: int, device="cuda") -> dict:
        return lm.init_cache(self.cfg, batch, max_len, device=device)

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

    def embed_features(self, params, feats: torch.Tensor) -> torch.Tensor:
        return vit.embed_features(self.cfg, params, feats)

    def target_logprob_at_fn(self, params):
        return vit.target_logprob_at_fn(self.cfg, params)


def model_for(cfg: Any):
    """Config -> model facade: ArchConfig -> ``Model`` (``NotImplementedError``
    for an architecture the port's LM cannot build), VitConfig ->
    ``VitFacade``."""
    if isinstance(cfg, ArchConfig):
        return Model(cfg)
    if getattr(cfg, "patch_size", 0):
        return VitFacade(cfg)
    raise TypeError(f"no model facade for config type {type(cfg).__name__}")
