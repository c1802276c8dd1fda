"""Generation serving of ``repro.serve.engine``: batched prefill and decode
over a static KV cache.

``make_prefill_step`` / ``make_serve_step`` / ``make_decode_loop`` build the
plain functions ``ServeEngine`` drives; ``make_decode_chunk`` is the decode
unit of ``repro``'s scheduler, which also returns each chosen token's
log-probability (the explain probe's endpoint f(x)). The cache is
``models.lm``'s: fixed at ``max_len`` when it is made, written in place,
so no decode step copies it (``repro`` donates it instead).

Decoding is greedy argmax by default. Sampling needs an explicit
``torch.Generator``: the sampled step and loop take it as an argument, so
there is no path where sampling silently becomes argmax.

Sampling arithmetic: ``repro`` draws ``jax.random.categorical``, which is
argmax(gumbel(key) + logits / temperature). ``sample_token`` is that
function of (logits, Gumbel noise, temperature), and ``gumbel`` draws the
noise from the caller's generator on the logits' device. ``repro``'s key
schedule (``fold_in(key, k)`` at step k, ``fold_in(key, 2**32 − 1)`` for
the prefill token) has no torch counterpart: the port draws every step's
noise from the one generator in a fixed order (the prefill token's first,
then step 0, 1, …), so one seed gives the same tokens and another seed
another draw.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import tree_map
from repro_torch.models.registry import Model
from repro_torch.sharding.context import constrain


def make_prefill_step(cfg: ArchConfig, max_len: int, *, kv_slots: int = 0) -> Callable:
    """(params, batch) -> (last-position logits (B, 1, V), cache); the
    cache holds ``kv_slots`` expanded KV heads (``lm.init_cache``)."""
    model = Model(cfg)

    def prefill_step(params: Any, batch: dict) -> tuple[torch.Tensor, dict]:
        return model.prefill(params, batch, max_len, kv_slots=kv_slots)

    return prefill_step


def gumbel(generator: torch.Generator, shape, device="cuda") -> torch.Tensor:
    """Standard Gumbel noise in f32 drawn from ``generator``, which must lie
    on ``device``: −log(−log(u)), u uniform in [tiny, 1) as in
    ``jax.random.gumbel``."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))


def sample_token(logits: torch.Tensor, noise: torch.Tensor, temperature) -> torch.Tensor:
    """(B, V) logits and (B, V) Gumbel noise -> (B,) int32 ids:
    argmax(logits / temperature + noise) in f32. ``temperature`` (a () f32
    tensor on the logits' device, or a float) must be > 0."""
    t = torch.as_tensor(temperature, dtype=torch.float32, device=logits.device)
    return torch.argmax(logits.float() / t + noise, dim=-1).to(torch.int32)


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    # on the dry run's meshes the (B, V) row is gathered whole over the vocab:
    # DTensor's argmax over a sharded vocab fails where a rank holds one row
    return torch.argmax(constrain(logits, "batch", None, force=True), dim=-1).to(torch.int32)


def make_serve_step(cfg: ArchConfig, *, greedy: bool = True) -> Callable:
    """Makes the decode step.

    greedy=True:  (params, cache, token (B, 1)) -> (next (B, 1), cache), argmax.
    greedy=False: (params, cache, token (B, 1), generator, temperature) ->
                  (next (B, 1), cache), sampled with noise from ``generator``.
    """
    model = Model(cfg)

    if greedy:

        def serve_step(params: Any, cache: dict, token: torch.Tensor) -> tuple[torch.Tensor, dict]:
            logits, cache = model.decode_step(params, cache, token)
            return _greedy(logits[:, -1])[:, None], cache

        return serve_step

    def sample_step(params: Any, cache: dict, token: torch.Tensor, generator: torch.Generator,
                    temperature) -> tuple[torch.Tensor, dict]:
        logits, cache = model.decode_step(params, cache, token)
        lg = logits[:, -1]
        return sample_token(lg, gumbel(generator, lg.shape, lg.device), temperature)[:, None], cache

    return sample_step


def make_decode_loop(cfg: ArchConfig, *, greedy: bool = True) -> Callable:
    """A loop of ``num_steps`` serve steps; the cache is written in place.

    greedy=True:  (params, cache, token (B, 1), num_steps) -> tokens (B, n).
    greedy=False: (params, cache, token (B, 1), generator, temperature,
                  num_steps) -> tokens (B, n).
    """
    step = make_serve_step(cfg, greedy=greedy)

    def run(params: Any, cache: dict, token: torch.Tensor, num_steps: int, *step_args):
        toks = []
        for _ in range(num_steps):
            token, cache = step(params, cache, token, *step_args)
            toks.append(token)
        return torch.cat(toks, dim=1) if toks else token.new_zeros((token.shape[0], 0))

    if greedy:

        def decode_loop(params: Any, cache: dict, token: torch.Tensor, num_steps: int):
            return run(params, cache, token, num_steps)

        return decode_loop

    def sample_loop(params: Any, cache: dict, token: torch.Tensor, generator: torch.Generator,
                    temperature, num_steps: int):
        return run(params, cache, token, num_steps, generator, temperature)

    return sample_loop


def make_decode_chunk(cfg: ArchConfig) -> Callable:
    """The scheduler's decode unit.

    (params, cache, token (B, 1), generator, temperature, num_steps) ->
        (tokens (B, n) int32, logprobs (B, n) f32, cache)

    Each step draws its noise and samples; ``temperature <= 0`` selects the
    greedy argmax through a ``where``, as in ``repro``, so one chunk serves
    both modes. The log-probability is log_softmax(logits)[chosen] in f32.
    """
    model = Model(cfg)

    def decode_chunk(params: Any, cache: dict, token: torch.Tensor, generator: torch.Generator,
                     temperature, num_steps: int) -> tuple[torch.Tensor, torch.Tensor, dict]:
        t = torch.as_tensor(temperature, dtype=torch.float32, device=token.device)
        toks, lps = [], []
        for _ in range(num_steps):
            logits, cache = model.decode_step(params, cache, token)
            lg = logits[:, -1].float()
            sampled = sample_token(lg, gumbel(generator, lg.shape, lg.device), t.clamp(min=1e-6))
            nxt = torch.where(t > 0, sampled, _greedy(lg))
            lps.append(torch.log_softmax(lg, dim=-1).gather(1, nxt[:, None].long())[:, 0])
            toks.append(nxt)
            token = nxt[:, None]
        return torch.stack(toks, 1), torch.stack(lps, 1), cache

    return decode_chunk


@dataclass
class ServeEngine:
    """Batched generation over a static cache (greedy or sampled), on the
    card unless ``device`` says otherwise; ``params`` are moved there.
    ``kv_slots``: the cache's TP-expanded KV head count (0: the config's)."""

    cfg: ArchConfig
    params: Any
    max_len: int
    device: Any = "cuda"
    kv_slots: int = 0

    def __post_init__(self):
        self.device = torch.device(self.device)
        self.params = tree_map(lambda _, t: t.to(self.device), self.params)
        self._prefill = make_prefill_step(self.cfg, self.max_len, kv_slots=self.kv_slots)
        self._decode = make_decode_loop(self.cfg)
        self._decode_sampled = make_decode_loop(self.cfg, greedy=False)

    def generate(
        self,
        batch: dict,
        num_tokens: int,
        *,
        generator: Optional[torch.Generator] = None,
        temperature: float = 1.0,
    ) -> torch.Tensor:
        """batch: prompt dict ({"tokens": (B, S)}, and ``frontend`` features
        for a frontend config) -> (B, num_tokens) int32 ids.

        Greedy argmax by default; pass ``generator`` (on the engine's
        device) to sample at ``temperature`` > 0 instead, the prefill token
        too. ``num_tokens <= 0`` returns an empty (B, 0) tensor and does not
        emit the prefill token. Raises ``ValueError`` before the prefill
        when P + S + num_tokens − 1 positions do not fit the cache, P the
        patches a vision batch prepends (0 otherwise), where ``repro``'s
        clamped writes would corrupt it (``repro.launch.serve`` sizes its
        cache without the patches).
        """
        batch = {k: torch.as_tensor(t, device=self.device) for k, t in batch.items()}
        B, S = batch["tokens"].shape
        if num_tokens <= 0:
            return torch.zeros((B, 0), dtype=torch.int32, device=self.device)
        P = batch["frontend"].shape[1] if self.cfg.frontend == "vision" and "frontend" in batch else 0
        if P + S + num_tokens - 1 > self.max_len:
            raise ValueError(f"{P} patches, {S} prompt tokens and {num_tokens} new need "
                             f"{P + S + num_tokens - 1} cache slots; the cache holds {self.max_len}")
        if generator is not None and not temperature > 0:
            raise ValueError(f"sampling needs a temperature > 0, got {temperature}")
        logits, cache = self._prefill(self.params, batch)
        lg = logits[:, -1]
        if generator is None:
            tok = _greedy(lg)[:, None]
        else:
            temp = torch.tensor(temperature, dtype=torch.float32, device=self.device)
            tok = sample_token(lg, gumbel(generator, lg.shape, lg.device), temp)[:, None]
        if num_tokens == 1:  # the prefill token is free
            return tok
        if generator is None:
            rest = self._decode(self.params, cache, tok, num_tokens - 1)
        else:
            rest = self._decode_sampled(self.params, cache, tok, generator, temp, num_tokens - 1)
        return torch.cat([tok, rest], dim=1)
