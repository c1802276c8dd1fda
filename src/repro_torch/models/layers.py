"""Core layers of ``repro.models.layers``: RMSNorm, RoPE, the SwiGLU MLP,
the token embeddings, the stub frontend's projection and the chunked
softmax cross-entropy of the training loss.

Parameters keep ``repro``'s layouts (``mlp`` weights (d, f) and (f, d) for
``x @ w``, ``embedding`` (V, d), ``unembed`` (d, V), ``frontend_proj``
(frontend_dim, d)). As in ``repro``, the MLP hidden and the loss's logits
stay on the tensor-parallel axis (``sharding.context.constrain``, which the
dry run's sharded cells act on and which leaves a plain tensor as it is).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import ParamDef
from repro_torch.sharding.context import constrain, gathered


def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis with f32 statistics, cast back to x.dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (y * p["scale"].float()).to(x.dtype)


def rmsnorm_def(d: int) -> dict:
    return {"scale": ParamDef((d,), "ones", axes=(None,))}


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding, halves rotated (``repro``'s layout). x: (..., S, H,
    D); positions: (..., S). Angles in f32; the rotation is taken in f32
    and cast back to x.dtype, as ``repro``'s type promotion does."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = (positions.float()[..., :, None] * freq)[..., :, None, :]  # over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def mlp_def(d: int, f: int) -> dict:
    return {"wi_gate": ParamDef((d, f), axes=("embed", "mlp")), "wi_up": ParamDef((d, f), axes=("embed", "mlp")),
            "wo": ParamDef((f, d), axes=("mlp", "embed"))}


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x W_gate) ∘ x W_up) W_o."""
    dt = x.dtype
    h = F.silu(x @ p["wi_gate"].to(dt)) * (x @ p["wi_up"].to(dt))
    h = constrain(h, "batch", "seq", "model")  # keep hidden TP-sharded
    return constrain(h @ p["wo"].to(dt), "batch", "seq", None)  # the partial sums over the hidden, reduced


def embed_def(cfg) -> dict:
    """The token embedding (V, d), unit normal, unless tied the unembedding
    (d, V), and with a stub frontend its projection (frontend_dim, d), both
    at fan-in scale."""
    d = {"embedding": ParamDef((cfg.vocab_size, cfg.d_model), "embed", axes=("vocab", "embed"))}
    if not cfg.tie_embeddings:
        d["unembed"] = ParamDef((cfg.d_model, cfg.vocab_size), axes=("embed", "vocab"))
    if cfg.frontend:
        d["frontend_proj"] = ParamDef((cfg.frontend_dim or cfg.d_model, cfg.d_model), axes=("frontend", "embed"))
    return d


def embed(p: dict, tokens: torch.Tensor, cfg, dtype: torch.dtype) -> torch.Tensor:
    """Token ids (…) -> embeddings (…, d) in ``dtype``; gemma scales by √d."""
    e = p["embedding"][tokens.long()].to(dtype)
    if cfg.name.startswith("gemma"):
        e = e * torch.tensor(cfg.d_model**0.5, dtype=dtype)
    return e


def project_frontend(p: dict, feats: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Stub frontend features (…, frontend_dim) — audio frames or vision
    patches — -> embeddings (…, d) in ``dtype``."""
    return feats.to(dtype) @ gathered(p["frontend_proj"]).to(dtype)


def unembed(p: dict, h: torch.Tensor, cfg) -> torch.Tensor:
    """(…, d) -> (…, V) logits in h.dtype, through the tied embedding or
    the unembedding."""
    if cfg.tie_embeddings:
        return h @ gathered(p["embedding"]).to(h.dtype).T
    return h @ gathered(p["unembed"]).to(h.dtype)


def softmax_xent_chunked(p_embed: dict, h: torch.Tensor, labels: torch.Tensor, cfg,
                         chunk: int = 512) -> torch.Tensor:
    """Mean next-token cross-entropy of hidden states h (B, S, d) against
    ``labels`` (B, S) without the whole (B, S, V) logits: chunks of
    ``chunk`` positions, then the remainder, as in ``repro``, each chunk's
    f32 logits recomputed in the backward (``torch.utils.checkpoint``), so
    none outlives its chunk. Returns the f32 () mean over B·S. A chunk's
    sum is ``F.cross_entropy``'s (``repro``'s logsumexp less the gold logit,
    within rounding), which DTensor computes vocab-parallel under
    ``loss_parallel`` (the dry run's sharded cells)."""
    B, S, _ = h.shape
    chunk = min(chunk, S)
    n = S // chunk

    def part(hc: torch.Tensor, lc: torch.Tensor) -> torch.Tensor:
        logits = unembed(p_embed, hc, cfg).float()  # (B, c, V)
        logits = constrain(logits, "batch", None, "model")  # vocab stays TP
        return F.cross_entropy(logits.flatten(0, 1), lc.flatten().long(), reduction="sum")

    bounds = [(i * chunk, (i + 1) * chunk) for i in range(n)] + ([(n * chunk, S)] if S % chunk else [])
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for a, b in bounds:
        total = total + checkpoint(part, h[:, a:b], labels[:, a:b], use_reentrant=False)
    return total / (B * S)
