"""GQA attention of ``repro.models.attention``: projections, full, dispatch.

Layouts: q (B, S, NQ, D), k/v (B, S, NKV, D), grouped as NQ = NKV · G;
projection weights as in ``repro`` (``wq`` (d, NQ, D), ``wo`` (NQ, D, d)).

``dispatch_attention`` sends ``attn_impl="flash"`` to the port's flash op
(the CUDA kernels on the card, their plain versions on the CPU) and every
other full-attention call to ``full_attention``, which ``repro`` computes
outside any Pallas kernel and so is plain PyTorch here; ``kv_len`` reaches
the flash op as its ``lengths``. Not ported yet: ``blocked_attention``
(the same function as ``full_attention`` without the (S, S) scores, which
``repro`` takes above 4096 tokens unmasked; the engine's buckets end at
1024), ``local_attention`` and ``decode_attention`` (sliding windows and
the decode cache), and the costing-mode branch, which has no PyTorch
meaning.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.common import ParamDef

NEG_INF = -1e30


def attn_def(cfg) -> dict:
    """``repro``'s ``attn_def``: the projections at fan-in scale (``wq``'s
    fan-in is d·H, ``repro``'s rule)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": ParamDef((d, cfg.num_heads, hd)),
        "wk": ParamDef((d, cfg.num_kv_heads, hd)),
        "wv": ParamDef((d, cfg.num_kv_heads, hd)),
        "wo": ParamDef((cfg.num_heads, hd, d)),
    }


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) · (d, H, D) -> (B, S, H, D), one matrix product."""
    d, H, D = w.shape
    return (x @ w.reshape(d, H * D)).unflatten(-1, (H, D))


def qkv(p: dict, x: torch.Tensor, dtype) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (B, S, NQ, D), k and v (B, S, NKV, D) in ``dtype``."""
    return tuple(_project(x, p[n].to(dtype)) for n in ("wq", "wk", "wv"))


def out_proj(p: dict, o: torch.Tensor, dtype) -> torch.Tensor:
    """(B, S, NQ, D) -> (B, S, d)."""
    H, D, d = p["wo"].shape
    return o.flatten(-2) @ p["wo"].to(dtype).reshape(H * D, d)


def expand_kv(k: torch.Tensor, target_heads: int) -> torch.Tensor:
    """Repeat KV heads (B, S, NKV, D) up to ``target_heads``, each kv head
    h // G serving query heads h."""
    if k.shape[2] >= target_heads:
        return k
    return torch.repeat_interleave(k, target_heads // k.shape[2], dim=2)


def full_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    kv_len: Optional[torch.Tensor] = None,  # (B,) valid K lengths (ragged batch)
) -> torch.Tensor:
    """Reference attention; materializes the (Sq, Sk) scores in f32 and
    softmaxes them, probabilities cast to q.dtype. Rows with no valid key
    softmax over the NEG_INF floor (uniform), as in ``repro``."""
    Sq, NQ, D = q.shape[1], q.shape[2], q.shape[3]
    Sk = k.shape[1]
    ke, ve = expand_kv(k, NQ), expand_kv(v, NQ)
    s = torch.einsum("bqhd,bkhd->bhqk", q * (D**-0.5), ke).float()
    qpos = torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    mask = mask[None, None]
    if kv_len is not None:  # per-row ragged mask: (B, 1, Sq, Sk)
        mask = mask & (kpos[None, :] < kv_len.reshape(-1, 1))[:, None, None, :]
    a = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", a, ve)


def dispatch_attention(
    cfg,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mixer: str,
    causal: bool,
    kv_len: Optional[torch.Tensor] = None,  # (B,) ragged valid K lengths
) -> torch.Tensor:
    """The attention algorithm for a layer: the flash op when
    ``cfg.attn_impl == "flash"``, else ``full_attention``."""
    if mixer == "local" and getattr(cfg, "sliding_window", 0):
        raise NotImplementedError("local (sliding-window) attention is not ported yet")
    if getattr(cfg, "attn_impl", "auto") == "flash":
        return flash_attention(q, k, v, causal=causal, lengths=kv_len,
                               block_q=cfg.attn_block_q, block_k=cfg.attn_block_k)
    return full_attention(q, k, v, causal=causal, kv_len=kv_len)
