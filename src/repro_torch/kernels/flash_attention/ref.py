"""Plain PyTorch versions of the flash attention kernels (GQA, causal, ragged).

Two groups, both in the kernels' layout: q (B, NQ, Sq, D), k/v (B, NKV, Sk,
D), query head h reading kv head h // G with G = NQ // NKV.

- ``attention_ref`` and ``attention_vjp_ref`` are ``repro.kernels.
  flash_attention.ref`` in PyTorch: the softmax forward and the explicit
  analytic backward (dP -> dS -> dQ/dK/dV with ``delta = rowsum(dO · O)``),
  masked scores floored at ``NEG_INF`` and fully masked rows zeroed.
- ``flash_fwd_ref``, ``flash_bwd_dq_ref`` and ``flash_bwd_dkv_ref`` take and
  return exactly what the three kernels do — the forward's f32 logsumexp
  residual, the backward's recomputed ``P = where(keep, exp(s − lse), 0)``
  and the outside ``delta`` — so each kernel is held against its own plain
  version, and CPU tensors run the op's autograd through them.

Everything is computed in f32 and cast back to the input dtype, as in the
kernels; scores are materialized, which is what the kernels avoid.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _keep(Sq: int, Sk: int, *, causal: bool, lengths: Optional[torch.Tensor],
          device) -> torch.Tensor:
    """(B or 1, 1, 1, Sq, Sk) bool: causal and ragged-length mask."""
    kpos = torch.arange(Sk, device=device)
    keep = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        keep = keep & (torch.arange(Sq, device=device)[:, None] >= kpos[None, :])
    keep = keep[None, None, None]
    if lengths is not None:
        valid = kpos[None, :] < lengths.reshape(-1, 1).to(device)  # (B, Sk)
        keep = keep & valid[:, None, None, None, :]
    return keep


def _grouped(x: torch.Tensor, nkv: int) -> torch.Tensor:
    """(B, NQ, S, D) -> (B, NKV, G, S, D) f32."""
    B, NQ, S, D = x.shape
    return x.float().reshape(B, nkv, NQ // nkv, S, D)


def _masked_probs(q, k, *, causal, lengths):
    """(B, NKV, G, Sq, Sk) f32 softmax probabilities, fully masked rows 0."""
    D, NKV = q.shape[-1], k.shape[1]
    s = torch.einsum("bhgqd,bhkd->bhgqk", _grouped(q, NKV) * (D**-0.5), k.float())
    keep = _keep(q.shape[2], k.shape[2], causal=causal, lengths=lengths, device=q.device)
    p = torch.softmax(torch.where(keep, s, NEG_INF), dim=-1)
    # a row with no valid key softmaxes to uniform garbage: zero it, as the
    # kernels' l = 0 -> o = 0 convention does
    return torch.where(keep.any(-1, keepdim=True), p, 0.0)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                  lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Softmax attention (B, NQ, Sq, D) in q.dtype; ``lengths`` (B,) or (B, 1)
    valid key counts."""
    B, NQ, Sq, D = q.shape
    p = _masked_probs(q, k, causal=causal, lengths=lengths)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, NQ, Sq, D).to(q.dtype)


def attention_vjp_ref(q, k, v, do, *, causal: bool = True,
                      lengths: Optional[torch.Tensor] = None):
    """Explicit (dq, dk, dv) of ``attention_ref`` for the cotangent ``do``.

    With P = softmax(scale · Q Kᵀ + mask) and O = P V:
        dV = Pᵀ dO,  dP = dO Vᵀ,  dS = P ∘ (dP − delta),  delta = rowsum(dO ∘ O)
        dQ = scale · dS K,  dK = scale · dSᵀ Q  (summed over the GQA group)
    """
    B, NQ, Sq, D = q.shape
    NKV = k.shape[1]
    scale = D**-0.5
    p = _masked_probs(q, k, causal=causal, lengths=lengths)
    vf, dog = v.float(), _grouped(do, NKV)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, vf)
    delta = (dog * o).sum(-1)
    ds = p * (dp - delta[..., None])
    dq = scale * torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float())
    dk = scale * torch.einsum("bhgqk,bhgqd->bhkd", ds, _grouped(q, NKV))
    return dq.reshape(B, NQ, Sq, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------ the kernels' own contracts


def flash_fwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kvlen: torch.Tensor, *,
                  causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel: ``(o, lse)``, o (B, NQ, Sq, D) in q.dtype and lse
    (B, NQ, Sq) f32 = m + log(max(l, 1e-30)); kvlen (B,) or (B, 1) int."""
    B, NQ, Sq, D = q.shape
    NKV = k.shape[1]
    s = torch.einsum("bhgqd,bhkd->bhgqk", _grouped(q, NKV) * (D**-0.5), k.float())
    keep = _keep(Sq, k.shape[2], causal=causal, lengths=kvlen, device=q.device)
    m = torch.where(keep, s, NEG_INF).amax(-1)  # NEG_INF on a row with no valid key
    p = torch.where(keep, torch.exp(s - m[..., None]), 0.0)
    lc = p.sum(-1).clamp_min(1e-30)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float()) / lc[..., None]
    return o.reshape(B, NQ, Sq, D).to(q.dtype), (m + torch.log(lc)).reshape(B, NQ, Sq)


def _bwd_ds(q, k, v, do, lse, delta, kvlen, causal):
    """(P, dS) of the backward kernels, (B, NKV, G, Sq, Sk) f32."""
    B, NQ, Sq, D = q.shape
    NKV = k.shape[1]
    s = torch.einsum("bhgqd,bhkd->bhgqk", _grouped(q, NKV), k.float()) * (D**-0.5)
    keep = _keep(Sq, k.shape[2], causal=causal, lengths=kvlen, device=q.device)
    lse = lse.float().reshape(B, NKV, NQ // NKV, Sq, 1)
    p = torch.where(keep, torch.exp(s - lse), 0.0)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", _grouped(do, NKV), v.float())
    ds = p * (dp - delta.float().reshape(B, NKV, NQ // NKV, Sq, 1))
    return p, ds


def flash_bwd_dq_ref(q, k, v, do, lse, delta, kvlen, *, causal: bool) -> torch.Tensor:
    """The dQ kernel: scale · Σ_k dS K, (B, NQ, Sq, D) in q.dtype."""
    _, ds = _bwd_ds(q, k, v, do, lse, delta, kvlen, causal)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float()) * (q.shape[-1] ** -0.5)
    return dq.reshape(q.shape).to(q.dtype)


def flash_bwd_dkv_ref(q, k, v, do, lse, delta, kvlen, *,
                      causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The dK/dV kernel: (scale · Σ dSᵀ Q, Σ Pᵀ dO) over the GQA group and
    every query row, each (B, NKV, Sk, D) in k's/v's dtype."""
    NKV = k.shape[1]
    p, ds = _bwd_ds(q, k, v, do, lse, delta, kvlen, causal)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, _grouped(q, NKV)) * (q.shape[-1] ** -0.5)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, _grouped(do, NKV))
    return dk.to(k.dtype), dv.to(v.dtype)
