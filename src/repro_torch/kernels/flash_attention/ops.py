"""Flash attention op: model layout, ragged lengths, kernel backward.

``flash_attention`` is ``repro.kernels.flash_attention.ops.flash_attention``
in PyTorch: (B, S, H, D) model layout in and out, optional per-row valid key
``lengths`` (clamped to Sk), and a ``torch.autograd.Function`` whose
backward recomputes the probability tile from the (B, NQ, Sq) f32
logsumexp, so differentiating through attention never materializes the
(B, H, S, S) scores on the card:

  forward   ``flash_fwd`` kernel → (o, lse);
  backward  ``delta = rowsum(dO · O)`` in f32 outside the kernels, then the
            ``flash_bwd_dq`` kernel and the ``flash_bwd_dkv`` kernel.
            Lengths get no gradient.

Saved for the backward: q, k, v, o, lse, kvlen. CPU tensors take the plain
versions in ``ref.py``, CUDA tensors the kernels. The JAX wrapper pads the
sequences to a block multiple and slices the output; the CUDA kernels mask
the ragged tiles instead, which gives the same values and gradients (padded
query rows contributed nothing there, and there are none here).
``block_q``/``block_k`` are accepted for the config's sake and not used: they
are TPU tile sizes, and the CUDA kernels choose their own.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import common
from repro_torch.kernels.flash_attention.kernel import (
    flash_bwd_dkv_cuda,
    flash_bwd_dq_cuda,
    flash_fwd_cuda,
)
from repro_torch.kernels.flash_attention.ref import (
    attention_ref,
    attention_vjp_ref,
    flash_bwd_dkv_ref,
    flash_bwd_dq_ref,
    flash_fwd_ref,
)


class FlashAttention(torch.autograd.Function):
    """Kernel layout: q (B, NQ, Sq, D), k/v (B, NKV, Sk, D), kvlen (B,) int32."""

    @staticmethod
    def forward(ctx, q, k, v, kvlen, causal):
        fwd = flash_fwd_cuda if common.on_cuda(q, k, v, kvlen) else flash_fwd_ref
        o, lse = fwd(q, k, v, kvlen, causal=causal)
        ctx.save_for_backward(q, k, v, o, lse, kvlen)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, kvlen = ctx.saved_tensors
        # the softmax Jacobian's diagonal term, shared by both kernels
        delta = (do.float() * o.float()).sum(-1)
        cuda = common.on_cuda(q, do)
        dq_fn, dkv_fn = ((flash_bwd_dq_cuda, flash_bwd_dkv_cuda) if cuda
                         else (flash_bwd_dq_ref, flash_bwd_dkv_ref))
        dq = dq_fn(q, k, v, do, lse, delta, kvlen, causal=ctx.causal)
        dk, dv = dkv_fn(q, k, v, do, lse, delta, kvlen, causal=ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,  # (B, Sq, NQ, D) — model layout
    k: torch.Tensor,  # (B, Sk, NKV, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    lengths: Optional[torch.Tensor] = None,  # (B,) or (B, 1) valid K lengths
    block_q: int = 128,
    block_k: int = 128,
) -> torch.Tensor:
    """Differentiable flash attention in model layout, (B, Sq, NQ, D) out."""
    B, Sk = q.shape[0], k.shape[1]
    if lengths is None:
        kvlen = torch.full((B,), Sk, dtype=torch.int32, device=q.device)
    else:
        kvlen = lengths.reshape(B).to(device=q.device, dtype=torch.int32).clamp(max=Sk)
    o = FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), kvlen,
                             causal)
    return o.transpose(1, 2)


__all__ = ["FlashAttention", "flash_attention", "attention_ref", "attention_vjp_ref"]
