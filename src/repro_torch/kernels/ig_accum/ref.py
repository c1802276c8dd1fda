"""Plain PyTorch version of the Riemann accumulation kernel."""
from __future__ import annotations

import torch


def ig_accum_ref(acc: torch.Tensor, grads: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """acc: (B, F) f32; grads: (B, K, F); weights: (B, K) -> (B, F) f32.

    out[b, f] = acc[b, f] + Σ_k weights[b, k] * grads[b, k, f]
    """
    return acc + torch.einsum("bkf,bk->bf", grads.float(), weights.float())
