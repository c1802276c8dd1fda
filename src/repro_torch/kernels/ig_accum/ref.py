"""Plain PyTorch versions of the accumulation kernels (riemann and IDGI)."""
from __future__ import annotations

import torch


def ig_accum_ref(acc: torch.Tensor, grads: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """acc: (B, F) f32; grads: (B, K, F); weights: (B, K) -> (B, F) f32.

    out[b, f] = acc[b, f] + Σ_k weights[b, k] * grads[b, k, f]
    """
    return acc + torch.einsum("bkf,bk->bf", grads.float(), weights.float())


def idgi_dots_ref(grads: torch.Tensor, diff: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """grads (B, K, F); diff (B, F) -> (⟨g,g⟩ (B, K) f32, ⟨g,diff⟩ (B, K) f32)."""
    g = grads.float()
    return torch.einsum("bkf,bkf->bk", g, g), torch.einsum("bkf,bf->bk", g, diff.float())


def ig_accum_sq_ref(acc: torch.Tensor, grads: torch.Tensor, coeff: torch.Tensor) -> torch.Tensor:
    """acc (B, F) f32; grads (B, K, F); coeff (B, K) -> (B, F) f32.

    out[b, f] = acc[b, f] + Σ_k coeff[b, k] * grads[b, k, f]²
    """
    g = grads.float()
    return acc + torch.einsum("bkf,bk->bf", g * g, coeff.float())


def idgi_coeff(weights: torch.Tensor, s: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """c = w · ⟨g,diff⟩ / ⟨g,g⟩, exactly 0 where ⟨g,g⟩ = 0 (never NaN); the
    order of operations of ``repro.kernels.ig_accum.ops.ig_accum_idgi``."""
    pos = s > 0.0
    return weights.float() * p * torch.where(pos, 1.0 / torch.where(pos, s, torch.ones_like(s)),
                                             torch.zeros_like(s))


def ig_accum_idgi_ref(
    acc: torch.Tensor, grads: torch.Tensor, weights: torch.Tensor, diff: torch.Tensor
) -> torch.Tensor:
    """IDGI accumulation (``repro_torch.core.methods.idgi_accum``).

    acc: (B, F) f32; grads: (B, K, F); weights: (B, K); diff: (B, F).
    out[b, f] = acc[b, f] + Σ_k c[b, k] * grads[b, k, f]²
    with  c[b, k] = weights[b, k] · ⟨g_k, diff⟩ / ⟨g_k, g_k⟩  (0 where ⟨g,g⟩=0).
    """
    s, p = idgi_dots_ref(grads, diff)
    return ig_accum_sq_ref(acc, grads, idgi_coeff(weights, s, p))
