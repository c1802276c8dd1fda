"""ViT encoder — patch-level attributions on the attention hot path.

The model of ``repro.models.vit``: a pre-norm transformer over patch
embeddings (linear patch projection + learned position embedding, no CLS
token, masked mean-pool head), built from the LM's blocks (rmsnorm, GQA
qkv, SwiGLU mlp), so ``dispatch_attention`` — and with ``attn_impl="flash"``
the CUDA flash kernels — serve it. Public functions take NHWC images.

Parameters are a nested dict of tensors in ``repro``'s layout and names:
``patch_proj`` (patch_dim, d), ``patch_bias``, ``pos_embed`` (num_patches,
d), ``layers`` with every per-layer tensor stacked on a leading axis of
``num_layers`` (``norm1``/``norm2`` ``scale``, ``mixer`` ``wq`` (L, d, H, hd)
… ``wo`` (L, H, hd, d), ``ffn`` ``wi_gate``/``wi_up``/``wo``),
``final_norm`` and ``head`` (``w`` (d, classes), ``b``). ``params_from_numpy``
(``models.common``) converts ``repro``'s ``vit.init`` tree as it is;
``init_params`` draws fresh weights on the card's machine with ``repro``'s
fan-in rule.

IG path note: the patch projection is affine, so a straight line in pixel
space maps to a straight line in embedding space.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from repro_torch.configs.base import LayerSpec
from repro_torch.configs.vit import VitConfig
from repro_torch.models import attention as attn, blocks
# fan_in and params_from_numpy are re-exported: the shared init rule and weight bridge
from repro_torch.models.common import ParamDef, fan_in, params_from_numpy, stack_defs  # noqa: F401
from repro_torch.models.common import tree_map as _map
from repro_torch.models.common import init_params as init_tree
from repro_torch.models.layers import mlp, rmsnorm, rmsnorm_def


def param_specs(cfg: VitConfig) -> dict:
    """``repro.models.vit.param_defs``: shapes, stacked layers included
    (the LM's ``(attn, dense)`` layer)."""
    d = cfg.d_model
    return {
        "patch_proj": ParamDef((cfg.patch_dim, d), axes=("frontend", "embed")),
        "patch_bias": ParamDef((d,), "zeros", axes=(None,)),
        "pos_embed": ParamDef((cfg.num_patches, d), scale=0.02, axes=(None, "embed")),
        "layers": stack_defs(blocks.layer_def(cfg, LayerSpec()), cfg.num_layers),
        "final_norm": rmsnorm_def(d),
        "head": {"w": ParamDef((d, cfg.num_classes), axes=("embed", None)),
                 "b": ParamDef((cfg.num_classes,), "zeros", axes=(None,))},
    }


def init_params(cfg: VitConfig, generator: torch.Generator, device="cuda") -> dict:
    """Fresh weights with ``repro.models.common``'s rule
    (``models.common.init_params``), drawn from ``generator`` in the tree's
    order (so the numbers differ from ``repro``'s)."""
    return init_tree(param_specs(cfg), generator, dtype=getattr(torch, cfg.param_dtype),
                     device=device)


# ---------------------------------------------------------------- embedding


def patchify(cfg: VitConfig, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, num_patches, patch_dim) row-major patch features."""
    B, H, W, C = images.shape
    p = cfg.patch_size
    x = images.reshape(B, H // p, p, W // p, p, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, (H // p) * (W // p), p * p * C)


NO_TOKEN_EMBEDDING = ("VitModel has no token embedding: ExplainRequests for a ViT must "
                      "carry features=patchify(cfg, image) (see models/vit.patchify)")


def embed_features(cfg: VitConfig, params: Any, feats: torch.Tensor) -> torch.Tensor:
    """Patch features -> backbone embeddings (the IG interpolation space)."""
    dt = getattr(torch, cfg.compute_dtype)
    e = feats.to(dt) @ params["patch_proj"].to(dt) + params["patch_bias"].to(dt)
    S, pe = e.shape[1], params["pos_embed"].to(dt)
    if S <= pe.shape[0]:
        pe = pe[:S]
    else:  # bucket padded past the patch grid: padded slots carry no posemb
        pe = torch.cat([pe, pe.new_zeros((S - pe.shape[0], pe.shape[1]))])
    return e + pe[None]


# ------------------------------------------------------------------ backbone


def encode(cfg: VitConfig, params: Any, e: torch.Tensor, *,
           lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, S, d) embeddings -> (B, S, d) final-normed hidden states;
    ``lengths`` (B,) valid patch counts mask the keys past them."""
    dt = e.dtype
    x = e
    for i in range(cfg.num_layers):
        lp = _map(lambda _, t: t[i], params["layers"])
        h = rmsnorm(lp["norm1"], x, cfg.norm_eps)
        q, k, v = attn.qkv(lp["mixer"], h, dt)
        o = attn.dispatch_attention(cfg, q, k, v, mixer="attn", causal=False, kv_len=lengths)
        x = x + attn.out_proj(lp["mixer"], o, dt)
        x = x + mlp(lp["ffn"], rmsnorm(lp["norm2"], x, cfg.norm_eps))
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


def pool_logits(cfg: VitConfig, params: Any, h: torch.Tensor, *,
                lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked mean-pool over valid patches -> (B, num_classes) logits."""
    if lengths is None:
        pooled = h.mean(1)
    else:
        m = (torch.arange(h.shape[1], device=h.device)[None, :]
             < lengths.reshape(-1, 1)).to(h.dtype)
        pooled = (h * m[..., None]).sum(1) / m.sum(1, keepdim=True).clamp_min(1.0)
    dt = h.dtype
    return pooled @ params["head"]["w"].to(dt) + params["head"]["b"].to(dt)


def forward(cfg: VitConfig, params: Any, images: torch.Tensor) -> torch.Tensor:
    """images: (B, H, W, C) -> logits (B, num_classes)."""
    e = embed_features(cfg, params, patchify(cfg, images))
    return pool_logits(cfg, params, encode(cfg, params, e))


def prob_fn(cfg: VitConfig, params: Any, images: torch.Tensor,
            target: torch.Tensor) -> torch.Tensor:
    """Target-class probability — the paper's IG output function f."""
    p = torch.softmax(forward(cfg, params, images), dim=-1)
    return torch.gather(p, 1, target[:, None].long())[:, 0]


def target_logprob_at_fn(cfg: VitConfig, params: Any):
    """f(embeds, aux) -> (B,) target-class log-prob; aux["pos"] is the last
    valid patch index, so lengths = pos + 1 masks bucket padding."""

    def f(e: torch.Tensor, aux: dict) -> torch.Tensor:
        lengths = aux["pos"] + 1
        h = encode(cfg, params, e, lengths=lengths)
        lg = pool_logits(cfg, params, h, lengths=lengths).float()
        rows = torch.arange(e.shape[0], device=e.device)
        return torch.log_softmax(lg, dim=-1)[rows, aux["target"].long()]

    return f


# ------------------------------------------------------------------- module


class VitModel(nn.Module):
    """The functions above as an ``nn.Module`` over a parameter tree (frozen:
    explanations differentiate w.r.t. the input only). The stacked
    per-layer tensors stay stacked, in ``repro``'s layout."""

    def __init__(self, cfg: VitConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self._paths = []

        def register(path, t):
            self._paths.append(path)
            self.register_parameter("__".join(path), nn.Parameter(t, requires_grad=False))

        _map(register, params)

    def tree(self) -> dict:
        """The parameter tree, as the functions take it."""
        tree: dict = {}
        for path in self._paths:
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = getattr(self, "__".join(path))
        return tree

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return forward(self.cfg, self.tree(), images)

    def prob(self, images: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return prob_fn(self.cfg, self.tree(), images, target)

    def embed_inputs(self, batch: dict) -> torch.Tensor:
        """Refused, as ``repro``'s: a ViT embeds patch features, not tokens."""
        raise TypeError(NO_TOKEN_EMBEDDING)

    def embed_features(self, feats: torch.Tensor) -> torch.Tensor:
        return embed_features(self.cfg, self.tree(), feats)

    def target_logprob_at_fn(self):
        """``target_logprob_at_fn`` over this module's parameters."""
        return target_logprob_at_fn(self.cfg, self.tree())
