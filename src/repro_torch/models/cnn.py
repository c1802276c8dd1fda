"""Inception-style small convnet — the paper's vision reproduction model.

Same model as ``repro.models.cnn``: conv stem -> mixed blocks with parallel
1x1/3x3/5x5/pool towers -> GAP head. Public functions take NHWC images, as
``repro`` does; the convolutions run in NCHW inside ``forward``.

Parameters are a nested dict of tensors (``{"stem": {"w", "b"},
"block{i}": {"t1", "t3a", "t3b", "t5a", "t5b", "tp"}, "head": {"w", "b"}}``)
with conv weights in PyTorch's OIHW layout and the head ``w`` as
(cin, classes) for ``x @ w``. ``params_from_numpy`` converts ``repro``'s
HWIO tree; ``init_params`` draws fresh weights with the same fan-in rule.

Padding matches XLA's "SAME": out = ceil(n / stride), with the odd pixel of
padding after, not before (the stride-2 stem and pools pad 0 before and 1
after on even sizes); pools pad with −inf. ``F.pad`` makes that explicit,
since ``padding="same"`` refuses stride 2 and ``padding=1`` shifts the
window.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.paper_cnn import CnnConfig


def param_shapes(cfg: CnnConfig) -> dict:
    """Nested dict of parameter shapes in the port's layouts (OIHW convs)."""
    conv = lambda cin, cout, k: (cout, cin, k, k)
    shapes: dict[str, Any] = {
        "stem": {"w": conv(cfg.channels, cfg.stem_features, 3), "b": (cfg.stem_features,)}
    }
    cin = cfg.stem_features
    for i, (f1, f3, f5, fp) in enumerate(cfg.blocks):
        shapes[f"block{i}"] = {
            "t1": conv(cin, f1, 1),
            "t3a": conv(cin, f3 // 2, 1),
            "t3b": conv(f3 // 2, f3, 3),
            "t5a": conv(cin, f5 // 2, 1),
            "t5b": conv(f5 // 2, f5, 5),
            "tp": conv(cin, fp, 1),
        }
        cin = f1 + f3 + f5 + fp
    shapes["head"] = {"w": (cin, cfg.num_classes), "b": (cfg.num_classes,)}
    return shapes


def init_params(cfg: CnnConfig, generator: torch.Generator, device="cuda") -> dict:
    """Fresh weights: normal with std 1/√fan_in (fan_in = cin·k·k for convs,
    cin for the head), zero biases — ``repro.models.common``'s rule, drawn
    from ``generator`` (so the numbers differ from ``repro``'s)."""

    def draw(name: str, shape: tuple) -> torch.Tensor:
        if name == "b":
            return torch.zeros(shape, device=device)
        fan_in = shape[0] if len(shape) == 2 else math.prod(shape[1:])
        w = torch.randn(shape, generator=generator, device=generator.device)
        return (w / math.sqrt(fan_in)).to(device)

    return {
        layer: {name: draw(name, shape) for name, shape in group.items()}
        for layer, group in param_shapes(cfg).items()
    }


def params_from_numpy(tree: dict, device="cuda") -> dict:
    """``repro.models.cnn`` parameters (nested dict of arrays, conv weights
    HWIO) -> the port's (conv weights OIHW), as f32 tensors on ``device``."""

    def conv(a) -> torch.Tensor:
        a = np.array(a, np.float32)  # a writable copy
        if a.ndim == 4:
            a = np.ascontiguousarray(a.transpose(3, 2, 0, 1))
        return torch.from_numpy(a).to(device)

    return {layer: {name: conv(a) for name, a in group.items()} for layer, group in tree.items()}


def _same_pad(x: torch.Tensor, k: int, stride: int, value: float = 0.0) -> torch.Tensor:
    """Pad NCHW ``x`` as XLA's "SAME" does for a k×k window at ``stride``."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad takes the last dim first
        total = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value)


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    return F.conv2d(_same_pad(x, w.shape[-1], stride), w, stride=stride)


def _pool(x: torch.Tensor, k: int = 3, stride: int = 1) -> torch.Tensor:
    return F.max_pool2d(_same_pad(x, k, stride, -math.inf), k, stride)


def forward(cfg: CnnConfig, params: Any, images: torch.Tensor) -> torch.Tensor:
    """images: (B, H, W, C) -> logits (B, num_classes)."""
    x = images.permute(0, 3, 1, 2)
    x = F.relu(_conv(x, params["stem"]["w"], 2) + params["stem"]["b"][:, None, None])
    for i in range(len(cfg.blocks)):
        p = params[f"block{i}"]
        t1 = F.relu(_conv(x, p["t1"]))
        t3 = F.relu(_conv(F.relu(_conv(x, p["t3a"])), p["t3b"]))
        t5 = F.relu(_conv(F.relu(_conv(x, p["t5a"])), p["t5b"]))
        tp = F.relu(_conv(_pool(x), p["tp"]))
        x = _pool(torch.cat([t1, t3, t5, tp], dim=1), 3, 2)
    x = x.mean(dim=(2, 3))  # GAP
    return x @ params["head"]["w"] + params["head"]["b"]


def prob_fn(cfg: CnnConfig, params: Any, images: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Target-class probability — the paper's IG output function f."""
    p = torch.softmax(forward(cfg, params, images), dim=-1)
    return torch.gather(p, 1, target[:, None].long())[:, 0]


class PaperCNN(nn.Module):
    """``forward``/``prob_fn`` as an ``nn.Module`` over a parameter dict
    (frozen: explanations differentiate w.r.t. the input only)."""

    def __init__(self, cfg: CnnConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.params = nn.ModuleDict({
            layer: nn.ParameterDict(
                {name: nn.Parameter(t, requires_grad=False) for name, t in group.items()}
            )
            for layer, group in params.items()
        })

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return forward(self.cfg, self.params, images)

    def prob(self, images: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        return prob_fn(self.cfg, self.params, images, target)
