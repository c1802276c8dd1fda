"""Config registry of the port.

``ARCHS`` holds the architectures the port's LM can build, copies of
``repro``'s: the dense llama-style LMs (internlm2-20b, llama3-8b, yi-9b),
gemma3-27b (5 local layers of a 1024-token window to 1 global), the MoE
LMs qwen3-moe-30b-a3b and qwen3-moe-235b-a22b (128 experts, top-8),
mamba2-780m (attention-free Mamba-2 SSD) and jamba-v0.1-52b (Mamba,
attention and MoE interleaved). ``repro``'s whisper-tiny (an encoder and
an audio frontend) and internvl2-26b (a vision frontend) are not ported;
``get_config`` resolves a name among the eight.
"""
from repro_torch.configs import (
    gemma3_27b,
    internlm2_20b,
    jamba_v01_52b,
    llama3_8b,
    mamba2_780m,
    qwen3_moe_30b_a3b,
    qwen3_moe_235b_a22b,
    yi_9b,
)
from repro_torch.configs.base import ArchConfig, LayerSpec, reduced

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in (
        gemma3_27b.CONFIG,
        internlm2_20b.CONFIG,
        llama3_8b.CONFIG,
        yi_9b.CONFIG,
        qwen3_moe_30b_a3b.CONFIG,
        qwen3_moe_235b_a22b.CONFIG,
        mamba2_780m.CONFIG,
        jamba_v01_52b.CONFIG,
    )
}


def get_config(name: str) -> ArchConfig:
    """``repro.configs.get_config`` over the port's ``ARCHS``."""
    if name in ARCHS:
        return ARCHS[name]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")


__all__ = ["ARCHS", "ArchConfig", "LayerSpec", "get_config", "reduced"]
