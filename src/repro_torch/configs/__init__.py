"""Config registry of the port.

``ARCHS`` holds the architectures the port's LM can build: dense SwiGLU
FFNs, no frontend, not encoder-decoder, every mixer full attention or,
with a sliding window, local attention. Those are gemma3-27b (5 local
layers of a 1024-token window to 1 global), internlm2-20b, llama3-8b and
yi-9b, copies of ``repro``'s; ``get_config`` resolves a name among them.
"""
from repro_torch.configs import gemma3_27b, internlm2_20b, llama3_8b, yi_9b
from repro_torch.configs.base import ArchConfig, LayerSpec, reduced

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in (gemma3_27b.CONFIG, internlm2_20b.CONFIG, llama3_8b.CONFIG, yi_9b.CONFIG)
}


def get_config(name: str) -> ArchConfig:
    """``repro.configs.get_config`` over the port's ``ARCHS``."""
    if name in ARCHS:
        return ARCHS[name]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")


__all__ = ["ARCHS", "ArchConfig", "LayerSpec", "get_config", "reduced"]
