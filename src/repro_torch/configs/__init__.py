"""Config registry of the port.

``ARCHS`` holds the architectures the port's LM can build: full attention,
dense SwiGLU FFN, no frontend, not encoder-decoder. Today that is
llama3-8b; ``repro``'s other nine wait on the modules ``ROADMAP.md`` queues
(local attention, MoE, SSM, frontends, the encoder).
"""
from repro_torch.configs import llama3_8b
from repro_torch.configs.base import ArchConfig, LayerSpec, reduced

ARCHS: dict[str, ArchConfig] = {c.name: c for c in (llama3_8b.CONFIG,)}

__all__ = ["ARCHS", "ArchConfig", "LayerSpec", "reduced"]
