"""yi-9b [dense] — llama-arch GQA kv=4. [arXiv:2403.04652; hf]

A copy of ``repro.configs.yi_9b``.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="yi-9b",
    family="dense",
    source="[arXiv:2403.04652; hf]",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=11008,
    vocab_size=64_000,
    rope_theta=10_000.0,
    pattern=(LayerSpec("attn", "dense"),),
)
