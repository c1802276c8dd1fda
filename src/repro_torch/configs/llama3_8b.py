"""llama3-8b [dense] — GQA kv=8, 128k vocab. [arXiv:2407.21783; unverified]

A copy of ``repro.configs.llama3_8b``.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="llama3-8b",
    family="dense",
    source="[arXiv:2407.21783; unverified]",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128_256,
    rope_theta=500_000.0,
    pattern=(LayerSpec("attn", "dense"),),
)
