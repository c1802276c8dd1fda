"""gemma3-27b [dense] — 5:1 local:global attention, 128k context.

[hf:google/gemma-3-1b-pt; unverified]

A copy of ``repro.configs.gemma3_27b``.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

L, G = LayerSpec("local", "dense"), LayerSpec("attn", "dense")

CONFIG = ArchConfig(
    name="gemma3-27b",
    family="dense",
    source="[hf:google/gemma-3-1b-pt; unverified]",
    num_layers=62,  # 10 stacked periods of 6 + 2 remainder layers (L, L)
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262_144,
    rope_theta=1_000_000.0,
    # 5 local : 1 global; 62 layers = 10 periods + (L, L) remainder.
    pattern=(L, L, L, L, L, G),
    sliding_window=1024,
    tie_embeddings=True,
)
