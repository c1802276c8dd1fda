"""qwen3-moe-235b-a22b [moe] — 128 experts top-8. [hf:Qwen/Qwen3-30B-A3B; hf]

A copy of ``repro.configs.qwen3_moe_235b_a22b``.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    source="[hf:Qwen/Qwen3-30B-A3B; hf]",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,  # per-expert hidden dim
    moe_d_ff=1536,
    vocab_size=151_936,
    rope_theta=1_000_000.0,
    num_experts=128,
    experts_per_tok=8,
    pattern=(LayerSpec("attn", "moe"),),
)
