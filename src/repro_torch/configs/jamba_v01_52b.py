"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887; hf] — attention at position 4 of each 8-layer period;
MoE replaces the dense FFN on every second (odd) layer.

A copy of ``repro.configs.jamba_v01_52b``.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

M_D = LayerSpec("mamba", "dense")
M_E = LayerSpec("mamba", "moe")

CONFIG = ArchConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    source="[arXiv:2403.19887; hf]",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    moe_d_ff=14336,
    vocab_size=65_536,
    num_experts=16,
    experts_per_tok=2,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_groups=1,
    ssm_chunk=256,
    # 8-layer period, 1:7 attn:mamba, MoE every 2nd layer:
    pattern=(M_D, M_E, M_D, M_E, LayerSpec("attn", "dense"), M_E, M_D, M_E),
)
