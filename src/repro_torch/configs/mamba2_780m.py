"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.

[arXiv:2405.21060; unverified]

A copy of ``repro.configs.mamba2_780m``.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    source="[arXiv:2405.21060; unverified]",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,  # mamba2 blocks have no separate FFN
    vocab_size=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,  # 48 SSD heads (d_inner=3072)
    ssm_groups=1,
    ssm_chunk=256,
    tie_embeddings=True,
    pattern=(LayerSpec("mamba", "none"),),
)
