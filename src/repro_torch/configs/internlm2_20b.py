"""internlm2-20b [dense] — GQA kv=8. [arXiv:2403.17297; hf]

A copy of ``repro.configs.internlm2_20b``.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="internlm2-20b",
    family="dense",
    source="[arXiv:2403.17297; hf]",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92_544,
    rope_theta=1_000_000.0,
    pattern=(LayerSpec("attn", "dense"),),
)
