"""internvl2-26b [vlm] — InternViT (STUB frontend) + InternLM2-20B backbone.

[arXiv:2404.16821; hf] — the frontend is a stub: the backbone takes
precomputed patch embeddings, projects them and prepends them to the token
sequence. A copy of ``repro.configs.internvl2_26b``.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="internvl2-26b",
    family="vlm",
    source="[arXiv:2404.16821; hf]",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92_553,
    rope_theta=1_000_000.0,
    frontend="vision",
    frontend_tokens=256,  # one 448px tile -> 256 patch embeddings after pixel-shuffle
    frontend_dim=3200,  # InternViT-6B width
    pattern=(LayerSpec("attn", "dense"),),
)
