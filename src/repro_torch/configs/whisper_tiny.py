"""whisper-tiny [audio] — encoder-decoder, conv frontend STUB.

[arXiv:2212.04356; unverified] — the frontend is a stub: the encoder takes
precomputed log-mel frame embeddings. A copy of ``repro.configs.whisper_tiny``.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    source="[arXiv:2212.04356; unverified]",
    num_layers=4,  # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51_865,
    encoder_layers=4,
    encoder_seq=1500,  # 30s of audio at 50 frames/s
    frontend="audio",
    frontend_tokens=1500,
    frontend_dim=384,
    rope_theta=10_000.0,
    pattern=(LayerSpec("attn", "dense"),),
)
