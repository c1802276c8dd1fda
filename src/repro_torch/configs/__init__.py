"""Config registry of the port.

``ARCHS`` holds ``repro``'s ten architectures, copies field for field: the
dense llama-style LMs (internlm2-20b, llama3-8b, yi-9b), gemma3-27b (5
local layers of a 1024-token window to 1 global), the MoE LMs
qwen3-moe-30b-a3b and qwen3-moe-235b-a22b (128 experts, top-8),
mamba2-780m (attention-free Mamba-2 SSD), jamba-v0.1-52b (Mamba, attention
and MoE interleaved), whisper-tiny (an encoder-decoder over stub audio
frames) and internvl2-26b (stub vision patches prepended to an
internlm2-style backbone). ``PAPER_CNN`` and ``VIT_S16`` are the vision
classifiers; ``get_config`` resolves a name among all of them, as
``repro``'s does.
``LM_SHAPES`` are the dry run's four input shapes; ``shape_applicable``
says which of them an architecture runs.
"""
from repro_torch.configs import (
    gemma3_27b,
    internlm2_20b,
    internvl2_26b,
    jamba_v01_52b,
    llama3_8b,
    mamba2_780m,
    paper_cnn,
    qwen3_moe_30b_a3b,
    qwen3_moe_235b_a22b,
    vit,
    whisper_tiny,
    yi_9b,
)
from repro_torch.configs.base import (DECODE_32K, LM_SHAPES, LONG_500K, PREFILL_32K, SHAPES_BY_NAME, TRAIN_4K,
                                     ArchConfig, LayerSpec, ShapeConfig, reduced, shape_applicable)
from repro_torch.configs.vit import VitConfig, reduced_vit

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in (
        gemma3_27b.CONFIG,
        internlm2_20b.CONFIG,
        llama3_8b.CONFIG,
        yi_9b.CONFIG,
        qwen3_moe_30b_a3b.CONFIG,
        qwen3_moe_235b_a22b.CONFIG,
        mamba2_780m.CONFIG,
        jamba_v01_52b.CONFIG,
        whisper_tiny.CONFIG,
        internvl2_26b.CONFIG,
    )
}


PAPER_CNN = paper_cnn.CONFIG
VIT_S16 = vit.CONFIG


def get_config(name: str) -> ArchConfig:
    """``repro.configs.get_config`` over the port's configs: an ``ARCHS``
    name, ``paper-cnn``/``paper_cnn`` or ``vit-s16``/``vit``."""
    if name in ARCHS:
        return ARCHS[name]
    if name in (PAPER_CNN.name, "paper_cnn"):
        return PAPER_CNN  # type: ignore[return-value]
    if name in (VIT_S16.name, "vit"):
        return VIT_S16  # type: ignore[return-value]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)} + ['paper-cnn', 'vit-s16']")


__all__ = ["ARCHS", "ArchConfig", "DECODE_32K", "LM_SHAPES", "LONG_500K", "LayerSpec", "PAPER_CNN",
           "PREFILL_32K", "SHAPES_BY_NAME", "ShapeConfig", "TRAIN_4K", "VIT_S16", "VitConfig",
           "get_config", "reduced", "reduced_vit", "shape_applicable"]
