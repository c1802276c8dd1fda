"""The synthetic data of the port: ``repro.data``'s LM pipeline and the
image task of the trained classifiers (``benchmarks/common.py``'s)."""
from repro_torch.data.images import render_images, synthetic_images
from repro_torch.data.pipeline import DataConfig, SyntheticLM, make_pipeline

__all__ = ["DataConfig", "SyntheticLM", "make_pipeline", "render_images", "synthetic_images"]
