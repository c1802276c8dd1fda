"""PyTorch/CUDA port of the NUIG explainer (``repro``), for NVIDIA Hopper.

The layout mirrors ``repro``: ``configs``, ``models``, ``core`` (paths,
schedule, probes, methods, ig, metrics, api) and ``kernels`` (one directory
per hand-written Triton kernel, each with ``kernel.py``, ``ops.py`` and the
plain-PyTorch ``ref.py``). Public functions keep ``repro``'s layouts (images
NHWC, attributions shaped like the input) so the two packages compare like
with like. Nothing here imports ``jax`` or ``repro``.
"""
