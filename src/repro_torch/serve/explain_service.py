"""Compatibility shim of ``repro.serve.explain_service``: the one-model,
one-method ``ExplainService`` over ``ExplainEngine``.

Requests of any length are bucketed and masked; ``method`` names an
attribution method of ``core.methods`` and ``schedule`` a schedule family;
``autotune`` loads the per-bucket chunks tuned for the device from
``results/`` (``serve.autotune``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from repro_torch.serve.explain_engine import ExplainEngine, ExplainRequest

__all__ = ["ExplainService", "ExplainRequest"]


@dataclass
class ExplainService:
    cfg: Any
    params: Any
    method: str = "ig"
    schedule: str = "paper"
    m: int = 64
    n_int: int = 4
    chunk: int = 0
    pad_id: int = 0
    adaptive: bool = False
    tol: float = 1e-2
    m_max: int = 0
    n_samples: int = 0
    sigma: float = 0.0
    fused: bool = False
    use_kernels: bool = True
    autotune: bool = False
    device: Any = "cuda"

    def __post_init__(self):
        self._engine = ExplainEngine(
            self.cfg, self.params, method=self.method, schedule=self.schedule, m=self.m,
            n_int=self.n_int, chunk=self.chunk, pad_id=self.pad_id, adaptive=self.adaptive,
            tol=self.tol, m_max=self.m_max, n_samples=self.n_samples, sigma=self.sigma,
            fused=self.fused, use_kernels=self.use_kernels, autotune=self.autotune,
            device=self.device,
        )

    @property
    def engine(self) -> ExplainEngine:
        return self._engine

    def explain(self, requests: list[ExplainRequest]) -> list[dict]:
        """Bucket the requests (any S), run the method, return token scores."""
        return self._engine.explain(requests)
