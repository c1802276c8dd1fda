"""Fault handling of the port: ``repro.runtime``'s retry policy,
straggler monitor and ``run_with_recovery``, the training loop.
``ElasticMesh`` is not ported yet (the mesh, ROADMAP.md queue 1, item 7)."""
from repro_torch.runtime.fault import (FaultConfig, RetryPolicy, StateSpoiled, StragglerMonitor,
                                       run_with_recovery)

__all__ = ["FaultConfig", "RetryPolicy", "StateSpoiled", "StragglerMonitor", "run_with_recovery"]
