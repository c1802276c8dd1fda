"""Fault handling of the port: ``repro.runtime``'s retry policy and
straggler monitor. ``ElasticMesh`` and ``run_with_recovery`` are not ported
yet (the mesh and the training driver, ROADMAP.md queue 1, item 7)."""
from repro_torch.runtime.fault import FaultConfig, RetryPolicy, StragglerMonitor

__all__ = ["FaultConfig", "RetryPolicy", "StragglerMonitor"]
