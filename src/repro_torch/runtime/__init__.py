"""Fault handling of the port: ``repro.runtime``'s retry policy,
straggler monitor, elastic remeshing and ``run_with_recovery``, the
training loop."""
from repro_torch.runtime.fault import (ElasticMesh, FaultConfig, RetryPolicy, StateSpoiled, StragglerMonitor,
                                       run_with_recovery)

__all__ = ["ElasticMesh", "FaultConfig", "RetryPolicy", "StateSpoiled", "StragglerMonitor", "run_with_recovery"]
