"""Explanation serving of the port: ``repro.serve``'s explain engine, its
bucketing and its compatibility shim. The decode engine, the scheduler,
the tuner, the result cache and warm state are not ported yet (ROADMAP.md
queue 1, items 4–5)."""
from repro_torch.serve.autotune import HotpathConfig, bucket_key
from repro_torch.serve.batching import BucketBatch, bucket_for, plan_buckets, pow2_ladder
from repro_torch.serve.explain_engine import (
    AdaptiveBucketRun,
    EngineStats,
    ExplainEngine,
    ExplainRequest,
)
from repro_torch.serve.explain_service import ExplainService

__all__ = [
    "AdaptiveBucketRun",
    "BucketBatch",
    "EngineStats",
    "ExplainEngine",
    "ExplainRequest",
    "ExplainService",
    "HotpathConfig",
    "bucket_for",
    "bucket_key",
    "plan_buckets",
    "pow2_ladder",
]
