"""Serving of the port, as ``repro.serve``: the generation engine and its
steps, the explain engine, its bucketing and its compatibility shim, and
``MixedScheduler``, which serves generate and explain traffic from one
admission-controlled queue. The tuner, the result cache and warm state are
not ported yet."""
from repro_torch.serve.autotune import HotpathConfig, bucket_key
from repro_torch.serve.batching import BucketBatch, bucket_for, plan_buckets, pow2_ladder
from repro_torch.serve.engine import (
    ServeEngine,
    make_decode_chunk,
    make_decode_loop,
    make_prefill_step,
    make_serve_step,
    sample_token,
)
from repro_torch.serve.explain_engine import (
    AdaptiveBucketRun,
    EngineStats,
    ExplainEngine,
    ExplainRequest,
)
from repro_torch.serve.explain_service import ExplainService
from repro_torch.serve.scheduler import (
    BATCH,
    EXPLAIN,
    INTERACTIVE,
    GenerateRequest,
    MixedScheduler,
    SLOClass,
    TenantPolicy,
    Ticket,
)

__all__ = [
    "ServeEngine",
    "make_serve_step",
    "make_prefill_step",
    "make_decode_loop",
    "make_decode_chunk",
    "sample_token",
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
    "MixedScheduler",
    "GenerateRequest",
    "Ticket",
    "SLOClass",
    "TenantPolicy",
    "INTERACTIVE",
    "BATCH",
    "EXPLAIN",
]
