"""Serving of the port, as ``repro.serve``: the generation engine and its
steps, the explain engine, its bucketing and its compatibility shim, and
``MixedScheduler``, which serves generate and explain traffic from one
admission-controlled queue, and the caches: the per-bucket tuner, the
result cache and warm state."""
from repro_torch.serve.autotune import (
    AutotuneCache,
    HotpathConfig,
    autotune_engine,
    bucket_key,
    chunk_candidates,
)
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
from repro_torch.serve.result_cache import ResultCache
from repro_torch.serve.warm_state import WarmRestoreReport, load_warm_state, save_warm_state

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
    "AutotuneCache",
    "autotune_engine",
    "chunk_candidates",
    "ResultCache",
    "WarmRestoreReport",
    "load_warm_state",
    "save_warm_state",
]
