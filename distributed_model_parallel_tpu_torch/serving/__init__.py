"""Serving (port of `serving/`): continuous batching over a preallocated
KV cache, contiguous slots or a paged pool, with chunked prefill, the
prefix cache, speculative decoding and the tp / sp layouts across
ranks."""

from distributed_model_parallel_tpu_torch.serving.engine import (  # noqa: F401
    ServingEngine,
)
from distributed_model_parallel_tpu_torch.serving.kv_cache import (  # noqa: F401,E501
    KVCacheSpec,
    SlotAllocator,
    cache_pspecs,
    init_cache,
)
from distributed_model_parallel_tpu_torch.serving.scheduler import (  # noqa: F401,E501
    Request,
    Scheduler,
)

__all__ = [
    "KVCacheSpec",
    "Request",
    "Scheduler",
    "ServingEngine",
    "SlotAllocator",
    "cache_pspecs",
    "init_cache",
]
