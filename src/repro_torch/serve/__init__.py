"""Serving: scheduler, dense and paged KV pools and engines."""
from repro_torch.serve.cache_pool import CachePool, PagedCachePool
from repro_torch.serve.engine import (ContinuousBatchingEngine, GenResult,
                                      ServeEngine, ServeSummary,
                                      prefill_bucket)
from repro_torch.serve.scheduler import Request, RequestResult, Scheduler

__all__ = ["CachePool", "PagedCachePool", "ContinuousBatchingEngine", "GenResult",
           "ServeEngine", "ServeSummary", "prefill_bucket", "Request",
           "RequestResult", "Scheduler"]
