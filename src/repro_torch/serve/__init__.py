"""Serving: scheduler, dense and paged KV pools and engines, fault
injection, load-adaptive MP and the numerical guardrail."""
from repro_torch.serve.adaptive import AdaptiveMPController, NumericalGuardrail
from repro_torch.serve.cache_pool import CachePool, PagedCachePool
from repro_torch.serve.engine import (ContinuousBatchingEngine, GenResult,
                                      ServeEngine, ServeSummary,
                                      prefill_bucket)
from repro_torch.serve.faults import (FAULT_KINDS, FaultInjector, FaultSpec,
                                      InjectedFault)
from repro_torch.serve.scheduler import Request, RequestResult, Scheduler

__all__ = ["AdaptiveMPController", "CachePool", "ContinuousBatchingEngine",
           "FAULT_KINDS", "FaultInjector", "FaultSpec", "GenResult",
           "InjectedFault", "NumericalGuardrail", "PagedCachePool",
           "Request", "RequestResult", "Scheduler", "ServeEngine",
           "ServeSummary", "prefill_bucket"]
