"""Serving subsystem of the port: the request-lifecycle API, paging
(allocator, prefix cache, device page pool, host swap tier), the
scheduler, and the paged engine (page-table and gather pathways) with
its contiguous oracle and the oracle's verdict, ``compare_engines``."""
from repro_torch.serve.api import (GREEDY, Engine, LaneState, RequestHandle,
                                   SamplingParams, run_requests)
from repro_torch.serve.engine import (PagedServeEngine, Request, ServeEngine,
                                      compare_engines, resolve_device,
                                      token_matrix)
from repro_torch.serve.paging import (BlockAllocator, BlockAllocatorError,
                                      DevicePageView, HostSwapPool, KVPool,
                                      PrefixCache, chain_hashes, pages_for)
from repro_torch.serve.scheduler import (Plan, SchedEntry, Scheduler,
                                         SwapCostModel)

__all__ = [
    "BlockAllocator", "BlockAllocatorError", "DevicePageView", "Engine",
    "GREEDY", "HostSwapPool", "KVPool", "LaneState", "PagedServeEngine",
    "Plan", "PrefixCache", "Request", "RequestHandle", "SamplingParams",
    "SchedEntry", "Scheduler", "ServeEngine", "SwapCostModel",
    "chain_hashes", "compare_engines", "pages_for", "resolve_device",
    "run_requests", "token_matrix",
]
