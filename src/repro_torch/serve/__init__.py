"""Serving subsystem of the port: the request-lifecycle API, paging
(allocator, prefix cache, device page pool, host swap tier), the
scheduler, the paged engine (page-table and gather pathways) with its
contiguous oracle and the oracle's verdict, ``compare_engines``, the
workload-trace generator (``workloads``) and the multi-replica cluster
behind prefix-affinity routing (``cluster``).  ``__all__`` is the
reference's; ``resolve_device`` is the port's own and is imported by
name."""
from repro_torch.serve.api import (GREEDY, Engine, LaneState, RequestHandle,
                                   SamplingParams, run_requests)
from repro_torch.serve.cluster import (AffinityPolicy, BloomSummary,
                                       ClusterEngine, ExactSummary,
                                       RandomPolicy, RoundRobinPolicy,
                                       make_policy, match_depth)
from repro_torch.serve.engine import (PagedServeEngine, Request, ServeEngine,
                                      compare_engines, resolve_device,
                                      token_matrix)
from repro_torch.serve.paging import (BlockAllocator, BlockAllocatorError,
                                      DevicePageView, HostSwapPool, KVPool,
                                      PrefixCache, SwapStats, chain_hashes,
                                      pages_for)
from repro_torch.serve.scheduler import (Plan, SchedEntry, Scheduler,
                                         SwapCostModel)
from repro_torch.serve.workloads import (WorkloadSpec, WorkloadTrace,
                                         generate, smoke_specs)

__all__ = [
    "AffinityPolicy", "BlockAllocator", "BlockAllocatorError",
    "BloomSummary", "ClusterEngine", "DevicePageView", "Engine",
    "ExactSummary", "GREEDY", "HostSwapPool", "KVPool", "LaneState",
    "PrefixCache", "PagedServeEngine", "Plan", "RandomPolicy", "Request",
    "RequestHandle", "RoundRobinPolicy", "SamplingParams", "SchedEntry",
    "Scheduler", "ServeEngine", "SwapCostModel", "SwapStats",
    "WorkloadSpec", "WorkloadTrace", "chain_hashes", "compare_engines",
    "generate", "make_policy", "match_depth", "pages_for", "run_requests",
    "smoke_specs", "token_matrix",
]
