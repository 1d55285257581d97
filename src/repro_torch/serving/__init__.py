"""Paged session-state serving subsystem (DESIGN.md §6).

The paper's pipeline, recast for stateful LM serving: request session keys
are known at ENQUEUE time (the upstream-lookahead role), so KV-cache pages
can be staged from the slow session store into fixed device slots before the
scheduler picks the request up.

    arena.py     - PagedStateArena: physical page pool + device TAC page table
    store.py     - TieredStore: arena <-> host DRAM <-> modelled backing tier
    scheduler.py - continuous-batching scheduler with enqueue-time hints
    router.py    - ShardRouter: per-shard arenas/stores + key-range migration
    metrics.py   - TTFT/TPOT percentiles, hit-rate, staging-overlap accounting
"""
from repro_torch.serving.arena import PagedStateArena
from repro_torch.serving.metrics import ServingMetrics, percentiles
from repro_torch.serving.router import ShardRouter
from repro_torch.serving.scheduler import (ContinuousBatchingScheduler, Request,
                                     SimClock, WallClock)
from repro_torch.serving.store import TieredStore

__all__ = ["PagedStateArena", "TieredStore", "ContinuousBatchingScheduler",
           "Request", "ServingMetrics", "ShardRouter", "SimClock",
           "WallClock", "percentiles"]
