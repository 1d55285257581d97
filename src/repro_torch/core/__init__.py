from repro_torch.core.cms import CountMinFilter
from repro_torch.core.hint_filter import HintFilter
from repro_torch.core.hints import HintsBuffer
from repro_torch.core.policies import ClockCache, LRUCache
from repro_torch.core.prefetch import (LookaheadCandidate, PrefetchingController,
                                 PrefetchingManager)
from repro_torch.core.tac import TimestampAwareCache

__all__ = ["CountMinFilter", "HintFilter", "HintsBuffer", "ClockCache",
           "LRUCache", "LookaheadCandidate", "PrefetchingController",
           "PrefetchingManager", "TimestampAwareCache"]
