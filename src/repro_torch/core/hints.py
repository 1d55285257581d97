"""Two-stage hints buffer (paper §IV-C): per-key dedup with max-timestamp
merge; ``unprocessed`` -> ``in_flight`` as the state thread pool picks keys.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple


class HintsBuffer:
    def __init__(self, max_size: int = 100_000):
        self.unprocessed: "OrderedDict[Any, float]" = OrderedDict()
        self.in_flight: Dict[Any, float] = {}
        self.max_size = max_size
        self.dropped = 0

    def add(self, key: Any, ts: float) -> None:
        if key in self.in_flight:
            self.in_flight[key] = max(self.in_flight[key], ts)
            return
        old = self.unprocessed.get(key)
        if old is not None:
            self.unprocessed[key] = max(old, ts)
            return
        if len(self.unprocessed) >= self.max_size:
            self.dropped += 1
            return
        self.unprocessed[key] = ts

    def next_fetch(self) -> Optional[Tuple[Any, float]]:
        """Move the oldest unprocessed hint to in-flight and return it."""
        if not self.unprocessed:
            return None
        key, ts = self.unprocessed.popitem(last=False)
        self.in_flight[key] = ts
        return key, ts

    def take(self, key: Any) -> Optional[float]:
        """Move a specific key to in-flight (fetch being issued for it)."""
        ts = self.unprocessed.pop(key, None)
        if ts is not None:
            self.in_flight[key] = ts
        return ts

    def complete(self, key: Any) -> Optional[float]:
        """Fetch done: drop from the buffer, returning the (latest) ts."""
        return self.in_flight.pop(key, None)

    def discard(self, key: Any) -> None:
        self.unprocessed.pop(key, None)

    def pending(self, key: Any) -> bool:
        return key in self.unprocessed or key in self.in_flight

    def __len__(self) -> int:
        return len(self.unprocessed) + len(self.in_flight)
