"""Baseline cache policies (paper §VI baselines): LRU and Clock.

Same interface as the Timestamp-Aware Cache (``core/tac.py``,
DESIGN.md §3) so the stateful operator is policy-agnostic: ``lookup`` /
``insert`` / ``write`` / ``contains``, the dirty/eviction-buffer
protocol (``pop_writeback`` / ``flush_dirty``, §3 and §7) so the
Async-I/O baseline can also write back off the critical path (as
Flink's RocksDB cache does via the memtable), the migration drain
``export_entries`` (§9), and the purge ``drop`` (§10, §11).  Timestamp
arguments are accepted and ignored — LRU/Clock order is positional, so
hint ``renew`` degenerates to a residency check.
"""
from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Dict, List, Optional


@dataclass
class _E:
    key: Any
    state: Any
    dirty: bool = False
    size: int = 1
    ref: bool = True          # clock reference bit


class _BaseCache:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self.used = 0
        self.evict_buffer: Dict[Any, _E] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.writebacks = 0
        self.prefetch_insertions = 0
        self.pf_ins_by_origin = {}
        self.pf_unused_by_origin = {}

    def pop_writeback(self):
        if not self.evict_buffer:
            return None
        key = next(iter(self.evict_buffer))
        e = self.evict_buffer.pop(key)
        self.writebacks += 1
        return e

    def export_entries(self, pred) -> List[_E]:
        """Shard migration drain (DESIGN.md §9): pop every entry
        (resident + eviction buffer) whose key satisfies ``pred``.
        ``_E`` carries no timestamp (LRU/Clock order is positional), so
        the destination re-inserts at migration time — the TAC keeps
        true timestamps (core/tac.py)."""
        out = []
        for key in [k for k in self.entries if pred(k)]:
            e = self.entries.pop(key)
            self.used -= e.size
            out.append(e)
        for key in [k for k in self.evict_buffer if pred(k)]:
            out.append(self.evict_buffer.pop(key))
        if hasattr(self, "_hand"):
            self._hand = []               # clock hand invalidated by removal
        return out

    def import_entries(self, entries, now_ts=0.0) -> int:
        """Inverse of ``export_entries`` (migration re-admit §9, snapshot
        restore roundtrips §7 — DESIGN.md).  ``_E`` carries no timestamp;
        LRU/Clock order is positional, and ``export_entries`` drains in
        recency order (oldest first), so re-inserting in export order
        reproduces the relative eviction order.  Dirty bits ride along."""
        for e in entries:
            self.insert(e.key, e.state, getattr(e, "ts", now_ts),
                        dirty=e.dirty, size=e.size)
        return len(entries)

    def flush_dirty(self) -> List[_E]:
        out = [e for e in self._iter_entries() if e.dirty]
        out += list(self.evict_buffer.values())
        for e in out:
            e.dirty = False
        self.evict_buffer.clear()
        return out

    @property
    def hit_rate(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0

    # entries iterator provided by subclasses
    def _iter_entries(self):
        raise NotImplementedError

    def drop(self, key) -> bool:
        """Remove an entry outright (window-pane purge §10, interval-key
        expiry §11 — DESIGN.md): no write-back, no eviction
        accounting."""
        e = self.entries.pop(key, None)
        if e is not None:
            self.used -= e.size
            if hasattr(self, "_hand"):
                self._hand = []           # clock hand invalidated by removal
            return True
        return self.evict_buffer.pop(key, None) is not None

    # TAC-compat no-ops
    def renew(self, key, hint_ts) -> bool:
        return self.contains(key)


class LRUCache(_BaseCache):
    def __init__(self, capacity: int):
        super().__init__(capacity)
        self.entries: "OrderedDict[Any, _E]" = OrderedDict()

    def _iter_entries(self):
        return self.entries.values()

    def contains(self, key) -> bool:
        return key in self.entries or key in self.evict_buffer

    def _make_room(self, size: int) -> None:
        while self.used + size > self.capacity and self.entries:
            _, e = self.entries.popitem(last=False)
            self.used -= e.size
            self.evictions += 1
            if e.dirty:
                self.evict_buffer[e.key] = e

    def lookup(self, key, now_ts=None):
        e = self.entries.get(key)
        if e is None:
            staged = self.evict_buffer.pop(key, None)
            if staged is not None:
                self._make_room(staged.size)
                self.entries[staged.key] = staged
                self.used += staged.size
                self.hits += 1
                return staged.state
            self.misses += 1
            return None
        self.entries.move_to_end(key)
        self.hits += 1
        return e.state

    def insert(self, key, state, ts=None, dirty=False, size=1,
               prefetched=False, origin=""):
        old = self.entries.pop(key, None)
        if old is not None:
            self.used -= old.size
        self.evict_buffer.pop(key, None)
        self._make_room(size)
        self.entries[key] = _E(key, state, dirty, size)
        self.used += size
        if prefetched:
            self.prefetch_insertions += 1
            self.pf_ins_by_origin[origin] = \
                self.pf_ins_by_origin.get(origin, 0) + 1

    def write(self, key, state, now_ts=None, size=1):
        e = self.entries.get(key)
        if e is not None:
            e.state = state
            e.dirty = True
            self.entries.move_to_end(key)
            return
        self.insert(key, state, dirty=True, size=size)

    def __len__(self):
        return len(self.entries)


class ClockCache(_BaseCache):
    def __init__(self, capacity: int):
        super().__init__(capacity)
        self.entries: "OrderedDict[Any, _E]" = OrderedDict()
        self._hand: List[Any] = []
        self._hand_idx = 0

    def _iter_entries(self):
        return self.entries.values()

    def contains(self, key) -> bool:
        return key in self.entries or key in self.evict_buffer

    def _make_room(self, size: int) -> None:
        while self.used + size > self.capacity and self.entries:
            if not self._hand:
                self._hand = list(self.entries.keys())
                self._hand_idx = 0
            scanned = 0
            victim = None
            n = len(self._hand)
            while scanned < 2 * n:
                k = self._hand[self._hand_idx % n]
                self._hand_idx += 1
                scanned += 1
                e = self.entries.get(k)
                if e is None:
                    continue
                if e.ref:
                    e.ref = False
                else:
                    victim = e
                    break
            if victim is None:
                # all referenced: take current position
                for k in self.entries:
                    victim = self.entries[k]
                    break
            del self.entries[victim.key]
            self.used -= victim.size
            self.evictions += 1
            self._hand = []
            if victim.dirty:
                self.evict_buffer[victim.key] = victim

    def lookup(self, key, now_ts=None):
        e = self.entries.get(key)
        if e is None:
            staged = self.evict_buffer.pop(key, None)
            if staged is not None:
                self._make_room(staged.size)
                staged.ref = True
                self.entries[staged.key] = staged
                self.used += staged.size
                self.hits += 1
                return staged.state
            self.misses += 1
            return None
        e.ref = True
        self.hits += 1
        return e.state

    def insert(self, key, state, ts=None, dirty=False, size=1,
               prefetched=False, origin=""):
        old = self.entries.pop(key, None)
        if old is not None:
            self.used -= old.size
        self.evict_buffer.pop(key, None)
        self._make_room(size)
        self.entries[key] = _E(key, state, dirty, size)
        self.used += size
        self._hand = []
        if prefetched:
            self.prefetch_insertions += 1
            self.pf_ins_by_origin[origin] = \
                self.pf_ins_by_origin.get(origin, 0) + 1

    def write(self, key, state, now_ts=None, size=1):
        e = self.entries.get(key)
        if e is not None:
            e.state = state
            e.dirty = True
            e.ref = True
            return
        self.insert(key, state, dirty=True, size=size)

    def __len__(self):
        return len(self.entries)
