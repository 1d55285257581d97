"""Timestamp-Aware Cache (paper §IV-D).

One cache for both previously-accessed and prefetched entries, ordered by a
single signal — event timestamps:

  * accessed entry:  t_k = event time of last access (LRU-like among those);
  * prefetched entry: t_k = hint timestamp (in the future => protected);
  * renewing hint for a cached key bumps t_k to the hint timestamp.

Eviction removes the smallest-timestamp entry.  Dirty victims go to the
EVICTION BUFFER and are written back asynchronously by the state thread
pool, so writes never block the data path; a read or hint for a key staged
in the eviction buffer moves it back.

The paper implements the order as a timestamp-sorted doubly-linked list;
this implementation keeps the identical eviction ORDER with a lazy min-heap
(O(log n) ops regardless of hint-timestamp interleaving).  The TPU-side twin
(``repro_torch.core.tac_jax`` + ``repro_torch.kernels.tac_probe``) is a fixed-slot
argmin-timestamp variant validated for order-equivalence in tests.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclass
class Entry:
    key: Any
    state: Any
    ts: float
    dirty: bool = False
    size: int = 1


class TimestampAwareCache:
    def __init__(self, capacity: int,
                 on_writeback: Optional[Callable[[Any, Any], None]] = None,
                 deadline_aware: bool = False):
        """capacity counts entry ``size`` units (bytes or slots).

        ``deadline_aware`` changes the eviction ORDER for workloads whose
        timestamps are far-future access DEADLINES (window panes,
        DESIGN.md §10): stale entries (ts behind the clock of observed
        accesses) still evict oldest-first, but among future-deadline
        entries the FARTHEST deadline goes first — Belady's rule on known
        access times.  The paper's min-ts order (default) is right when
        hints run only milliseconds ahead; with deadlines seconds ahead
        it would evict exactly the panes that fire next.
        """
        self.capacity = capacity
        self.entries: Dict[Any, Entry] = {}
        self.evict_buffer: Dict[Any, Entry] = {}
        self._heap: List[Tuple[float, int, Any]] = []   # (ts, gen, key) lazy
        self.deadline_aware = deadline_aware
        self._fheap: List[Tuple[float, int, Any]] = []  # (-ts, gen, key)
        # staleness boundary for deadline_aware eviction: the owner's
        # event-time WATERMARK (set_clock) — an entry whose deadline lies
        # behind it can no longer be accessed by an on-time fire.  Using
        # anything faster (e.g. max observed event ts) would misclassify
        # windows awaiting fire as stale during the watermark lag.
        self.clock = float("-inf")
        self._gen = 0
        self.used = 0
        self.on_writeback = on_writeback
        # stats
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.writebacks = 0
        self.prefetch_insertions = 0
        self.prefetch_unused_evicted = 0
        # per-lookahead-origin accounting for mismatch attribution
        self.pf_ins_by_origin: Dict[str, int] = {}
        self.pf_unused_by_origin: Dict[str, int] = {}
        # eviction-reason breakdown (DESIGN.md §12): (reason, admission)
        # -> count, reason in {capacity, deadline, stale}, admission in
        # {prefetched, demand} by how the victim was admitted
        self.evict_reasons: Dict[Tuple[str, str], int] = {}
        # optional prefetch-quality recorder (repro_torch.obs.quality); when set,
        # staged/used/wasted outcomes and signed lead times flow to the
        # metrics registry
        self.recorder = None

    # ------------------------------------------------------------- internals
    def _push(self, e: Entry) -> None:
        self._gen += 1
        heapq.heappush(self._heap, (e.ts, self._gen, e.key))
        if self.deadline_aware:
            heapq.heappush(self._fheap, (-e.ts, self._gen, e.key))

    def _remove_victim(self, e: Entry, reason: str = "capacity") -> None:
        del self.entries[e.key]
        self.used -= e.size
        self.evictions += 1
        pf = getattr(e, "prefetched_unused", False)
        adm = "prefetched" if getattr(e, "prefetched", False) else "demand"
        self.evict_reasons[(reason, adm)] = \
            self.evict_reasons.get((reason, adm), 0) + 1
        if pf:
            self.prefetch_unused_evicted += 1
            org = getattr(e, "origin", "")
            self.pf_unused_by_origin[org] = \
                self.pf_unused_by_origin.get(org, 0) + 1
            if self.recorder is not None:
                self.recorder.on_wasted()
        if e.dirty:
            self.evict_buffer[e.key] = e                   # async write-back

    def _evict_one(self) -> None:
        if self.deadline_aware:
            # stale first (oldest observed-access ts), skipping lazy
            # records; stop at the first entry whose ts is a live deadline
            while self._heap:
                ts, _, key = self._heap[0]
                e = self.entries.get(key)
                if e is None or e.ts != ts:
                    heapq.heappop(self._heap)
                    continue
                if ts >= self.clock:
                    break                   # only future deadlines remain
                heapq.heappop(self._heap)
                self._remove_victim(e, reason="stale")
                return
            # all live: farthest deadline goes first (Belady on deadlines)
            while self._fheap:
                nts, _, key = heapq.heappop(self._fheap)
                e = self.entries.get(key)
                if e is None or e.ts != -nts:
                    continue
                self._remove_victim(e, reason="deadline")
                return
        while self._heap:
            ts, _, key = heapq.heappop(self._heap)
            e = self.entries.get(key)
            if e is None or e.ts != ts:
                continue                                   # stale heap record
            self._remove_victim(e, reason="capacity")
            return
        return

    def _make_room(self, size: int) -> None:
        while self.used + size > self.capacity and (self._heap or self.entries):
            before = self.used
            self._evict_one()
            if self.used == before:
                break

    def set_clock(self, watermark: float) -> None:
        """Advance the deadline_aware staleness boundary (the consuming
        operator's event-time watermark)."""
        if watermark > self.clock:
            self.clock = watermark

    # ------------------------------------------------------------ public API
    def lookup(self, key: Any, now_ts: float) -> Optional[Any]:
        """Read by key at event time now_ts.  Refreshes the timestamp.
        Checks the eviction buffer (paper: staged entries move back)."""
        e = self.entries.get(key)
        if e is None:
            staged = self.evict_buffer.pop(key, None)
            if staged is not None:
                self._make_room(staged.size)
                staged.ts = max(staged.ts, now_ts)
                staged.prefetched_unused = False
                self.entries[key] = staged
                self.used += staged.size
                self._push(staged)
                self.hits += 1
                return staged.state
            self.misses += 1
            return None
        self.hits += 1
        if now_ts > e.ts:
            e.ts = now_ts
            self._push(e)
        if getattr(e, "prefetched_unused", False) and \
                self.recorder is not None:
            # first read of a staged entry: signed lead time (now minus
            # stage-complete) flows to the registry
            self.recorder.on_used(getattr(e, "stage_t", 0.0))
        e.prefetched_unused = False
        return e.state

    def contains(self, key: Any) -> bool:
        return key in self.entries or key in self.evict_buffer

    def insert(self, key: Any, state: Any, ts: float, dirty: bool = False,
               size: int = 1, prefetched: bool = False,
               origin: str = "") -> None:
        """Insert/overwrite an entry (after an access or a completed fetch)."""
        old = self.entries.get(key)
        if old is not None:
            self.used -= old.size
        self.evict_buffer.pop(key, None)
        self._make_room(size)
        e = Entry(key, state, ts, dirty, size)
        e.prefetched_unused = prefetched
        e.prefetched = prefetched          # admission path, for evict split
        e.origin = origin
        self.entries[key] = e
        self.used += size
        self._push(e)
        if prefetched:
            self.prefetch_insertions += 1
            self.pf_ins_by_origin[origin] = \
                self.pf_ins_by_origin.get(origin, 0) + 1
            if self.recorder is not None:
                e.stage_t = self.recorder.now()
                self.recorder.on_staged()

    def write(self, key: Any, state: Any, now_ts: float, size: int = 1
              ) -> None:
        """Update state in cache (read-modify-write ops); marks dirty."""
        e = self.entries.get(key)
        if e is not None:
            e.state = state
            e.dirty = True
            e.prefetched_unused = False
            if now_ts > e.ts:
                e.ts = now_ts
                self._push(e)
            return
        self.insert(key, state, now_ts, dirty=True, size=size)

    def renew(self, key: Any, hint_ts: float) -> bool:
        """A hint arrived for a cached key: bump its predicted relevance."""
        e = self.entries.get(key)
        if e is None:
            staged = self.evict_buffer.pop(key, None)
            if staged is None:
                return False
            self._make_room(staged.size)
            staged.ts = max(staged.ts, hint_ts)
            self.entries[key] = staged
            self.used += staged.size
            self._push(staged)
            return True
        if hint_ts > e.ts:
            e.ts = hint_ts
            self._push(e)
        return True

    def drop(self, key: Any) -> bool:
        """Remove an entry outright — resident or staged — with NO
        write-back and no unused-prefetch accounting.  The window purge
        path (DESIGN.md §10): once a pane has fired and its lateness
        horizon passed, its state is dead and must not cost a backend
        write.  Heap records left behind go stale and are skipped lazily."""
        e = self.entries.pop(key, None)
        if e is not None:
            self.used -= e.size
            return True
        return self.evict_buffer.pop(key, None) is not None

    def export_entries(self, pred: Callable[[Any], bool]) -> List[Entry]:
        """Shard migration drain (DESIGN.md §9): pop every entry — resident
        or staged in the eviction buffer — whose key satisfies ``pred``.
        Timestamps and dirty bits ride along so the destination subtask
        re-inserts with the SAME eviction priority; heap records left behind
        go stale and are skipped lazily."""
        out = []
        for key in [k for k in self.entries if pred(k)]:
            e = self.entries.pop(key)
            self.used -= e.size
            out.append(e)
        for key in [k for k in self.evict_buffer if pred(k)]:
            out.append(self.evict_buffer.pop(key))
        return out

    def import_entries(self, entries: List[Entry],
                       now_ts: float = 0.0) -> int:
        """Inverse of ``export_entries`` (migration re-admit §9, snapshot
        restore roundtrips §7 — DESIGN.md): re-insert exported entries
        preserving their timestamps and dirty bits, so the destination
        cache reproduces the SAME eviction order (including the
        deadline-aware order — ordering is a pure function of entry
        timestamps and the clock).  Entries without a timestamp (LRU/
        Clock exports crossing policies) enter at ``now_ts``."""
        for e in entries:
            self.insert(e.key, e.state, getattr(e, "ts", now_ts),
                        dirty=e.dirty, size=e.size)
        return len(entries)

    def pop_writeback(self) -> Optional[Entry]:
        """State thread pool: take one dirty entry to write to the backend."""
        if not self.evict_buffer:
            return None
        key = next(iter(self.evict_buffer))
        e = self.evict_buffer.pop(key)
        self.writebacks += 1
        return e

    def flush_dirty(self) -> List[Entry]:
        """Checkpoint barrier: all dirty state (resident + staged) to persist
        (paper §IV-E)."""
        out = [e for e in self.entries.values() if e.dirty]
        out += list(self.evict_buffer.values())
        for e in out:
            e.dirty = False
        self.evict_buffer.clear()
        return out

    def eviction_block(self) -> Dict[str, int]:
        """Flat ``"<reason>.<admission>" -> count`` rollup of the
        eviction-reason breakdown (DESIGN.md §12)."""
        return {f"{r}.{a}": n
                for (r, a), n in sorted(self.evict_reasons.items())}

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def hit_rate(self) -> float:
        tot = self.hits + self.misses
        return self.hits / tot if tot else 0.0
