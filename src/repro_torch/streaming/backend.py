"""State backends with calibrated latency models (DESIGN.md §8).

The container has no NVMe array or remote Redis; the backends model access
latency (seek + size/bandwidth) and bounded I/O parallelism while holding the
actual key->state dict, so policy behaviour (what is fetched, when, hit
ratios, write-back volume) is real and only the clock is simulated.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Dict, Optional, Set, Tuple


@dataclass(frozen=True)
class BackendModel:
    name: str
    base_latency: float           # seconds per op
    bandwidth: float              # bytes/s
    parallelism: int = 8          # concurrent ops per subtask


# effective RocksDB-on-NVMe read (device ~80us + read-amp/block decode)
LOCAL_NVME = BackendModel("nvme", 250e-6, 2.0e9, parallelism=8)
# remote KV (same-DC Redis-class RTT + transfer)
DISAGGREGATED = BackendModel("disagg", 300e-6, 1.2e9, parallelism=32)
IN_MEMORY = BackendModel("mem", 1e-6, 50e9, parallelism=64)


class StateBackend:
    """Key-value store for one stateful subtask."""

    def __init__(self, model: BackendModel, default_factory=None,
                 assume_present: bool = False):
        self.model = model
        self.data: Dict[Any, Any] = {}
        self.default_factory = default_factory
        # static/enrichment tables (YSB campaigns, Q13 side input) are fully
        # populated: every lookup pays the full read, no bloom fast path
        self.assume_present = assume_present
        self.reads = 0
        self.writes = 0
        self.bytes_read = 0
        self.bytes_written = 0
        # incremental-checkpoint delta (DESIGN.md §7): keys materialized/
        # written and keys deleted since the last snapshot_delta() cut.
        # Tracking is OFF until a CheckpointCoordinator attaches (it must
        # attach before data flows so the first epoch's delta covers all
        # state) — otherwise the tombstone set would grow without bound
        # in runs that never checkpoint
        self.track_deltas = False
        self._epoch_dirty: Set[Any] = set()
        self._epoch_deleted: Set[Any] = set()

    NEGATIVE_LOOKUP = 20e-6   # bloom-filter fast path for absent keys

    def latency(self, size: int) -> float:
        return self.model.base_latency + size / self.model.bandwidth

    def peek_latency(self, key: Any, size: int = 200):
        '''(would-be state?, latency) without counting a read.'''
        if self.assume_present or key in self.data:
            return True, self.latency(size)
        return False, self.NEGATIVE_LOOKUP

    def fetch(self, key: Any, size: int = 200):
        '''Read with presence-aware latency: absent keys are answered by the
        store's bloom filters (paper Q18 discussion).'''
        present, lat = self.peek_latency(key, size)
        state = self.read(key, size)
        return state, lat

    def read(self, key: Any, size: int = 200) -> Any:
        self.reads += 1
        self.bytes_read += size
        if key not in self.data and self.default_factory is not None:
            # first touch materializes state: it belongs to the epoch's
            # delta like any other write (DESIGN.md §7)
            self.data[key] = self.default_factory(key)
            if self.track_deltas:
                self._epoch_dirty.add(key)
                self._epoch_deleted.discard(key)
        return self.data.get(key)

    def write(self, key: Any, value: Any, size: int = 200) -> None:
        self.writes += 1
        self.bytes_written += size
        self.data[key] = value
        if self.track_deltas:
            self._epoch_dirty.add(key)
            self._epoch_deleted.discard(key)

    def delete(self, key: Any) -> bool:
        """Drop a key (fired-window purge, DESIGN.md §10).  Tombstone
        writes are cheap and batched in real stores, so this is not
        charged as workload I/O.  The tombstone IS logged in the epoch
        delta (§7): an incremental restore must not resurrect the key."""
        if self.data.pop(key, None) is not None:
            if self.track_deltas:
                self._epoch_deleted.add(key)
                self._epoch_dirty.discard(key)
            return True
        return False

    # ------------------------------------------------------ shard migration
    def export_keys(self, pred) -> Dict[Any, Any]:
        """Migration handoff (DESIGN.md §9): pop every entry whose key
        satisfies ``pred``.  The authoritative copy of a migrating shard
        moves with it; the bulk transfer runs off the tuple path, so read/
        write counters (workload I/O) are not charged.  The departures are
        logged as epoch-delta tombstones (§7) so an incremental snapshot of
        THIS partition stops covering the moved keys."""
        out = {}
        for k in [k for k in self.data if pred(k)]:
            out[k] = self.data.pop(k)
            if self.track_deltas:
                self._epoch_deleted.add(k)
                self._epoch_dirty.discard(k)
        return out

    def import_keys(self, items: Dict[Any, Any]) -> int:
        """Land a migration export in this backend's partition (logged as
        epoch-delta writes, DESIGN.md §7)."""
        self.data.update(items)
        if self.track_deltas:
            self._epoch_dirty.update(items)
            self._epoch_deleted.difference_update(items)
        return len(items)

    # ------------------------------------------------- checkpoint (§7)
    def snapshot_delta(self) -> Tuple[Dict[Any, Any], Set[Any]]:
        """Barrier-time incremental export (DESIGN.md §7): deep copies of
        every entry written since the last cut, plus the tombstone set.
        Deep copies because operators mutate hot state in place (§11) —
        a shallow snapshot would keep mutating after the barrier.  Like
        the migration drain, the export runs off the tuple path and is
        metered as snapshot bytes, not workload reads; the restore of
        these bytes IS charged at backend speed (streaming/recovery.py).
        """
        delta = {k: copy.deepcopy(self.data[k])
                 for k in self._epoch_dirty if k in self.data}
        deleted = set(self._epoch_deleted)
        self._epoch_dirty.clear()
        self._epoch_deleted.clear()
        return delta, deleted

    def restore_snapshot(self, items: Dict[Any, Any]) -> int:
        """Recovery (DESIGN.md §7): replace this partition with the
        materialized snapshot state.  The caller charges the bulk read at
        backend speed (no free reads on the restore path)."""
        self.data = dict(items)
        self._epoch_dirty.clear()
        self._epoch_deleted.clear()
        return len(self.data)

    def reset(self) -> None:
        """Failure handling: drop the (volatile stand-in) partition before
        restore re-imports the durable snapshot."""
        self.data.clear()
        self._epoch_dirty.clear()
        self._epoch_deleted.clear()
