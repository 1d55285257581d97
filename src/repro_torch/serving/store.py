"""Tiered session-state store: arena <-> host DRAM <-> backing tier.

The backing tier reuses ``streaming.backend`` (calibrated latency model,
DESIGN.md §8): the container has no real NVMe/remote KV, so page payloads
are held for real while only the clock is modelled.  Host DRAM is a second
``StateBackend`` with the in-memory model; pages read from backing are
promoted to host, and dirty victims written back land in host and are
flushed to backing by ``persist()`` (checkpoint) — the arena <-> host <->
backing walk of a real disaggregated deployment.

Staging is BATCHED and ASYNC: ``request_stage`` schedules reads over a
bounded lane pool (the paper's state-thread-pool parallelism) and returns
immediately; ``poll(now)`` surfaces completed pages for admission into the
arena.  Latency paid before the scheduler needed the page is HIDDEN
(overlapped with decode compute); ``fetch_sync`` charges the makespan on
the critical path instead — the on-demand baseline.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from repro_torch.streaming.backend import (DISAGGREGATED, IN_MEMORY, BackendModel,
                                     StateBackend)


class TieredStore:
    def __init__(self, backing_model: BackendModel = DISAGGREGATED,
                 host_model: BackendModel = IN_MEMORY,
                 page_bytes: int = 64 * 1024, workers: int = 8):
        self.backing = StateBackend(backing_model)
        self.host = StateBackend(host_model)
        self.page_bytes = page_bytes
        self._lane_free = [0.0] * workers
        # key -> (ready_at, blocks, latency, hint_ts)
        self.in_flight: Dict[Any, Tuple[float, Any, float, float]] = {}
        self._host_dirty: set = set()
        self.staged_pages = 0
        self.sync_fetches = 0
        self.writebacks = 0
        self.hidden_latency = 0.0      # staging latency overlapped w/ compute
        self.critical_latency = 0.0    # staging latency on the request path

    # ----------------------------------------------------------------- tiers
    def seed(self, key: Any, blocks: Any) -> None:
        """Populate the backing tier (session history persisted earlier)."""
        self.backing.write(key, blocks, self.page_bytes)

    def _read_tier(self, key: Any) -> Tuple[Any, float]:
        """Read one page from the fastest tier holding it; promote to host."""
        if key in self.host.data:
            return self.host.fetch(key, self.page_bytes)
        blocks, lat = self.backing.fetch(key, self.page_bytes)
        if blocks is not None:
            self.host.write(key, blocks, self.page_bytes)   # promotion
        return blocks, lat

    # --------------------------------------------------------- async staging
    def _issue(self, key: Any, now: float, hint_ts: float) -> float:
        """Schedule one read on the least-loaded lane; returns ready_at."""
        blocks, lat = self._read_tier(key)
        lane = min(range(len(self._lane_free)),
                   key=lambda i: self._lane_free[i])
        start = max(now, self._lane_free[lane])
        ready = start + lat
        self._lane_free[lane] = ready
        self.in_flight[key] = (ready, blocks, lat, hint_ts)
        return ready

    def request_stage(self, keys: List[Any], now: float,
                      hint_ts: Optional[List[float]] = None) -> int:
        """Batched async staging: schedule every key not already in flight.
        ``hint_ts`` carries each page's PREDICTED ACCESS TIME (the hint
        timestamp the arena will admit it with).  Returns the number of new
        requests issued."""
        n = 0
        for i, k in enumerate(keys):
            t_pred = hint_ts[i] if hint_ts is not None else now
            if k in self.in_flight:
                # a fresher (earlier) prediction refines the pending one
                ready, blocks, lat, old = self.in_flight[k]
                self.in_flight[k] = (ready, blocks, lat, min(old, t_pred))
                continue
            self._issue(k, now, t_pred)
            n += 1
        return n

    def poll(self, now: float) -> List[Tuple[Any, Any, float]]:
        """Surface staged (key, blocks, hint_ts) whose I/O has completed."""
        done = [(k, blocks, hint) for k, (ready, blocks, _, hint) in
                self.in_flight.items() if ready <= now]
        for k, _, _ in done:
            _, _, lat, _ = self.in_flight.pop(k)
            self.hidden_latency += lat
            self.staged_pages += 1
        return done

    # ---------------------------------------------------------- sync staging
    def fetch_sync(self, keys: List[Any], now: float
                   ) -> Tuple[List[Any], float]:
        """On-demand staging: block until every page (including any already
        in flight) is ready; the makespan is charged to the critical path."""
        ready_until = now
        out = []
        for k in keys:
            if k in self.in_flight:                # adopt the async request
                ready, blocks, lat, _ = self.in_flight.pop(k)
                # the part of the I/O that elapsed before now was hidden;
                # only the remainder lands on the request path
                self.hidden_latency += min(lat, max(0.0, now - (ready - lat)))
                self.critical_latency += max(0.0, ready - now)
                self.staged_pages += 1
            else:
                ready = self._issue(k, now, now)
                _, blocks, lat, _ = self.in_flight.pop(k)
                self.critical_latency += lat
                self.staged_pages += 1
            self.sync_fetches += 1
            ready_until = max(ready_until, ready)
            out.append(blocks)
        return out, ready_until - now

    # ------------------------------------------------------------- migration
    def export_keys(self, pred) -> Dict[str, Any]:
        """Key-range migration (DESIGN.md §9): pop every tier entry — host,
        backing, host-dirty flag, and in-flight stage requests — whose key
        satisfies ``pred`` (scalar predicate).  In-flight requests keep
        their ready times: a page already being staged at the source keeps
        overlapping I/O with compute at the destination."""
        moved: Dict[str, Any] = {
            "host": {k: self.host.data.pop(k)
                     for k in [k for k in self.host.data if pred(k)]},
            "backing": {k: self.backing.data.pop(k)
                        for k in [k for k in self.backing.data if pred(k)]},
            "in_flight": {k: self.in_flight.pop(k)
                          for k in [k for k in self.in_flight if pred(k)]},
        }
        moved["dirty"] = {k for k in list(self._host_dirty) if pred(k)}
        self._host_dirty -= moved["dirty"]
        return moved

    def import_keys(self, moved: Dict[str, Any]) -> int:
        """Land a migration export in this store's tiers (bulk transfer,
        off the request path; tier read/write counters track workload I/O,
        so migration moves the dicts directly)."""
        self.host.data.update(moved["host"])
        self.backing.data.update(moved["backing"])
        self.in_flight.update(moved["in_flight"])
        self._host_dirty |= moved["dirty"]
        return sum(len(moved[t]) for t in ("host", "backing", "in_flight"))

    # ------------------------------------------------------------ write-back
    def writeback(self, key: Any, blocks: Any) -> None:
        """Dirty victim evicted from the arena: lands in host DRAM, flushed
        to backing asynchronously (never on the request path)."""
        self.host.write(key, blocks, self.page_bytes)
        self._host_dirty.add(key)
        self.writebacks += 1

    def persist(self) -> int:
        """Checkpoint: flush host-dirty pages to the backing tier."""
        n = 0
        for k in list(self._host_dirty):
            self.backing.write(k, self.host.data[k], self.page_bytes)
            self._host_dirty.discard(k)
            n += 1
        return n

    # --------------------------------------------------------------- metrics
    def stats(self) -> Dict[str, float]:
        tot = self.hidden_latency + self.critical_latency
        return {"store_staged_pages": self.staged_pages,
                "store_sync_fetches": self.sync_fetches,
                "store_writebacks": self.writebacks,
                "store_backing_reads": self.backing.reads,
                "store_backing_writes": self.backing.writes,
                "store_host_reads": self.host.reads,
                "store_hidden_latency": self.hidden_latency,
                "store_critical_latency": self.critical_latency,
                "staging_overlap": self.hidden_latency / tot if tot else 0.0}
