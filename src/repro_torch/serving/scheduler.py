# Copy of repro/serving/scheduler.py; differs only in `_collate`, which stacks
# page blocks with torch (tests/test_torch_serving.py holds the rest equal).
"""Continuous-batching request scheduler with enqueue-time key hints.

The INGEST stage plays the paper's upstream-lookahead role: a request's
session key (hence the exact set of state pages it will touch) is known the
moment it is enqueued, long before the scheduler picks it up.  In
``prefetch`` mode, ``submit`` immediately hints the tiered store, which
stages the pages toward the arena while the request waits in the queue — so
decode starts the instant the request is scheduled.

Modes mirror ``StatefulOp`` (streaming/engine.py), so the paper's
sync/async/prefetch comparison runs on the serving path too:

  sync     - missing pages are fetched ON DEMAND, blocking the scheduler
             (staging makespan on the critical path);
  async    - missing pages are requested when the request first comes up
             for scheduling; the request PARKS and the scheduler moves on
             (I/O overlapped, but no lookahead window);
  prefetch - async + staging begins at ENQUEUE time via the ingest hint.

Only requests whose pages are all resident are scheduled; everything else
parks until ``poll``ed completions admit their pages.

The scheduler is storage-topology-agnostic: ``arena``/``store`` can be one
``PagedStateArena`` + ``TieredStore`` pair, or a ``ShardRouter``
(serving/router.py) passed as BOTH — the router exposes the same batched
interface over per-shard pairs, so hints route to owning shards and
key-range migrations happen underneath without scheduler changes
(DESIGN.md §9).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.serving.arena import PagedStateArena
from repro_torch.serving.metrics import ServingMetrics
from repro_torch.serving.store import TieredStore


class WallClock:
    """Real time; ``sleep`` actually blocks (live serving)."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, dt: float) -> None:
        if dt > 0:
            time.sleep(dt)

    def advance(self, dt: float) -> None:      # compute time passes for real
        pass


class SimClock:
    """Virtual time: modelled I/O latencies and measured compute advance the
    same clock, so benchmarks mix REAL jitted decode cost with modelled
    store latency without wall-clock sleeping."""

    def __init__(self, t0: float = 0.0):
        self.t = t0

    def now(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        if dt > 0:
            self.t += dt

    def advance(self, dt: float) -> None:
        if dt > 0:
            self.t += dt


@dataclass
class Request:
    rid: int
    session: int
    page_keys: np.ndarray                  # int32 page keys this request uses
    n_tokens: int = 1                      # decode steps wanted
    enqueue_t: float = 0.0
    state: str = "queued"                  # queued | parked | ready | done
    tokens_done: int = 0
    meta: Dict[str, Any] = field(default_factory=dict)  # e.g. decode pos


class ContinuousBatchingScheduler:
    def __init__(self, arena: PagedStateArena, store: TieredStore,
                 mode: str = "prefetch", max_batch: int = 4,
                 clock=None, metrics: Optional[ServingMetrics] = None,
                 hint_horizon: float = 1e-3,
                 stage_ahead: Optional[int] = None):
        assert mode in ("sync", "async", "prefetch")
        self.arena = arena
        self.store = store
        self.mode = mode
        self.max_batch = max_batch
        self.clock = clock if clock is not None else WallClock()
        self.metrics = metrics if metrics is not None else ServingMetrics()
        # minimum hint lead: a prefetched page's timestamp must sit in the
        # future so it is protected until its request runs (paper §IV-D)
        self.hint_horizon = hint_horizon
        # timeliness bound: only stage for the first `stage_ahead` queue
        # positions, so prefetch for deep-queue requests cannot thrash the
        # arena out from under the requests about to run
        self.stage_ahead = stage_ahead
        self.queue: List[Request] = []
        self.hints_emitted = 0
        self.parked_events = 0
        # EWMA of per-request service time: spaces predicted access times
        self.service_est = 2e-3
        self._last_sched_t: Optional[float] = None

    # ---------------------------------------------------------------- ingest
    def submit(self, req: Request) -> None:
        now = self.clock.now()
        req.enqueue_t = now
        self.metrics.record_enqueue(req.rid, now)
        self.queue.append(req)
        if self.mode == "prefetch":        # ingest = the lookahead operator
            self._hint(req, now, queue_pos=len(self.queue) - 1)

    def _stage_window(self, req: Request) -> int:
        """How many queue positions ahead staging is allowed to run: at most
        what the arena can hold on top of the running batch."""
        if self.stage_ahead is not None:
            return self.stage_ahead
        per_req = max(1, len(req.page_keys))
        return max(self.max_batch,
                   self.arena.n_slots // per_req - self.max_batch)

    def _predicted_access(self, now: float, queue_pos: int) -> float:
        """Hint timestamp = predicted access time.  FIFO order spaces the
        predictions by the measured service rate, so min-ts eviction
        prefers pages needed FURTHEST in the future (the paper's
        timestamp-ordering argument, transplanted to serving)."""
        waves = queue_pos // max(1, self.max_batch)
        return now + self.hint_horizon + waves * self.service_est

    def _hint(self, req: Request, now: float, queue_pos: int) -> None:
        """Keyed-prefetching hint: renew resident pages (protect them until
        the request runs), stage the rest from the store."""
        if queue_pos >= self._stage_window(req):
            return                          # too early to be timely
        self.hints_emitted += 1
        t_pred = self._predicted_access(now, queue_pos)
        hit, _ = self.arena.probe(req.page_keys, count=False)
        resident = req.page_keys[hit]
        if resident.size:
            self.arena.renew(resident,
                             np.full(resident.shape, t_pred, np.float32))
        missing = [int(k) for k in req.page_keys[~hit]]
        if missing:
            self.store.request_stage(missing, now,
                                     [t_pred] * len(missing))
        req.meta["hinted"] = True

    # ------------------------------------------------------------ completion
    def absorb_completions(self) -> int:
        """Admit every staged page that completed: one batched admit + one
        batched stage; dirty victims go back to the store."""
        now = self.clock.now()
        done = self.store.poll(now)
        if not done:
            return 0
        keys = np.asarray([k for k, _, _ in done], np.int32)
        # admit with the PREDICTED ACCESS TIME captured when the stage was
        # requested (never in the past: stale predictions stay evictable)
        ts = np.asarray([max(h, now + self.hint_horizon)
                         for _, _, h in done], np.float32)
        adm = self.arena.admit(keys, ts)
        self._writeback_victims(adm)
        blocks = self._collate([b for _, b, _ in done])
        self.arena.stage(adm.slots, blocks)
        return len(done)

    def _collate(self, block_dicts: List[Dict[str, Any]]) -> Dict[str, Any]:
        pools = block_dicts[0].keys()
        return {p: torch.stack([torch.as_tensor(d[p]) for d in block_dicts])
                for p in pools}

    def _writeback_victims(self, adm) -> None:
        mask = (adm.evicted_keys >= 0) & adm.evicted_dirty
        for i in np.nonzero(mask)[0]:
            self.store.writeback(
                int(adm.evicted_keys[i]),
                {p: blk[i] for p, blk in adm.evicted_blocks.items()})

    # ------------------------------------------------------------ scheduling
    def schedule(self) -> List[Request]:
        """Pick up to ``max_batch`` requests whose pages are ALL resident;
        park the rest (sync mode blocks and stages instead of parking)."""
        self.absorb_completions()
        now = self.clock.now()
        if self._last_sched_t is not None and now > self._last_sched_t:
            # per-wave service estimate feeds the access-time predictions
            self.service_est = (0.8 * self.service_est
                                + 0.2 * min(now - self._last_sched_t, 0.25))
        batch: List[Request] = []
        for pos, req in enumerate(self.queue):
            if len(batch) >= self.max_batch:
                break
            hit, _ = self.arena.probe(req.page_keys,
                                      now_ts=np.full(len(req.page_keys), now,
                                                     np.float32),
                                      count=False)
            # hit-rate accounting: one access per page per SCHEDULING
            # ATTEMPT transition — ready counts its hits, the first failed
            # attempt counts the misses; re-polls of parked requests don't
            if bool(hit.all()):
                self.arena.count_access(len(req.page_keys), 0)
                req.state = "ready"
                batch.append(req)
                continue
            if req.state != "parked":
                self.arena.count_access(int(hit.sum()), int((~hit).sum()))
            missing = [int(k) for k in req.page_keys[~hit]]
            if self.mode == "sync":
                # on-demand staging blocks the scheduler: the makespan sits
                # on this (and every queued) request's critical path
                blocks, lat = self.store.fetch_sync(missing, now)
                self.clock.sleep(lat)
                now = self.clock.now()
                adm = self.arena.admit(
                    np.asarray(missing, np.int32),
                    np.full(len(missing), now, np.float32))
                self._writeback_victims(adm)
                self.arena.stage(adm.slots, self._collate(blocks))
                req.state = "ready"
                batch.append(req)
            elif pos < self._stage_window(req):
                # async: on-demand but non-blocking; prefetch already staged
                # at enqueue, so this covers pages evicted meanwhile and
                # requests that entered the timeliness window just now
                t_pred = self._predicted_access(now, pos)
                self.store.request_stage(missing, now,
                                         [t_pred] * len(missing))
                if req.state != "parked":
                    req.state = "parked"
                    self.parked_events += 1
        if batch:
            self._last_sched_t = now
        return batch

    # --------------------------------------------------------------- tokens
    def complete_token(self, req: Request,
                       dirty_keys: Optional[np.ndarray] = None) -> None:
        """One decode step finished for ``req``; pages it mutated in place
        are flagged dirty so eviction writes them back."""
        now = self.clock.now()
        req.tokens_done += 1
        self.metrics.record_token(req.rid, now)
        if dirty_keys is not None and len(dirty_keys):
            self.arena.mark_dirty(np.asarray(dirty_keys, np.int32))
        if req.tokens_done >= req.n_tokens:
            req.state = "done"
            self.metrics.record_done(req.rid, now)
            self.queue.remove(req)

    def wait_for_progress(self) -> bool:
        """Nothing schedulable: sleep until the next staging completion (the
        serving loop's idle edge).  Returns False when no I/O is in flight —
        the caller must submit work or stop."""
        if not self.store.in_flight:
            return False
        now = self.clock.now()
        ready = min(r for r, *_ in self.store.in_flight.values())
        self.clock.sleep(max(0.0, ready - now) + 1e-6)
        return True

    # ------------------------------------------------------------------ misc
    @property
    def pending(self) -> int:
        return len(self.queue)

    def drain_dirty(self) -> int:
        """Shutdown/checkpoint: push all dirty arena pages through the store
        write-back path and persist the host tier."""
        keys, blocks = self.arena.flush_dirty()
        for i, k in enumerate(keys):
            self.store.writeback(int(k),
                                 {p: blk[i] for p, blk in blocks.items()})
        return self.store.persist()

    def stats(self) -> Dict[str, float]:
        out = self.metrics.summary(self.arena, self.store)
        out["hints_emitted"] = self.hints_emitted
        out["parked_events"] = self.parked_events
        out["mode"] = self.mode
        return out
