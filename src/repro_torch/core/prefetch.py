"""Prefetching Manager + Prefetching Controller (paper §IV-A / §IV-C).

Engine-agnostic: all times are passed in, so the same logic drives the
discrete-event engine here and a wall-clock runtime on a real deployment.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.hints import HintsBuffer


def _pctl(samples: List[float], q: float) -> float:
    if not samples:
        return float("inf")
    return float(np.percentile(np.asarray(samples), q))


@dataclass
class LookaheadCandidate:
    op_id: str
    plan_pos: int          # position in the query plan (source=0, increasing)


class PrefetchingController:
    """Centralised (JobManager-side) component: keeps, per stateful operator,
    the ordered candidate lookaheads; activates prefetching on demand;
    discards candidates whose key distribution mismatches (paper keeps a 0%
    prefetch-miss threshold => discard current + everything upstream)."""

    def __init__(self, marker_interval: float = 0.100):
        self.candidates: Dict[str, List[LookaheadCandidate]] = {}
        self.active: Dict[str, Optional[str]] = {}
        self.marker_interval = marker_interval
        self.switch_log: List[Tuple[float, str, str, str]] = []

    def register(self, stateful_op: str,
                 candidates: List[LookaheadCandidate]) -> None:
        self.candidates[stateful_op] = sorted(candidates,
                                              key=lambda c: c.plan_pos)
        self.active[stateful_op] = None

    def activate(self, stateful_op: str, now: float = 0.0) -> Optional[str]:
        """First cache misses observed: start with the earliest candidate
        (maximum prefetch window; accuracy then adapts it)."""
        cands = self.candidates.get(stateful_op) or []
        if not cands:
            return None
        if self.active[stateful_op] is None:
            self.active[stateful_op] = cands[0].op_id
            self.switch_log.append((now, stateful_op, "activate",
                                    cands[0].op_id))
        return self.active[stateful_op]

    def report_mismatch(self, stateful_op: str, lookahead_id: str,
                        now: float) -> Optional[str]:
        """Discard the mismatching candidate and all upstream of it, switch
        to the next later one."""
        cands = self.candidates.get(stateful_op) or []
        idx = next((i for i, c in enumerate(cands)
                    if c.op_id == lookahead_id), None)
        if idx is None:
            return self.active.get(stateful_op)
        self.candidates[stateful_op] = cands[idx + 1:]
        new = self.candidates[stateful_op][0].op_id \
            if self.candidates[stateful_op] else None
        self.active[stateful_op] = new
        self.switch_log.append((now, stateful_op, "mismatch", new or "-"))
        return new

    def request_timing_switch(self, stateful_op: str, target_id: str,
                              now: float) -> Optional[str]:
        """Slack-driven move to a (possibly later) candidate; upstream
        candidates are kept (still accurate, just unnecessarily early)."""
        cands = self.candidates.get(stateful_op) or []
        if any(c.op_id == target_id for c in cands):
            if self.active[stateful_op] != target_id:
                self.active[stateful_op] = target_id
                self.switch_log.append((now, stateful_op, "timing",
                                        target_id))
        return self.active[stateful_op]


class PrefetchingManager:
    """Stateful-operator-side: handles hints, measures per-candidate slack
    G_i via markers, tracks state-access latency F and the prefetch-miss
    ratio, and asks the controller to re-select the lookahead."""

    def __init__(self, op_id: str, subtask: int,
                 controller: PrefetchingController,
                 gamma: float = 0.003, window: int = 256,
                 miss_threshold: float = 0.0, min_dwell: float = 2.0,
                 shared: Optional["PrefetchingManager"] = None):
        self.op_id = op_id
        self.subtask = subtask
        self.controller = controller
        self.gamma = gamma
        self.window = window
        self.miss_threshold = miss_threshold
        self.min_dwell = min_dwell
        self.hints = HintsBuffer()
        # adaptation statistics are SHARED across the subtasks of one
        # stateful operator (the decision is per-operator, paper §IV-A)
        if shared is not None:
            self.slack = shared.slack
            self.access_lat = shared.access_lat
            self._origin_base = shared._origin_base
            self._switch_state = shared._switch_state
        else:
            self.slack: Dict[str, List[float]] = {}
            self.access_lat: List[float] = []
            self._origin_base: Dict[str, Tuple[int, int]] = {}
            self._switch_state: Dict[str, float] = {"last_switch": -1e9}
        self._marker_hint_t: Dict[Tuple[int, str], float] = {}
        self.enabled = False
        self.hints_received = 0
        self.hints_late = 0
        self.hints_duplicate = 0
        self.prefetch_hits = 0
        # optional registry histogram mirroring record_access_latency
        # (DESIGN.md §12): the capped adaptation window stays the input
        # to `evaluate`, the sketch keeps the FULL distribution
        self.lat_hist = None

    # ------------------------------------------------------------ activation
    def on_cache_misses(self, now: float) -> Optional[str]:
        if not self.enabled:
            active = self.controller.activate(self.op_id, now)
            self.enabled = active is not None
            return active
        return self.controller.active.get(self.op_id)

    # ----------------------------------------------------------------- hints
    def on_hint(self, key: Any, access_ts: float, cache,
                watermark: Optional[float] = None,
                lateness: float = 0.0) -> bool:
        """Returns True if a fetch should be scheduled for this key.

        ``access_ts`` is the PREDICTED ACCESS TIMESTAMP of ``key`` in the
        clock domain the consumer's cache orders by — event time on the
        streaming engine (tuple event ts, or the window-fire deadline for
        windowed hints), predicted processing time on the serving
        scheduler.  See ``repro_torch.streaming.events.Hint``.  With an event-
        time ``watermark``, hints whose access time already fell behind
        ``watermark - lateness`` target state the operator will drop or
        has purged, so no fetch is scheduled.
        """
        self.hints_received += 1
        if watermark is not None and access_ts < watermark - lateness:
            self.hints_late += 1
            return False                      # late record: will be dropped
        if cache.contains(key):
            self.hints_duplicate += 1
            cache.renew(key, access_ts)
            return False
        if self.hints.pending(key):
            self.hints.add(key, access_ts)
            return False
        self.hints.add(key, access_ts)
        return True

    # --------------------------------------------------------------- markers
    def on_marker_hint(self, marker_id: int, lookahead_id: str,
                       now: float) -> None:
        self._marker_hint_t[(marker_id, lookahead_id)] = now

    def on_marker_data(self, marker_id: int, now: float) -> None:
        done = []
        for (mid, lid), t_hint in self._marker_hint_t.items():
            if mid == marker_id:
                self.slack.setdefault(lid, []).append(now - t_hint)
                if len(self.slack[lid]) > self.window:
                    del self.slack[lid][0]
            if mid <= marker_id:          # also drop stale older rounds
                done.append((mid, lid))
        for k in done:
            del self._marker_hint_t[k]

    def record_access_latency(self, lat: float) -> None:
        self.access_lat.append(lat)
        if len(self.access_lat) > self.window:
            del self.access_lat[0]
        if self.lat_hist is not None:
            self.lat_hist.observe(lat)

    # ------------------------------------------------------------ adaptation
    def evaluate(self, caches, now: float) -> Optional[str]:
        """Periodic (called once per operator on the shared stats):
        (1) mismatch detection — per-ORIGIN prefetch-miss ratio over the
        caches of all subtasks; the offending lookahead (and everything
        upstream of it) is discarded;
        (2) timing — pick the LATEST candidate whose p99 slack covers
        p99 state-access latency + gamma, with dwell-time hysteresis."""
        if not isinstance(caches, (list, tuple)):
            caches = [caches]
        active = self.controller.active.get(self.op_id)
        if not self.enabled or active is None:
            return active
        # ---- per-origin mismatch detection
        ins_by: Dict[str, int] = {}
        unused_by: Dict[str, int] = {}
        for c in caches:
            for org, n in getattr(c, "pf_ins_by_origin", {}).items():
                ins_by[org] = ins_by.get(org, 0) + n
            for org, n in getattr(c, "pf_unused_by_origin", {}).items():
                unused_by[org] = unused_by.get(org, 0) + n
        cands = self.controller.candidates.get(self.op_id) or []
        cand_ids = {c.op_id for c in cands}
        for org in list(ins_by):
            if org not in cand_ids:
                continue                          # already discarded
            base_i, base_u = self._origin_base.get(org, (0, 0))
            ins = ins_by[org] - base_i
            unused = unused_by.get(org, 0) - base_u
            if ins >= 64:
                self._origin_base[org] = (ins_by[org],
                                          unused_by.get(org, 0))
                if unused / max(1, ins) > self.miss_threshold:
                    return self.controller.report_mismatch(self.op_id, org,
                                                           now)
        # ---- timing selection (hysteresis + switching margin)
        if now - self._switch_state["last_switch"] < self.min_dwell:
            return active
        need = _pctl(self.access_lat, 99) + self.gamma
        pos = {c.op_id: c.plan_pos for c in cands}

        def ok(op_id, margin):
            g = self.slack.get(op_id)
            return bool(g and len(g) >= 10 and _pctl(g, 99) >= need * margin)

        best = None
        for c in cands:                          # sorted source -> latest
            # moving LATER requires 25% slack headroom (anti-flapping);
            # staying / moving earlier only requires meeting the bound
            margin = 1.25 if pos.get(c.op_id, 0) > pos.get(active, 0) else 1.0
            if ok(c.op_id, margin):
                best = c.op_id                   # latest wins (keep updating)
        if best is not None and best != active:
            self._switch_state["last_switch"] = now
            return self.controller.request_timing_switch(self.op_id, best,
                                                         now)
        return active
