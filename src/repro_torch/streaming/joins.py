"""Stream-stream joins with two-sided keyed prefetching (DESIGN.md §11).

Joins are where the paper's claim — future access keys are "frequently
known earlier in the query plan" — is strongest: a tuple on either input
names exactly the join key whose state the join operator will fetch, so
BOTH inputs can emit hints for the other side's keyed state long before
the tuple reaches the join.  Three pieces:

  * ``IntervalJoinOp`` — per-key DUAL state buffers (left/right entry
    lists) with event-time retention bounds.  A left entry at ``t`` can
    only match right tuples with ``ts ∈ [t + lo, t + hi]``, so its
    retention deadline is ``t + hi`` (symmetrically ``t − lo`` on the
    right); once the watermark passes a key's maximum live deadline the
    whole key expires — cache ``drop`` + backend ``delete``, never a
    write-back (Belady on interval ends, mirroring the window purge of
    §10).
  * ``WindowedJoinOp`` — co-grouped join panes keyed by ``WindowKey``:
    both sides accumulate into one pane per (key, window) and the join
    fires on watermark advance exactly like ``WindowedStatefulOp``
    (whose firing, late-data, purge, and migration machinery it inherits
    unchanged).
  * ``JoinLookaheadOp`` — the two-sided Hint Extractor: left tuples hint
    the state a future right probe will read and vice versa, carrying
    RETENTION-DEADLINE timestamps (interval joins) or window-fire
    deadlines (windowed joins, inherited from ``WindowedLookaheadOp``
    together with the fire-time burst prefetch).

All three run through the existing sync/async/prefetch/shard machinery:
hints route by shard ownership, misrouted messages forward one hop,
mid-migration traffic parks and replays, and the retention registry
migrates with its shard (§9).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from repro_torch.streaming.engine import HINT_COST, StatefulOp, _IOReq
from repro_torch.streaming.events import Hint, Tuple_
from repro_torch.streaming.windows import (WindowAssigner, WindowedLookaheadOp,
                                     WindowedStatefulOp)

LEFT, RIGHT = "L", "R"


class IntervalJoinOp(StatefulOp):
    """Event-time interval join on the keyed stateful machinery
    (DESIGN.md §11).

    Both inputs arrive on the ONE data edge as a tagged union (the shape
    a physical join takes after the keyed exchange merges its inputs);
    ``side_of(payload)`` recovers the side.  State per join key is a pair
    of entry buffers ``{"L": [(ts, payload), ...], "R": [...]}`` flowing
    through the inherited cache/backend paths, so a join-state read
    parks, prefetches, and migrates exactly like any keyed access.

    Matching: a left entry at ``t_l`` joins a right entry at ``t_r`` iff
    ``lo <= t_r - t_l <= hi`` (Flink interval-join semantics).  Each
    arriving tuple probes the OPPOSITE buffer, emits one output per match
    via ``join_fn(key, left_payload, right_payload)`` (None = no output),
    then appends its own entry — ``keep_fn(side, payload)`` can decline
    the append for pre-filtered build sides.

    Retention and expiry: a left entry is matchable until the watermark
    passes ``t_l + hi``, a right entry until ``t_r - lo``; the per-key
    registry tracks the MAXIMUM live deadline and ``on_watermark`` purges
    keys whose registry deadline (plus ``allowed_lateness``) fell behind
    — ``cache.drop`` + ``backend.delete``, no write-back (expired join
    state is dead, exactly like a fired pane, §10).  Entries inside a
    still-live key prune lazily at the next access.  Tuples whose OWN
    retention deadline is already behind the horizon drop as late;
    within the horizon they still match retained entries (late joins).

    Purge/I-O races: a purge while a fetch for the key is in flight
    marks the key in ``_purged``; the completion is then dropped and
    tuples parked on it count late (``_completion_dead`` /
    ``_on_dead_parked`` hooks).  A write-back already ISSUED at purge
    time may still land in the backend; the landed state is inert — the
    registry entry is gone and a reborn key prunes expired entries at
    first access (recorded deviation, §11).
    """

    def __init__(self, engine, name, parallelism,
                 side_of: Callable[[Any], Optional[str]],
                 join_fn: Callable[[Any, Any, Any], Any],
                 bounds: Tuple[float, float],
                 backend_model, cache_capacity: int,
                 allowed_lateness: float = 0.0,
                 keep_fn: Optional[Callable[[str, Any], bool]] = None,
                 out_size: int = 300, **kw):
        lo, hi = bounds
        if lo > hi:
            raise ValueError(f"need lo ({lo}) <= hi ({hi})")
        # a real (empty) dual-buffer default: a first-touch key's parked
        # resume must read as a hit, not as a second miss
        kw.setdefault("default_state", lambda k: {LEFT: [], RIGHT: []})
        super().__init__(engine, name, parallelism, None, backend_model,
                         cache_capacity, **kw)
        self.side_of = side_of
        self.join_fn = join_fn
        self.lo, self.hi = float(lo), float(hi)
        self.allowed_lateness = float(allowed_lateness)
        # hints behind watermark - lateness target droppable tuples'
        # state (StatefulOp._on_hint admission horizon)
        self.hint_lateness = float(allowed_lateness) + max(
            0.0, -self.lo) + max(0.0, self.hi)
        self.keep_fn = keep_fn
        self.out_size = out_size
        # key -> max live retention deadline, per subtask (purge index)
        self.retention: List[Dict[Any, float]] = \
            [dict() for _ in range(parallelism)]
        # keys purged with I/O possibly in flight: completions must not
        # resurrect them (cleared on key rebirth)
        self._purged: List[Set[Any]] = [set() for _ in range(parallelism)]
        self.joined = 0
        self.late_dropped = 0
        self.late_joins = 0
        self.keys_expired = 0
        self.entries_pruned = 0

    # ------------------------------------------------------------ retention
    def _entry_deadline(self, side: str, ts: float) -> float:
        """Last event time at which an entry on ``side`` can still match
        an on-time arrival on the other side (its interval end)."""
        return ts + self.hi if side == LEFT else ts - self.lo

    # ------------------------------------------------------------- data path
    def _on_data(self, sub: int, tup: Tuple_) -> float:
        side = self.side_of(tup.payload)
        if side not in (LEFT, RIGHT):
            return 5e-7                      # foreign record: ignore
        wm = self.wm[sub]
        if self._entry_deadline(side, tup.ts) + self.allowed_lateness < wm:
            self.late_dropped += 1           # beyond the lateness horizon
            return 5e-7
        self._purged[sub].discard(tup.key)   # key reborn: I/O valid again
        return super()._on_data(sub, tup)

    def _apply(self, sub: int, tup: Tuple_, state: Any) -> float:
        side = self.side_of(tup.payload)
        wm = self.wm[sub]
        d_own = self._entry_deadline(side, tup.ts)
        if d_own + self.allowed_lateness < wm:
            # parked across the horizon while its fetch was in flight:
            # its interval is closed, the match set unrecoverable
            self.late_dropped += 1
            self._trace_absorbed(tup.trace)
            return self.service_time
        horizon = wm - self.allowed_lateness
        # the state dict is owned exclusively by this subtask's cache/
        # backend pair, so it is mutated IN PLACE and re-marked dirty —
        # copy-on-write would rebuild the hot key's buffers per tuple
        st = state if state else {LEFT: [], RIGHT: []}
        # amortized in-key expiry: entries append in arrival order, so
        # the expired run is a prefix up to the out-of-orderness spread;
        # deeper stragglers are skipped at probe time and reclaimed when
        # the prefix reaches them
        for s in (LEFT, RIGHT):
            buf = st[s]
            i = 0
            while i < len(buf) and \
                    self._entry_deadline(s, buf[i][0]) < horizon:
                i += 1
            if i:
                del buf[:i]
                self.entries_pruned += i
        other = RIGHT if side == LEFT else LEFT
        late = tup.ts < wm                   # joining behind the watermark
        emitted = False
        for ts2, p2 in st[other]:
            if self._entry_deadline(other, ts2) < horizon:
                continue                     # straggler awaiting reclaim
            delta = (ts2 - tup.ts) if side == LEFT else (tup.ts - ts2)
            if self.lo <= delta <= self.hi:
                l, r = (tup.payload, p2) if side == LEFT else (p2,
                                                               tup.payload)
                payload = self.join_fn(tup.key, l, r)
                if payload is not None:
                    self.joined += 1
                    if late:
                        self.late_joins += 1
                    self.outputs += 1
                    emitted = True
                    self.emit(sub, Tuple_(tup.ts, tup.key, payload,
                                          self.out_size, tup.ingest_t,
                                          trace=tup.trace))
        if not emitted:
            self._trace_absorbed(tup.trace)  # probe matched nothing (yet)
        if self.keep_fn is None or self.keep_fn(side, tup.payload):
            st[side].append((tup.ts, tup.payload))
        # the registry learns the key even when keep_fn declines the
        # append: the read materialized (empty) state in cache/backend,
        # and only registered keys are ever purged
        reg = self.retention[sub]
        if d_own > reg.get(tup.key, float("-inf")):
            reg[tup.key] = d_own
        self._purged[sub].discard(tup.key)
        self.caches[sub].write(tup.key, st, tup.ts, size=self.state_size)
        self._io_kick(sub)                   # opportunistic write-back
        return self.service_time

    # --------------------------------------------------------------- expiry
    def on_watermark(self, sub: int, wm: float) -> None:
        set_clock = getattr(self.caches[sub], "set_clock", None)
        if set_clock is not None:
            set_clock(wm)
        horizon = wm - self.allowed_lateness
        reg = self.retention[sub]
        for key in [k for k, d in reg.items() if d < horizon]:
            del reg[key]
            self._purge_key(sub, key)

    def _purge_key(self, sub: int, key: Any) -> None:
        """Expire one join key outright: no write-back, no backend
        tombstone cost — the state can never be matched again (§11)."""
        self.caches[sub].drop(key)
        self.backends[sub].delete(key)
        self.keys_expired += 1
        self._purged[sub].add(key)

    # ------------------------------------------------------ purge/I-O races
    def _completion_dead(self, sub: int, req: _IOReq) -> bool:
        """A fetch (or write-back) completing for a key that expired while
        the I/O was in flight must be dropped, not resurrect dead join
        state.  Rebirth (``_on_data``/``_apply``) clears the mark first,
        so a re-opened key's I/O stays valid."""
        return req.key in self._purged[sub]

    def _on_dead_parked(self, sub: int, tup: Tuple_) -> None:
        self.late_dropped += 1

    # ------------------------------------------------------------- migration
    def migrate_shard(self, shard: int, dst_sub: int) -> None:
        """The retention registry and purge marks move with their shard
        (§9), so expiry keeps firing at the new owner and dead keys stay
        dead across the move."""
        plane = self.shards
        src = plane.owner[shard] if plane is not None else None
        super().migrate_shard(shard, dst_sub)
        if plane is None or src is None or src == dst_sub:
            return
        in_shard = lambda k: plane.shard_of(k) == shard
        reg, dreg = self.retention[src], self.retention[dst_sub]
        for key in [k for k in reg if in_shard(k)]:
            d = reg.pop(key)
            if d > dreg.get(key, float("-inf")):
                dreg[key] = d
        moving = {k for k in self._purged[src] if in_shard(k)}
        self._purged[src] -= moving
        self._purged[dst_sub] |= moving

    # ---------------------------------------------------- snapshot / restore
    def snapshot_extra(self, sub: int) -> Dict[str, Any]:
        """The retention registry and purge marks ride the snapshot
        (DESIGN.md §7): restored keys must keep their expiry deadlines
        (watermark purges resume where they left off) and dead keys must
        stay dead across a restore (§11)."""
        import copy
        out = super().snapshot_extra(sub) or {}
        out["retention"] = copy.deepcopy(self.retention[sub])
        out["purged"] = set(self._purged[sub])
        return out

    def restore_extra(self, sub: int, extra: Optional[dict]) -> None:
        super().restore_extra(sub, extra)
        if extra and "retention" in extra:
            self.retention[sub] = extra["retention"]
            self._purged[sub] = set(extra.get("purged", ()))

    def reset_volatile(self) -> None:
        super().reset_volatile()
        self.retention = [dict() for _ in range(self.parallelism)]
        self._purged = [set() for _ in range(self.parallelism)]

    # --------------------------------------------------------------- metrics
    def extra_metrics(self) -> Dict[str, Any]:
        return {"joined": self.joined, "late_dropped": self.late_dropped,
                "late_joins": self.late_joins,
                "keys_expired": self.keys_expired,
                "entries_pruned": self.entries_pruned,
                "live_keys": sum(len(r) for r in self.retention)}


class WindowedJoinOp(WindowedStatefulOp):
    """Co-grouped windowed join (DESIGN.md §11).

    Both sides of the join accumulate into ONE pane per (key, window) —
    ``{"L": [payloads], "R": [payloads]}`` keyed ``WindowKey(key, wid)``
    — and the join result is produced at window fire, when both sides
    are complete.  Everything else is inherited from
    ``WindowedStatefulOp`` (§10) unchanged: watermark-driven FIRE
    messages, allowed-lateness drop/update policies, fire-time purge
    with no write-back, shard migration of live-window registrations.

    ``join_fn(key, left_payloads, right_payloads)`` maps a fired pane to
    the output payload (None = no output, e.g. when a side is empty);
    one-sided panes are counted per side at fire time.
    """

    def __init__(self, engine, name, parallelism, assigner: WindowAssigner,
                 side_of: Callable[[Any], Optional[str]],
                 join_fn: Callable[[Any, List, List], Any],
                 backend_model, cache_capacity: int, **kw):
        self.side_of = side_of
        self.join_fn = join_fn
        self.joined = 0
        self.unmatched = {LEFT: 0, RIGHT: 0}
        super().__init__(engine, name, parallelism, assigner,
                         self._co_group, self._fire_join, backend_model,
                         cache_capacity, **kw)

    def _co_group(self, tup: Tuple_, acc: Any) -> Any:
        side = self.side_of(tup.payload)
        if side not in (LEFT, RIGHT):
            return acc
        # copy-on-write: WindowedStatefulOp only persists a NEW object
        new = {LEFT: list(acc[LEFT]), RIGHT: list(acc[RIGHT])} \
            if acc else {LEFT: [], RIGHT: []}
        new[side].append(tup.payload)
        return new

    def _fire_join(self, key: Any, wid: int, end: float, acc: Any) -> Any:
        if not acc:
            return None
        if not acc[LEFT] or not acc[RIGHT]:
            self.unmatched[RIGHT if acc[LEFT] else LEFT] += 1
            return None
        out = self.join_fn(key, acc[LEFT], acc[RIGHT])
        if out is not None:
            self.joined += 1
        return out

    def extra_metrics(self) -> Dict[str, Any]:
        out = super().extra_metrics()
        out.update({"joined": self.joined,
                    "unmatched_left": self.unmatched[LEFT],
                    "unmatched_right": self.unmatched[RIGHT]})
        return out


class JoinLookaheadOp(WindowedLookaheadOp):
    """Two-sided join Hint Extractor (DESIGN.md §11).

    Either input side names the join key the operator will access, so
    hints cross sides: a LEFT tuple pre-stages the state a future RIGHT
    probe will read and vice versa.  ``hint_sides`` restricts which
    input sides emit (the one-sided ablation: only the probe side
    hints); ``side_of``/``key_of`` recover side and join key per tuple.

    Timestamp semantics per join kind (``hint_ts_mode="deadline"``):

      * windowed (``assigner`` set) — per-pane WINDOW-FIRE deadline
        hints plus the fire-time burst prefetch, inherited from
        ``WindowedLookaheadOp`` (§10);
      * interval (``bounds`` set) — the entry's RETENTION DEADLINE
        (``ts + hi`` left, ``ts − lo`` right, §11) CAPPED at
        ``ts + probe_ahead``, the predicted FIRST cross-side probe time.
        The cap matters: ``Hint.ts`` is a predicted access timestamp,
        and an interval entry's retention deadline bounds its LAST
        possible access, not its next one — hinting the full retention
        would pin every build-side key for its whole matchable life and
        invert eviction priorities whenever the live key population
        exceeds capacity (§11).  Capped, a build-side hint stages the
        key's state just ahead of its first probes and protects it
        across the out-of-orderness slack; renewal by continuing
        probe-side hints keeps hot keys resident after that.

    ``hint_ts_mode="arrival"`` keeps the tuple's event timestamp on both
    sides (the timing ablation: accurate key, but a build-side hint ages
    out immediately under min-ts eviction instead of surviving until its
    first probe).
    """

    def __init__(self, engine, name, parallelism,
                 side_of: Callable[[Any], Optional[str]],
                 key_of: Callable, hint_sides=(LEFT, RIGHT),
                 assigner: Optional[WindowAssigner] = None,
                 bounds: Optional[Tuple[float, float]] = None,
                 fn=None, hint_ts_mode: str = "deadline",
                 burst_ahead: float = 0.0, allowed_lateness: float = 0.0,
                 probe_ahead: float = 0.0,
                 service_time: float = 10e-6,
                 cms_conf: Optional[dict] = None,
                 filter_conf: Optional[dict] = None):
        if (assigner is None) == (bounds is None):
            raise ValueError("exactly one of assigner (windowed) or "
                             "bounds (interval) must be set")
        if bounds is not None and hint_ts_mode == "deadline" \
                and probe_ahead <= 0:
            # probe_ahead == 0 silently collapses deadline hints to the
            # arrival ablation (ts = max(ts, min(d, ts + 0))); callers
            # must choose the protection horizon (build_query passes the
            # workload's out-of-orderness bound)
            raise ValueError("interval deadline hints need probe_ahead"
                             " > 0")
        super().__init__(engine, name, parallelism, assigner, key_of,
                         fn=fn, hint_ts_mode=hint_ts_mode,
                         burst_ahead=burst_ahead,
                         allowed_lateness=allowed_lateness,
                         service_time=service_time, cms_conf=cms_conf,
                         filter_conf=filter_conf)
        self.side_of = side_of
        self.hint_sides = tuple(hint_sides)
        self.bounds = bounds
        self.probe_ahead = float(probe_ahead)
        self.side_hints = {LEFT: 0, RIGHT: 0}
        self.side_suppressed = 0
        # per-subtask max integer join key seen (interval speculation):
        # entity ids in stream workloads grow monotonically (NEXMark
        # auction ids), so keys just ABOVE the frontier are the ones a
        # tuple has not named yet but is about to (DESIGN.md §13)
        self._spec_frontier = [-1] * parallelism

    def _emit_hints_for(self, sub: int, o: Tuple_) -> float:
        key = self.key_of(o)
        if key is None:
            return 0.0
        side = self.side_of(o.payload)
        if side not in self.hint_sides:
            self.side_suppressed += 1        # one-sided ablation
            return 0.0
        if self.assigner is not None:        # windowed: pane deadlines
            self.side_hints[side] += 1
            return self._hint_panes(sub, key, o.ts)
        lo, hi = self.bounds
        if self.hint_ts_mode == "deadline":
            d = o.ts + hi if side == LEFT else o.ts - lo
            # predicted FIRST probe, never beyond the retention deadline
            # and never behind the access itself (class docstring)
            ts = max(o.ts, min(d, o.ts + self.probe_ahead))
        else:
            ts = o.ts
        if self._admit(sub, key):
            self.side_hints[side] += 1
            self.emit_hint(sub, Hint(key, ts, origin=self.name))
        filt = self.filters[sub]
        if filt.speculative and isinstance(key, int) \
                and key > self._spec_frontier[sub]:
            # frontier speculation (class docstring frontier note, §13):
            # hint the next spec_width ids above the new frontier BEFORE
            # any tuple names them — their first probe lands soon after
            # this one's.  note_emit marks them resident so their
            # data-driven hints collapse into correct duplicates.  Fires
            # once per frontier advance, so the volume is bounded by the
            # distinct-key arrival rate, not the tuple rate.
            lo_k = max(key, self._spec_frontier[sub]) + 1
            self._spec_frontier[sub] = key + filt.spec_width
            spec_ts = o.ts + self.probe_ahead
            for nk in range(lo_k, key + filt.spec_width + 1):
                self.speculative_hints += 1
                filt.note_emit(nk, self.sim.t)
                self.emit_hint(sub, Hint(nk, spec_ts, origin=self.name))
        return HINT_COST

    def reset_volatile(self) -> None:
        super().reset_volatile()
        self._spec_frontier = [-1] * self.parallelism

    def extra_metrics(self) -> Dict[str, Any]:
        out = super().extra_metrics()
        out.update({"hints_left": self.side_hints[LEFT],
                    "hints_right": self.side_hints[RIGHT],
                    "side_suppressed": self.side_suppressed})
        return out
