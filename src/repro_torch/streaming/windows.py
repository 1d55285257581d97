"""Event-time windowed operators with watermark-driven keyed prefetching
(DESIGN.md §10).

Window panes are keyed state whose FUTURE ACCESS TIME is known exactly:
a pane keyed ``WindowKey(key, wid)`` is read when the watermark crosses
the window end.  That makes windows the sharpest consumer of the paper's
Timestamp-Aware Caching — hints carry the window-fire DEADLINE as their
access timestamp, so the TAC protects live panes until they fire and
ranks dead ones for eviction, and the upstream lookahead pre-stages every
live pane of a closing window right before the watermark crosses it
(fire-time burst prefetch).

Three pieces:

  * ``WindowAssigner`` — tumbling/sliding window membership by event time
    (tumbling is sliding with ``slide == size``).
  * ``WindowedStatefulOp`` — keys state by ``(key, window id)``, fires on
    watermark advance through the operator's normal keyed machinery (so
    fire-time state reads park/prefetch/queue exactly like tuple-time
    reads), and handles late tuples with a configurable allowed-lateness
    path: ``drop`` counts them, ``update`` re-aggregates and re-emits an
    updated result (late-side updates a la Aion).
  * ``WindowedLookaheadOp`` — the windowed Hint Extractor: per tuple it
    emits one hint per target pane with the chosen timestamp semantics
    (``deadline`` = window end, ``arrival`` = tuple event ts, the ablation
    baseline), and on watermark advance burst-emits deadline hints for all
    live panes of any window within ``burst_ahead`` of firing.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Set

import numpy as _np

from repro_torch.streaming.engine import HINT_COST, MapOp, StatefulOp, _IOReq
from repro_torch.streaming.events import Hint, Tuple_, WindowKey
from repro_torch.streaming.fused import Lane


class _Fire:
    """Sentinel payload of a self-addressed fire message.  Identity IS
    the semantics (``payload is FIRE``), so copies and pickles — snapshot
    capture of pending FIREs, DESIGN.md §7 — must resolve back to the
    singleton."""
    __slots__ = ()

    def __repr__(self):
        return "<FIRE>"

    def __copy__(self):
        return self

    def __deepcopy__(self, memo):
        return self

    def __reduce__(self):
        return (_fire_singleton, ())


FIRE = _Fire()


def _fire_singleton() -> _Fire:
    return FIRE


class WindowAssigner:
    """Tumbling/sliding event-time window membership (DESIGN.md §10).

    Window ``wid`` covers ``[wid * slide, wid * slide + size)``; a
    timestamp belongs to ``size / slide`` windows (1 for tumbling).
    """

    def __init__(self, size: float, slide: Optional[float] = None):
        slide = size if slide is None else slide
        if not 0 < slide <= size:
            raise ValueError(f"need 0 < slide ({slide}) <= size ({size})")
        self.size = size
        self.slide = slide

    def assign(self, ts: float) -> List[int]:
        wid = math.floor(ts / self.slide)
        out = []
        while wid * self.slide > ts - self.size:
            out.append(wid)
            wid -= 1
        return out

    def start(self, wid: int) -> float:
        return wid * self.slide

    def end(self, wid: int) -> float:
        return wid * self.slide + self.size


class WindowedStatefulOp(StatefulOp):
    """Keyed windowed aggregation on the stateful-operator machinery
    (DESIGN.md §10; the co-grouped windowed JOIN of §11 subclasses this
    with a two-sided pane accumulator).

    Each incoming tuple expands into one state access per target pane
    (``WindowKey(key, wid)``) and flows through the inherited sync/async/
    prefetch paths unchanged — so pane reads park, prefetch, and queue
    exactly like any keyed access, and the sharded plane (§9) guards,
    forwards, and migrates panes by their BASE key.

    Firing: when the subtask watermark crosses a window end, one FIRE
    message per live pane is self-delivered through the input queue; its
    state read goes through the same cache/backend path (a pane evicted
    before firing is refetched — synchronously in ``sync`` mode, via the
    I/O lanes otherwise), then ``emit_fn`` produces the result tuple with
    ``ingest_t`` = the fire-eligible time, so sink latency measures
    watermark-to-delivery.

    Late tuples (window end + ``allowed_lateness`` behind the watermark)
    are dropped and counted.  Tuples for a FIRED window still inside the
    lateness horizon follow ``late_policy``: ``drop`` discards them,
    ``update`` re-aggregates and immediately re-emits an updated result.
    Panes purge (cache drop + backend delete, no write-back) at fire time
    when lateness is zero, else when the horizon passes.
    """

    def __init__(self, engine, name, parallelism, assigner: WindowAssigner,
                 agg_fn: Callable[[Tuple_, Any], Any],
                 emit_fn: Callable[[Any, int, float, Any], Any],
                 backend_model, cache_capacity: int,
                 allowed_lateness: float = 0.0, late_policy: str = "drop",
                 out_size: int = 200, **kw):
        if late_policy not in ("drop", "update"):
            raise ValueError(f"late_policy {late_policy!r}")
        if late_policy == "update" and allowed_lateness <= 0:
            # with zero lateness a pane purges at fire time, so there is
            # no retained state for a late-side update to refresh
            raise ValueError("late_policy='update' needs allowed_lateness"
                             " > 0")
        kw.setdefault("default_state", lambda k: None)
        # pass deadline_aware=True (StatefulOp kwarg) when hints carry
        # fire deadlines: pane timestamps are then far-future access
        # times, where the paper's plain min-ts eviction would remove the
        # panes firing next (core/tac.py, DESIGN.md §10).  Arrival-ts
        # hint pipelines keep the default order — their timestamps are
        # recency, not deadlines.
        super().__init__(engine, name, parallelism, None, backend_model,
                         cache_capacity, **kw)
        self.hint_lateness = float(allowed_lateness)
        self.assigner = assigner
        self.agg_fn = agg_fn
        self.emit_fn = emit_fn
        self.allowed_lateness = float(allowed_lateness)
        self.late_policy = late_policy
        self.out_size = out_size
        # wid -> {"keys": live base keys, "fired": watermark crossed the
        # end, "fired_keys": keys whose FIRE was scheduled (or that
        # arrived late and must not fire)}, per subtask.  Fired state is
        # per KEY, not just per window: a migration can merge fired and
        # unfired pane populations of the same window when the source and
        # destination watermarks straddle its end.
        self.windows: List[Dict[int, dict]] = \
            [dict() for _ in range(parallelism)]
        self.fires = 0
        self.fires_lost = 0
        self.late_dropped = 0
        self.late_updates = 0
        self.panes_purged = 0

    # ------------------------------------------------------------- data path
    def _on_data(self, sub: int, tup: Tuple_) -> float:
        if isinstance(tup.key, WindowKey):
            # already a pane access: a migration replay or parked resume
            return super()._on_data(sub, tup)
        wm = self.wm[sub]
        svc, n = 0.0, 0
        for wid in self.assigner.assign(tup.ts):
            end = self.assigner.end(wid)
            if end + self.allowed_lateness < wm:
                self.late_dropped += 1          # beyond the lateness horizon
                continue
            meta = self.windows[sub].get(wid)
            if meta is not None and meta["fired"] \
                    and self.late_policy == "drop":
                self.late_dropped += 1          # fired, drop-policy
                continue
            if meta is None:
                meta = {"keys": set(), "fired": False,
                        "fired_keys": set()}
                self.windows[sub][wid] = meta
            meta["keys"].add(tup.key)
            if meta["fired"]:
                # late key joining a fired window (update policy): it
                # emits per-tuple updates, never a FIRE of its own
                meta["fired_keys"].add(tup.key)
            n += 1
            svc += super()._on_data(sub, Tuple_(
                tup.ts, WindowKey(tup.key, wid), tup.payload, tup.size,
                tup.ingest_t, trace=tup.trace))
        if not n:
            self._trace_absorbed(tup.trace)  # dropped before any pane
        return svc if n else 5e-7

    def _apply(self, sub: int, tup: Tuple_, state: Any) -> float:
        wk: WindowKey = tup.key
        if tup.payload is FIRE:
            end = self.assigner.end(wk.wid)
            payload = self.emit_fn(wk.base, wk.wid, end, state)
            self.fires += 1
            if self.engine.record_events:
                self.engine.log_event("fire", op=self.name, wid=wk.wid)
            if payload is not None:
                self.outputs += 1
                self.emit(sub, Tuple_(end, wk.base, payload, self.out_size,
                                      tup.ingest_t, trace=tup.trace))
            if self.allowed_lateness == 0:
                self._purge_pane(sub, wk)
            return self.service_time
        meta = self.windows[sub].get(wk.wid)
        if meta is not None and meta["fired"] and self.late_policy != \
                "update":
            # drop policy, yet the tuple reached _apply after the fire:
            # it parked on a state fetch across the window boundary, so
            # its contribution can no longer reach the fired result (and
            # writing would resurrect a purged pane)
            self.late_dropped += 1
            self._trace_absorbed(tup.trace)
            return self.service_time
        acc = self.agg_fn(tup, state)
        emitted = False
        if meta is not None and meta["fired"]:
            # late-side update: re-emit the refreshed result immediately
            self.late_updates += 1
            payload = self.emit_fn(wk.base, wk.wid,
                                   self.assigner.end(wk.wid), acc)
            if payload is not None:
                self.outputs += 1
                emitted = True
                self.emit(sub, Tuple_(tup.ts, wk.base, payload,
                                      self.out_size, tup.ingest_t,
                                      trace=tup.trace))
        if acc is not state:
            self.caches[sub].write(wk, acc, tup.ts, size=self.state_size)
            self._io_kick(sub)
        if not emitted:
            self._trace_absorbed(tup.trace)  # folded into the pane
        return self.service_time

    # ------------------------------------------------------ fused data path
    def _fused_prospect(self, sub: int, tup: Tuple_):
        if isinstance(tup.key, WindowKey):
            return (tup.key,), tup.payload is FIRE
        return (tuple(WindowKey(tup.key, wid)
                      for wid in self.assigner.assign(tup.ts)), False)

    def _fused_expand(self, sub: int, tup: Tuple_, keys=None):
        """Pane expansion for a fused batch, mirroring ``_on_data``: the
        lateness-horizon and fired-window checks run here (device lanes
        cannot re-check mid-batch; no watermark can interleave, so the
        decision is the same one ``_apply`` would take).  FIRE lanes ride
        as read-only lanes; tuples joining a fired window under the
        update policy become late-update lanes (§14).  ``keys`` reuses
        the prospect's WindowKeys so assignment runs once per tuple."""
        spec = self.fused_spec
        zeros = (0.0,) * spec.width
        if isinstance(tup.key, WindowKey):
            wk = tup.key
            if tup.payload is FIRE:
                return [Lane(wk, tup.ts, zeros, True, False, tup)]
            # replayed / re-delivered pane access (migration replay is
            # unreachable — fused excludes shards — but recovery
            # re-delivery lands here): take the fired checks now
            meta = self.windows[sub].get(wk.wid)
            if meta is not None and meta["fired"]:
                if self.late_policy != "update":
                    self.late_dropped += 1
                    self._trace_absorbed(tup.trace)
                    return []
                return [Lane(wk, tup.ts, spec.weight_raw(tup), False,
                             True, tup)]
            return [Lane(wk, tup.ts, spec.weight_raw(tup), False, False,
                         tup)]
        wm = self.wm[sub]
        out = []
        wks = keys if keys is not None \
            else tuple(WindowKey(tup.key, wid)
                       for wid in self.assigner.assign(tup.ts))
        w_raw = None
        for wk in wks:
            wid = wk.wid
            end = self.assigner.end(wid)
            if end + self.allowed_lateness < wm:
                self.late_dropped += 1          # beyond the horizon
                continue
            meta = self.windows[sub].get(wid)
            if meta is not None and meta["fired"] \
                    and self.late_policy == "drop":
                self.late_dropped += 1          # fired, drop-policy
                continue
            if meta is None:
                meta = {"keys": set(), "fired": False,
                        "fired_keys": set()}
                self.windows[sub][wid] = meta
            meta["keys"].add(tup.key)
            late = meta["fired"]
            if late:
                meta["fired_keys"].add(tup.key)
            if w_raw is None:
                w_raw = spec.weight_raw(tup)
            out.append(Lane(wk, tup.ts, w_raw, False, late, tup))
        if not out:
            self._trace_absorbed(tup.trace)     # dropped before any pane
        return out

    def _fused_fire(self, sub: int, lane: Lane, state: Any) -> None:
        """Device-hit FIRE lane: the pane value came back in the batch
        read — emit exactly like ``_apply``'s FIRE branch.  (A fire lane
        whose pane was evicted device-misses and parks/refetches through
        the interpreted path instead.)"""
        wk: WindowKey = lane.key
        end = self.assigner.end(wk.wid)
        payload = self.emit_fn(wk.base, wk.wid, end, state)
        self.fires += 1
        if self.engine.record_events:
            self.engine.log_event("fire", op=self.name, wid=wk.wid)
        if payload is not None:
            self.outputs += 1
            self.emit(sub, Tuple_(end, wk.base, payload, self.out_size,
                                  lane.tup.ingest_t, trace=lane.tup.trace))
        if self.allowed_lateness == 0:
            self._purge_pane(sub, wk)

    def _fused_late(self, sub: int, lane: Lane, acc: Any) -> None:
        """Device-hit late-update lane: the device already composed and
        wrote the refreshed accumulator; re-emit it (§10 update policy)."""
        wk: WindowKey = lane.key
        tup = lane.tup
        self.late_updates += 1
        payload = self.emit_fn(wk.base, wk.wid, self.assigner.end(wk.wid),
                               acc)
        if payload is not None:
            self.outputs += 1
            self.emit(sub, Tuple_(tup.ts, wk.base, payload, self.out_size,
                                  tup.ingest_t, trace=tup.trace))
        else:
            self._trace_absorbed(tup.trace)

    # ---------------------------------------------------------------- firing
    def on_watermark(self, sub: int, wm: float) -> None:
        set_clock = getattr(self.caches[sub], "set_clock", None)
        if set_clock is not None:
            # deadline_aware staleness boundary: panes whose fire deadline
            # is still ahead of the WATERMARK stay protected
            set_clock(wm)
        fire_batch = []
        now = self.sim.t
        for wid in sorted(self.windows[sub]):
            meta = self.windows[sub][wid]
            end = self.assigner.end(wid)
            to_fire = meta["keys"] - meta["fired_keys"] \
                if end <= wm else None
            if to_fire:
                # covers both the first crossing and unfired panes merged
                # in by a migration after this window already fired here
                meta["fired"] = True
                meta["fired_keys"] |= to_fire
                for base in to_fire:
                    fire_batch.append(Tuple_(end, WindowKey(base, wid),
                                             FIRE, 32, now))
            elif not meta["fired"] and end <= wm:
                meta["fired"] = True            # crossed with nothing live
            elif meta["fired"] and self.allowed_lateness > 0 \
                    and end + self.allowed_lateness < wm:
                # horizon purge stays one advance behind the fire so FIRE
                # messages scheduled above are never raced by their purge
                for base in list(meta["keys"]):
                    self._purge_pane(sub, WindowKey(base, wid))
        if fire_batch:
            self.deliver_batch(sub, fire_batch)

    def _purge_pane(self, sub: int, wk: WindowKey) -> None:
        self.caches[sub].drop(wk)
        self.backends[sub].delete(wk)
        self.panes_purged += 1
        meta = self.windows[sub].get(wk.wid)
        if meta is not None:
            meta["keys"].discard(wk.base)
            meta["fired_keys"].discard(wk.base)
            if not meta["keys"] and meta["fired"]:
                self.windows[sub].pop(wk.wid, None)

    # ----------------------------------------------------- purge/I-O races
    def _completion_dead(self, sub: int, req: _IOReq) -> bool:
        """A fetch or write-back completing for a pane that was PURGED
        while it was in flight must be dropped, not resurrect dead state
        in cache or backend.  A hint legitimately runs ahead of the first
        data tuple, so an unregistered pane only counts as dead once its
        window is past the lateness horizon."""
        wk = req.key
        if not isinstance(wk, WindowKey):
            return False
        meta = self.windows[sub].get(wk.wid)
        if meta is None:
            return self.assigner.end(wk.wid) + self.allowed_lateness \
                < self.wm[sub]
        return meta["fired"] and wk.base not in meta["keys"]

    def _on_dead_parked(self, sub: int, tup: Tuple_) -> None:
        if tup.payload is FIRE:
            # a FIRE that parked on a fetch and outlived the lateness
            # horizon: the pane is purged, its result unrecoverable —
            # record the loss instead of dropping it silently
            self.fires_lost += 1
        else:
            self.late_dropped += 1

    # ------------------------------------------------------------- migration
    def migrate_shard(self, shard: int, dst_sub: int) -> None:
        """Panes migrate with their shard (§9); the per-window live-key
        registrations must follow so fires happen at the new owner."""
        plane = self.shards
        src = plane.owner[shard] if plane is not None else None
        super().migrate_shard(shard, dst_sub)
        if plane is None or src is None or src == dst_sub:
            return
        for wid, meta in list(self.windows[src].items()):
            moving = {b for b in meta["keys"]
                      if plane.shard_of(b) == shard}
            if not moving:
                continue
            meta["keys"] -= moving
            dmeta = self.windows[dst_sub].get(wid)
            if dmeta is None:
                # the destination's OWN watermark decides when this
                # window counts as fired there; per-key fired state rides
                # along so the merge neither refires panes whose FIRE was
                # already scheduled at the source nor suppresses unfired
                # ones landing in a window the destination already fired
                dmeta = {"keys": set(), "fired": False,
                         "fired_keys": set()}
                self.windows[dst_sub][wid] = dmeta
            dmeta["keys"] |= moving
            dmeta["fired_keys"] |= moving & meta["fired_keys"]
            meta["fired_keys"] -= moving
            if not meta["keys"]:
                del self.windows[src][wid]

    # ---------------------------------------------------- snapshot / restore
    def snapshot_extra(self, sub: int) -> Dict[str, Any]:
        """The per-window live-key/fired registry rides the snapshot
        (DESIGN.md §7): restored panes must know which windows already
        fired (their replayed stragglers take the late path, §10) and
        which keys still await a FIRE."""
        import copy
        out = super().snapshot_extra(sub) or {}
        out["windows"] = copy.deepcopy(self.windows[sub])
        return out

    def restore_extra(self, sub: int, extra: Optional[dict]) -> None:
        super().restore_extra(sub, extra)
        if extra and "windows" in extra:
            self.windows[sub] = extra["windows"]

    def _snapshot_inflight(self, sub: int) -> List[Any]:
        """Pending FIRE messages join the in-flight capture: a FIRE
        scheduled by a pre-barrier watermark but not yet applied at the
        cut has already marked its key fired in the registry — without
        re-delivery the restored window would never emit (§10 ∩ §7)."""
        out = super()._snapshot_inflight(sub)
        out.extend(t for t in self.queues[sub]
                   if isinstance(t, Tuple_) and t.payload is FIRE)
        return out

    def reset_volatile(self) -> None:
        super().reset_volatile()
        self.windows = [dict() for _ in range(self.parallelism)]

    # --------------------------------------------------------------- metrics
    def extra_metrics(self) -> Dict[str, Any]:
        return {"fires": self.fires, "fires_lost": self.fires_lost,
                "late_dropped": self.late_dropped,
                "late_updates": self.late_updates,
                "panes_purged": self.panes_purged,
                "live_windows": sum(len(w) for w in self.windows)}


class WindowedLookaheadOp(MapOp):
    """Windowed Hint Extractor (DESIGN.md §10; the two-sided join
    lookahead of §11 subclasses this, reusing the pane-deadline and
    burst machinery for windowed joins).

    Per tuple: one hint per target pane, keyed ``WindowKey(key, wid)``.
    ``hint_ts_mode`` picks the hint's access-timestamp semantics:

      * ``deadline`` — the window-fire deadline (window end).  The TAC
        then holds live panes until they fire (a renew bumps a cached
        pane to its deadline) and the fire-time read hits.
      * ``arrival`` — the tuple's event timestamp (the per-tuple-hint
        semantics of non-windowed lookaheads; the ablation baseline —
        accurate in key, mistimed for fire-time reads).

    In ``deadline`` mode the operator also tracks the live key set per
    window and, when its watermark reaches ``end - burst_ahead``,
    burst-emits deadline hints for every live pane of that window —
    pre-staging evicted panes right before the downstream fire
    (CMS suppression is bypassed: the burst IS the timeliness path).
    """

    def __init__(self, engine, name, parallelism, assigner: WindowAssigner,
                 key_of: Callable, fn=None, hint_ts_mode: str = "deadline",
                 burst_ahead: float = 0.0, allowed_lateness: float = 0.0,
                 service_time: float = 10e-6, cms_conf: Optional[dict] = None,
                 filter_conf: Optional[dict] = None):
        if hint_ts_mode not in ("deadline", "arrival"):
            raise ValueError(f"hint_ts_mode {hint_ts_mode!r}")
        super().__init__(engine, name, parallelism, fn=fn,
                         service_time=service_time, key_of=key_of,
                         cms_conf=cms_conf, filter_conf=filter_conf)
        self.assigner = assigner
        self.hint_ts_mode = hint_ts_mode
        self.burst_ahead = burst_ahead
        self.allowed_lateness = float(allowed_lateness)
        self.win_keys: List[Dict[int, Set]] = \
            [dict() for _ in range(parallelism)]
        self._burst_done: List[Set[int]] = \
            [set() for _ in range(parallelism)]
        self.burst_hints = 0

    def _emit_hints_for(self, sub: int, o: Tuple_) -> float:
        # MapOp.process hook: one hint per target pane instead of one
        # per tuple
        base = self.key_of(o)
        if base is None:
            return 0.0
        return self._hint_panes(sub, base, o.ts)

    def _hint_panes(self, sub: int, base: Any, ts: float) -> float:
        svc = 0.0
        wm = self.wm[sub]
        deadline = self.hint_ts_mode == "deadline"
        for wid in self.assigner.assign(ts):
            end = self.assigner.end(wid)
            if end + self.allowed_lateness < wm:
                continue                   # late: dropped downstream anyway
            wk = WindowKey(base, wid)
            svc += HINT_COST
            # the pane key is hinted; the BASE key carries the frequency
            # (stable across panes — a pane key is new every window, so
            # counting it would never see a selective filter's cold/hot
            # signal).  "hot" mode ignores freq_key (legacy semantics).
            if self._admit(sub, wk, freq_key=base):
                self.emit_hint(sub, Hint(wk, end if deadline else ts,
                                         origin=self.name))
            if deadline:
                self.win_keys[sub].setdefault(wid, set()).add(base)
        return svc

    def on_watermark(self, sub: int, wm: float) -> None:
        if self.hint_ts_mode != "deadline":
            return
        horizon = wm + self.burst_ahead
        for wid in sorted(self.win_keys[sub]):
            end = self.assigner.end(wid)
            if end + self.allowed_lateness < wm:
                # window closed downstream: forget it
                del self.win_keys[sub][wid]
                self._burst_done[sub].discard(wid)
            elif end <= horizon and wid not in self._burst_done[sub] \
                    and self.hint_active:
                self._burst_done[sub].add(wid)
                filt = self.filters[sub]
                nxt = wid + 1
                nxt_end = self.assigner.end(nxt)
                for base in self.win_keys[sub][wid]:
                    self.burst_hints += 1
                    self.emit_hint(sub, Hint(WindowKey(base, wid), end,
                                             origin=self.name))
                    # speculative next-pane pre-hint (DESIGN.md §13): a
                    # base hot in THIS window is likely live in the next
                    # one — hint its next pane now, at watermark advance,
                    # before any of its tuples arrive.  note_emit marks
                    # it resident so the data-driven hint that follows is
                    # suppressed as a correct duplicate.  The pane is NOT
                    # added to win_keys: if no tuple ever materialises
                    # it, there is nothing to burst later.
                    if filt.speculate_ok(base):
                        self.speculative_hints += 1
                        wk_next = WindowKey(base, nxt)
                        filt.note_emit(wk_next, self.sim.t)
                        self.emit_hint(sub, Hint(wk_next, nxt_end,
                                                 origin=self.name))

    def reset_volatile(self) -> None:
        # live-key tracking and burst bookkeeping are process-local soft
        # state: replayed tuples rebuild them (DESIGN.md §7)
        super().reset_volatile()
        self.win_keys = [dict() for _ in range(self.parallelism)]
        self._burst_done = [set() for _ in range(self.parallelism)]

    def extra_metrics(self) -> Dict[str, Any]:
        out = super().extra_metrics()
        out.update({"burst_hints": self.burst_hints,
                    "tracked_windows": sum(len(w) for w in self.win_keys)})
        return out
