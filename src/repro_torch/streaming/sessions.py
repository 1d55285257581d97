"""Session windows: data-driven gaps, pane MERGING, moving-deadline hints
(DESIGN.md §15).

Tumbling/sliding windows (windows.py) know their fire time the moment a
tuple is assigned; a SESSION window does not — every tuple extends its
session's end to ``ts + gap``, and a tuple landing between two sessions
MERGES them into one.  That makes sessions the honest adversary for the
paper's deadline-aware TAC: the fire deadline a hint promised keeps
moving, so the lookahead must RE-HINT on every extension/merge and the
cache must ``renew`` the pane's timestamp rather than trust the first
deadline it saw (core/tac.py).

Three pieces:

  * ``SessionWindowAssigner`` — per-key dynamic session registry logic.
    ``fold`` is the one canonical merge rule, shared verbatim by the
    stateful operator and the lookahead so both mirror the same session
    structure (lockstep hints).  Session ids are CANONICAL: the surviving
    ``wid`` is always derived from the earliest event timestamp in the
    session, so the final registry is independent of per-key arrival
    order — the property the chaos oracle (streaming/chaos.py) and the
    Hypothesis merge tests (tests/test_sessions.py) rely on.
  * ``SessionWindowedOp`` — pane state keyed ``WindowKey(key, wid)`` on
    the inherited keyed machinery.  A merge runs as a two-step protocol
    THROUGH that machinery (so pane reads park/prefetch exactly like any
    keyed access): the absorbed pane receives a ``_MergeDrain`` message
    that takes its accumulator and purges it, then self-delivers a
    ``_MergeAbsorb`` carrying the state into the surviving pane, where
    ``merge_fn`` combines the two accumulators.  A bridging tuple
    therefore never loses either side's state, even when one side is
    parked on a backend fetch mid-merge.  Sessions with absorbs still in
    flight (``pending > 0``) never fire; the settle re-arms the fire.
  * ``SessionLookaheadOp`` — mirrors the registry per key and emits
    deadline hints carrying the session's CURRENT end; on extension or
    merge it re-hints unconditionally (bypassing admission, like the
    fire burst) so a resident pane's TAC deadline is renewed in place.

Late tuples follow the windows.py policies: beyond the lateness horizon
they drop; inside it, ``update`` re-opens the fired session (Aion-style
late-side update) and the re-fired emit carries the refreshed
accumulator, while ``drop`` discards them.
"""
from __future__ import annotations

import heapq
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.streaming.engine import HINT_COST, StatefulOp, _IOReq
from repro_torch.streaming.events import Hint, Tuple_, WindowKey
from repro_torch.streaming.windows import (FIRE, WindowedLookaheadOp,
                                     WindowedStatefulOp)

# session ids quantize the creating event timestamp to microseconds: two
# distinct sessions of one key are separated by > gap >> 1µs, so ids
# never collide, and ``start_of`` inverts the id for horizon checks
_WID_SCALE = 1e6


class _MergeDrain:
    """Self-addressed message to an ABSORBED pane: take its accumulator,
    purge the pane, and forward the state to the surviving pane."""
    __slots__ = ("surv",)

    def __init__(self, surv: int):
        self.surv = surv

    def __repr__(self):
        return f"<DRAIN->{self.surv}>"


class _MergeAbsorb:
    """Self-addressed message to a SURVIVING pane: combine the absorbed
    pane's accumulator into its own via ``merge_fn``."""
    __slots__ = ("state",)

    def __init__(self, state: Any):
        self.state = state

    def __repr__(self):
        return f"<ABSORB {self.state!r}>"


def _new_session(ts: float, wid: int, gap: float) -> dict:
    return {"start": ts, "end": ts + gap, "wid": wid, "fired": False,
            "pending": 0, "fire_due": False}


class SessionWindowAssigner:
    """Data-driven session membership with a fixed inactivity ``gap``.

    A tuple at event time ``ts`` spans ``[ts, ts + gap)``; it joins every
    session that interval overlaps, merging them when it bridges more
    than one.  ``wid_of(ts)`` derives the session id from the earliest
    event timestamp, and ``fold`` keeps that canonical: when a tuple
    extends a session's start backwards, the EARLIER timestamp's id wins
    and the old pane is absorbed — so the final id of any session equals
    ``wid_of(min ts in the session)`` regardless of arrival order.
    """

    def __init__(self, gap: float):
        if gap <= 0:
            raise ValueError(f"need gap > 0, got {gap}")
        self.gap = gap

    def wid_of(self, ts: float) -> int:
        return int(math.floor(ts * _WID_SCALE + 0.5))

    def start_of(self, wid: int) -> float:
        return wid / _WID_SCALE

    def end(self, wid: int) -> float:
        """Minimal possible fire deadline of a session created at this
        id's timestamp (extensions only move the true end later).  Kept
        for WindowedStatefulOp API compatibility; the session registry
        holds the live end."""
        return self.start_of(wid) + self.gap

    def overlapping(self, sessions: List[dict], ts: float) -> List[dict]:
        hi = ts + self.gap
        return [s for s in sessions if ts < s["end"] and hi > s["start"]]

    def fold(self, sessions: List[dict], ts: float):
        """Fold one tuple into a key's session list (mutating it).

        Returns ``(sess, absorbed, extended, created)``: the surviving
        session, the sessions merged into it (removed from the list),
        whether the surviving end moved, and whether the survivor is a
        brand-new session dict.
        """
        ov = self.overlapping(sessions, ts)
        if not ov:
            s = _new_session(ts, self.wid_of(ts), self.gap)
            sessions.append(s)
            return s, [], True, True
        ov.sort(key=lambda s: (s["start"], s["wid"]))
        if ts < ov[0]["start"]:
            # the tuple PREDATES every overlapping session: the canonical
            # id belongs to it — a fresh session absorbs the rest
            surv = _new_session(ts, self.wid_of(ts), self.gap)
            sessions.append(surv)
            absorbed, created = ov, True
        else:
            surv, absorbed, created = ov[0], ov[1:], False
        old_end = surv["end"]
        surv["start"] = min(surv["start"], ts)
        surv["end"] = max([surv["end"], ts + self.gap]
                          + [a["end"] for a in absorbed])
        for a in absorbed:
            sessions.remove(a)
        return surv, absorbed, created or surv["end"] > old_end, created


class SessionWindowedOp(WindowedStatefulOp):
    """Keyed session-window aggregation with pane merging (DESIGN.md §15).

    ``merge_fn(a, b)`` combines two pane accumulators (either may be
    ``None``); it must be commutative/associative so the merged result is
    independent of merge order — the session-structure canonicalization
    (``SessionWindowAssigner.fold``) guarantees the same for ids.

    Fires are driven by a lazy per-subtask heap of ``(end, base, wid)``
    candidates pushed on every extension; stale entries (extended,
    absorbed, or already fired since) are skipped on pop, and a session
    with merge absorbs still in flight defers its fire until they settle.
    """

    def __init__(self, engine, name, parallelism,
                 assigner: SessionWindowAssigner,
                 agg_fn: Callable[[Tuple_, Any], Any],
                 emit_fn: Callable[[Any, int, float, Any], Any],
                 backend_model, cache_capacity: int,
                 merge_fn: Optional[Callable[[Any, Any], Any]] = None,
                 **kw):
        super().__init__(engine, name, parallelism, assigner, agg_fn,
                         emit_fn, backend_model, cache_capacity, **kw)
        if self.fused_spec is not None:
            raise ValueError("session windows have no fused plane: merge "
                             "re-keys panes mid-stream (DESIGN.md §15)")
        self.merge_fn = merge_fn or (lambda a, b: b if a is None else a)
        # base -> [session dict], per subtask (durable: rides snapshots)
        self.sess: List[Dict[Any, List[dict]]] = \
            [dict() for _ in range(parallelism)]
        # (base, absorbed wid) -> {"surv": wid, "drained": bool} — the
        # redirect map for in-flight pane traffic addressed to a merged-
        # away session (chain-resolved; entries are a few bytes each and
        # kept for the run — see _resolve)
        self.absorbed: List[Dict[Tuple[Any, int], dict]] = \
            [dict() for _ in range(parallelism)]
        self.fire_heap: List[List] = [[] for _ in range(parallelism)]
        self.purge_heap: List[List] = [[] for _ in range(parallelism)]
        self.sessions_created = 0
        self.sessions_merged = 0
        self.sessions_reopened = 0
        self.fires_superseded = 0
        self.fires_absorbed = 0
        self.merge_drains = 0
        self.merge_absorbs = 0

    # ----------------------------------------------------------- registry
    def _find(self, sub: int, base: Any, wid: int) -> Optional[dict]:
        for s in self.sess[sub].get(base, ()):
            if s["wid"] == wid:
                return s
        return None

    def _resolve(self, sub: int, wk: WindowKey) -> WindowKey:
        """Chain-resolve a pane key through the absorbed-redirect map so
        stale in-flight traffic (parked resumes, migration/recovery
        replays) lands on the surviving pane."""
        amap = self.absorbed[sub]
        wid = wk.wid
        seen = 0
        while (wk.base, wid) in amap:
            wid = amap[(wk.base, wid)]["surv"]
            seen += 1
            if seen > 64:                 # defensive: merges form a DAG
                break
        return wk if wid == wk.wid else WindowKey(wk.base, wid)

    def _arm_fire(self, sub: int, sess: dict, base: Any) -> None:
        heapq.heappush(self.fire_heap[sub],
                       (sess["end"], base, sess["wid"]))

    # ------------------------------------------------------------ data path
    def _on_data(self, sub: int, tup: Tuple_) -> float:
        if isinstance(tup.key, WindowKey):
            # pane-addressed traffic: merge protocol messages go straight
            # through; data/absorbs redirect if their pane was merged away
            if not isinstance(tup.payload, _MergeDrain) \
                    and tup.payload is not FIRE:
                wk = self._resolve(sub, tup.key)
                if wk is not tup.key:
                    tup = Tuple_(tup.ts, wk, tup.payload, tup.size,
                                 tup.ingest_t, trace=tup.trace)
            return StatefulOp._on_data(self, sub, tup)
        wm = self.wm[sub]
        base, ts = tup.key, tup.ts
        gap = self.assigner.gap
        sessions = self.sess[sub].setdefault(base, [])
        ov = self.assigner.overlapping(sessions, ts)
        if not ov and ts + gap + self.allowed_lateness < wm:
            self.late_dropped += 1        # beyond any horizon: unjoinable
            self._trace_absorbed(tup.trace)
            return 5e-7
        if self.late_policy == "drop" and any(s["fired"] for s in ov):
            self.late_dropped += 1        # would touch a fired session
            self._trace_absorbed(tup.trace)
            return 5e-7
        sess, absorbed, extended, created = self.assigner.fold(sessions, ts)
        if created:
            self.sessions_created += 1
        reopen = sess["fired"] or any(a["fired"] for a in absorbed)
        if reopen:
            # Aion-style late-side re-open: the refreshed session
            # re-fires at its (possibly extended) end
            sess["fired"] = False
            self.sessions_reopened += 1
        svc = 0.0
        for a in absorbed:
            self.sessions_merged += 1
            self.merge_drains += 1
            sess["pending"] += 1
            self.absorbed[sub][(base, a["wid"])] = {"surv": sess["wid"],
                                                    "drained": False}
            # two-step merge through the keyed machinery: drain the
            # absorbed pane (its read parks/prefetches like any access)
            self.deliver_batch(sub, [Tuple_(
                ts, WindowKey(base, a["wid"]), _MergeDrain(sess["wid"]),
                32, tup.ingest_t)])
        if extended or reopen:
            self._arm_fire(sub, sess, base)
        svc += StatefulOp._on_data(self, sub, Tuple_(
            ts, WindowKey(base, sess["wid"]), tup.payload, tup.size,
            tup.ingest_t, trace=tup.trace))
        return svc

    def _apply(self, sub: int, tup: Tuple_, state: Any) -> float:
        wk: WindowKey = tup.key
        base, wid = wk.base, wk.wid
        if isinstance(tup.payload, _MergeDrain):
            # absorbed pane: lift its accumulator, purge it, forward
            entry = self.absorbed[sub].get((base, wid))
            if entry is not None:
                entry["drained"] = True
            self.caches[sub].drop(wk)
            self.backends[sub].delete(wk)
            self.panes_purged += 1
            self.deliver_batch(sub, [Tuple_(
                tup.ts, WindowKey(base, tup.payload.surv),
                _MergeAbsorb(state), 32, tup.ingest_t)])
            return self.service_time
        if isinstance(tup.payload, _MergeAbsorb):
            self.merge_absorbs += 1
            acc = self.merge_fn(state, tup.payload.state)
            if acc is not state:
                self.caches[sub].write(wk, acc, tup.ts,
                                       size=self.state_size)
                self._io_kick(sub)
            sess = self._find(sub, base, wid)
            if sess is not None:
                sess["pending"] = max(0, sess["pending"] - 1)
                if sess["pending"] == 0 and not sess["fired"] \
                        and (sess["fire_due"] or sess["end"] <= self.wm[sub]):
                    # the fire this merge was holding back (the final
                    # flush watermark may already be behind us)
                    sess["fire_due"] = False
                    sess["fired"] = True
                    self.deliver_batch(sub, [Tuple_(
                        sess["end"], wk, FIRE, 32, self.sim.t)])
            return self.service_time
        if tup.payload is FIRE:
            sess = self._find(sub, base, wid)
            if sess is None:
                # merged away (or purged) after this FIRE was queued: the
                # surviving session carries the state and its own fire
                self.fires_absorbed += 1
                self._trace_absorbed(tup.trace)
                return self.service_time
            if sess["end"] > tup.ts or not sess["fired"]:
                # extended or re-opened since: a fresher heap entry fires
                self.fires_superseded += 1
                self._trace_absorbed(tup.trace)
                return self.service_time
            payload = self.emit_fn(base, wid, sess["end"], state)
            self.fires += 1
            if self.engine.record_events:
                self.engine.log_event("fire", op=self.name, wid=wid)
            if payload is not None:
                self.outputs += 1
                self.emit(sub, Tuple_(sess["end"], base, payload,
                                      self.out_size, tup.ingest_t,
                                      trace=tup.trace))
            if self.allowed_lateness == 0:
                self._purge_session(sub, base, sess)
            else:
                heapq.heappush(self.purge_heap[sub],
                               (sess["end"] + self.allowed_lateness,
                                base, wid))
            return self.service_time
        # plain pane data (possibly a redirected straggler)
        sess = self._find(sub, base, wid)
        if sess is None:
            wk2 = self._resolve(sub, wk)
            if wk2 is not wk:
                # the pane was merged away while this tuple sat queued or
                # parked (a fold removes the session synchronously): its
                # contribution belongs to the surviving pane — re-deliver
                # there instead of dropping it, or the count would depend
                # on I/O timing (the chaos oracle's nightmare)
                self.deliver_batch(sub, [Tuple_(
                    tup.ts, wk2, tup.payload, tup.size, tup.ingest_t,
                    trace=tup.trace)])
                return self.service_time
            # unregistered and not redirectable: the pane purged —
            # writing would resurrect dead state
            self.late_dropped += 1
            self._trace_absorbed(tup.trace)
            return self.service_time
        acc = self.agg_fn(tup, state)
        if acc is not state:
            self.caches[sub].write(wk, acc, tup.ts, size=self.state_size)
            self._io_kick(sub)
        self._trace_absorbed(tup.trace)   # folded into the pane
        return self.service_time

    # ---------------------------------------------------------------- firing
    def on_watermark(self, sub: int, wm: float) -> None:
        set_clock = getattr(self.caches[sub], "set_clock", None)
        if set_clock is not None:
            set_clock(wm)
        fire_batch = []
        just_fired = set()
        now = self.sim.t
        heap = self.fire_heap[sub]
        while heap and heap[0][0] <= wm:
            end, base, wid = heapq.heappop(heap)
            sess = self._find(sub, base, wid)
            if sess is None or sess["fired"] or sess["end"] != end:
                continue                  # stale candidate
            if sess["pending"]:
                sess["fire_due"] = True   # absorbs in flight: settle fires
                continue
            sess["fired"] = True
            just_fired.add((base, wid))
            fire_batch.append(Tuple_(end, WindowKey(base, wid), FIRE, 32,
                                     now))
        if fire_batch:
            self.deliver_batch(sub, fire_batch)
        pheap = self.purge_heap[sub]
        requeue = []
        while pheap and pheap[0][0] <= wm:
            due, base, wid = heapq.heappop(pheap)
            if (base, wid) in just_fired:
                # this pane's (re)fire was scheduled by THIS advance and
                # hasn't applied yet: purging now would drop the emit —
                # hold the entry for the next advance (windows.py keeps
                # its horizon purge one advance behind for the same race)
                requeue.append((due, base, wid))
                continue
            sess = self._find(sub, base, wid)
            if sess is not None and sess["fired"] \
                    and sess["end"] + self.allowed_lateness <= wm:
                self._purge_session(sub, base, sess)
        for item in requeue:
            heapq.heappush(pheap, item)

    def _purge_session(self, sub: int, base: Any, sess: dict) -> None:
        wk = WindowKey(base, sess["wid"])
        self.caches[sub].drop(wk)
        self.backends[sub].delete(wk)
        self.panes_purged += 1
        lst = self.sess[sub].get(base)
        if lst is not None:
            try:
                lst.remove(sess)
            except ValueError:
                pass
            if not lst:
                del self.sess[sub][base]

    # ----------------------------------------------------- purge/I-O races
    def _completion_dead(self, sub: int, req: _IOReq) -> bool:
        wk = req.key
        if not isinstance(wk, WindowKey):
            return False
        entry = self.absorbed[sub].get((wk.base, wk.wid))
        if entry is not None:
            # absorbed pane: completions stay LIVE until the drain took
            # its state (the drain may be parked on this very fetch);
            # after that the pane is purged and completions are dead
            return entry["drained"]
        if self._find(sub, wk.base, wk.wid) is not None:
            return False                  # registered and live
        # unregistered: a hint legitimately runs ahead of the first data
        # tuple, so only count the pane dead once even the EARLIEST
        # possible fire deadline of its creating timestamp is past the
        # lateness horizon
        return self.assigner.start_of(wk.wid) + self.assigner.gap \
            + self.allowed_lateness < self.wm[sub]

    # ------------------------------------------------------------- migration
    def migrate_shard(self, shard: int, dst_sub: int) -> None:
        plane = self.shards
        src = plane.owner[shard] if plane is not None else None
        super().migrate_shard(shard, dst_sub)
        if plane is None or src is None or src == dst_sub:
            return
        moving = [b for b in self.sess[src]
                  if plane.shard_of(b) == shard]
        for base in moving:
            sessions = self.sess[src].pop(base)
            self.sess[dst_sub].setdefault(base, []).extend(sessions)
            for s in sessions:
                # re-arm firing/purging at the new owner (the old owner's
                # heap entries go stale and skip on pop)
                if s["fired"]:
                    if self.allowed_lateness > 0:
                        heapq.heappush(
                            self.purge_heap[dst_sub],
                            (s["end"] + self.allowed_lateness, base,
                             s["wid"]))
                else:
                    heapq.heappush(self.fire_heap[dst_sub],
                                   (s["end"], base, s["wid"]))
        amap = self.absorbed[src]
        for k in [k for k in amap if plane.shard_of(k[0]) == shard]:
            self.absorbed[dst_sub][k] = amap.pop(k)

    # ---------------------------------------------------- snapshot / restore
    def snapshot_extra(self, sub: int) -> Dict[str, Any]:
        import copy
        out = super().snapshot_extra(sub) or {}
        out["sessions"] = copy.deepcopy(self.sess[sub])
        out["absorbed"] = copy.deepcopy(self.absorbed[sub])
        return out

    def restore_extra(self, sub: int, extra: Optional[dict]) -> None:
        super().restore_extra(sub, extra)
        if not extra or "sessions" not in extra:
            return
        self.sess[sub] = extra["sessions"]
        self.absorbed[sub] = extra.get("absorbed", {})
        # heaps are derived state: rebuild from the restored registry.
        # ``pending`` counts survive as snapshotted: each in-flight
        # drain/absorb rides the inflight capture exactly once (an
        # applied drain leaves the queue before its absorb enters), so
        # re-delivery decrements them back to zero.
        self.fire_heap[sub] = []
        self.purge_heap[sub] = []
        for base, sessions in self.sess[sub].items():
            for s in sessions:
                if s["fired"]:
                    if self.allowed_lateness > 0:
                        heapq.heappush(
                            self.purge_heap[sub],
                            (s["end"] + self.allowed_lateness, base,
                             s["wid"]))
                else:
                    heapq.heappush(self.fire_heap[sub],
                                   (s["end"], base, s["wid"]))

    def _snapshot_inflight(self, sub: int) -> List[Any]:
        out = StatefulOp._snapshot_inflight(self, sub)
        out.extend(t for t in self.queues[sub]
                   if isinstance(t, Tuple_)
                   and (t.payload is FIRE
                        or isinstance(t.payload, (_MergeDrain,
                                                  _MergeAbsorb))))
        return out

    def reset_volatile(self) -> None:
        super().reset_volatile()
        p = self.parallelism
        self.sess = [dict() for _ in range(p)]
        self.absorbed = [dict() for _ in range(p)]
        self.fire_heap = [[] for _ in range(p)]
        self.purge_heap = [[] for _ in range(p)]

    # --------------------------------------------------------------- metrics
    def extra_metrics(self) -> Dict[str, Any]:
        out = super().extra_metrics()
        out.update({
            "sessions_created": self.sessions_created,
            "sessions_merged": self.sessions_merged,
            "sessions_reopened": self.sessions_reopened,
            "fires_superseded": self.fires_superseded,
            "fires_absorbed": self.fires_absorbed,
            "merge_drains": self.merge_drains,
            "merge_absorbs": self.merge_absorbs,
            "live_sessions": sum(len(lst) for sub in self.sess
                                 for lst in sub.values()),
        })
        return out


class SessionLookaheadOp(WindowedLookaheadOp):
    """Session-window Hint Extractor with MOVING deadlines (DESIGN.md
    §15).

    Mirrors the downstream session registry per key via the SAME
    ``SessionWindowAssigner.fold`` (the edge into this operator and the
    edge out of it both partition by the session key, so both sides see
    each key's tuples in one FIFO order — lockstep).  Per tuple it emits
    a deadline hint for the surviving pane; when the tuple EXTENDS or
    MERGES the session, the hint bypasses admission/dedup entirely
    (``rehints``) so ``PrefetchingManager.on_hint`` renews the resident
    pane's TAC timestamp to the new deadline — the moving-deadline path.
    Near-fire sessions burst exactly like fixed windows.
    """

    def __init__(self, engine, name, parallelism,
                 assigner: SessionWindowAssigner, key_of: Callable,
                 fn=None, hint_ts_mode: str = "deadline",
                 burst_ahead: float = 0.0, allowed_lateness: float = 0.0,
                 service_time: float = 10e-6,
                 cms_conf: Optional[dict] = None,
                 filter_conf: Optional[dict] = None):
        super().__init__(engine, name, parallelism, assigner, key_of,
                         fn=fn, hint_ts_mode=hint_ts_mode,
                         burst_ahead=burst_ahead,
                         allowed_lateness=allowed_lateness,
                         service_time=service_time, cms_conf=cms_conf,
                         filter_conf=filter_conf)
        self.sess: List[Dict[Any, List[dict]]] = \
            [dict() for _ in range(parallelism)]
        self.rehints = 0

    def _emit_hints_for(self, sub: int, o: Tuple_) -> float:
        base = self.key_of(o)
        if base is None:
            return 0.0
        ts = o.ts
        wm = self.wm[sub]
        gap = self.assigner.gap
        if ts + gap + self.allowed_lateness < wm \
                and not self.assigner.overlapping(
                    self.sess[sub].get(base, ()), ts):
            return 0.0                    # dropped downstream anyway
        sessions = self.sess[sub].setdefault(base, [])
        sess, absorbed, extended, created = self.assigner.fold(sessions, ts)
        if extended and not created:
            sess["burst"] = False         # deadline moved: burst re-arms
        wk = WindowKey(base, sess["wid"])
        deadline = self.hint_ts_mode == "deadline"
        hint_ts = sess["end"] if deadline else ts
        svc = HINT_COST
        if created:
            if self._admit(sub, wk, freq_key=base):
                self.emit_hint(sub, Hint(wk, hint_ts, origin=self.name))
        elif extended or absorbed:
            # the deadline MOVED: re-hint unconditionally so a resident
            # pane is renewed in place (admission dedup would swallow it)
            self.rehints += 1
            self.emit_hint(sub, Hint(wk, hint_ts, origin=self.name))
        elif self._admit(sub, wk, freq_key=base):
            self.emit_hint(sub, Hint(wk, hint_ts, origin=self.name))
        return svc

    def on_watermark(self, sub: int, wm: float) -> None:
        if self.hint_ts_mode != "deadline":
            return
        horizon = wm + self.burst_ahead
        registry = self.sess[sub]
        for base in list(registry):
            sessions = registry[base]
            for s in list(sessions):
                if s["end"] + self.allowed_lateness < wm:
                    sessions.remove(s)    # closed downstream: forget it
                elif s["end"] <= horizon and not s.get("burst") \
                        and self.hint_active:
                    s["burst"] = True
                    self.burst_hints += 1
                    self.emit_hint(sub, Hint(WindowKey(base, s["wid"]),
                                             s["end"], origin=self.name))
            if not sessions:
                del registry[base]

    def reset_volatile(self) -> None:
        super().reset_volatile()
        self.sess = [dict() for _ in range(self.parallelism)]

    def extra_metrics(self) -> Dict[str, Any]:
        out = super().extra_metrics()
        out["rehints"] = self.rehints
        out["tracked_sessions"] = sum(len(lst) for sub in self.sess
                                      for lst in sub.values())
        return out
