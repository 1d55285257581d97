# Copy of repro/streaming/engine.py; differs only in StatefulOp's `device` argument, handed to FusedPlane.
"""Tuple-at-a-time dataflow engine with a discrete-event clock.

Every policy data structure (TAC/LRU/Clock caches, CMS filter, hints buffer,
prefetch controller/manager) is the real implementation; the engine
simulates only TIME: operator service times, network buffering (size/timeout
flush like Flink's network stack), and state-backend latency with bounded
I/O parallelism.  This is how the paper's latency experiments are reproduced
deterministically on one CPU (DESIGN.md §2).
"""
from __future__ import annotations

import heapq
import itertools
from collections import defaultdict, deque

import numpy as np
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.hint_filter import HintFilter
from repro_torch.core.policies import ClockCache, LRUCache
from repro_torch.core.prefetch import (LookaheadCandidate, PrefetchingController,
                                 PrefetchingManager)
from repro_torch.core.tac import TimestampAwareCache
from repro_torch.obs import (HealthMonitor, MetricsRegistry, PrefetchRecorder,
                       QuantileSketch, Timeline, Tracer)
from repro_torch.runtime.compression import hint_batch_nbytes
from repro_torch.streaming.backend import BackendModel, StateBackend
from repro_torch.streaming.fused import FusedPlane, FusedSpec, Lane
from repro_torch.streaming.events import (CheckpointBarrier, Hint, Marker,
                                    Tuple_, Watermark)
from repro_torch.streaming.shards import (MIGRATE_BANDWIDTH, MIGRATE_RTT,
                                    ShardPlane, hash_partition)

# calibrated engine constants (documented in DESIGN.md §8)
NET_LATENCY = 150e-6              # per flushed buffer hop
NET_PER_MSG = 0.1e-6
FLUSH_OVERHEAD = 5e-6
BUFFER_BYTES = 8 * 1024           # Flink network buffer (low-latency gear)
BUFFER_TIMEOUT = 0.030            # 30 ms (paper §VI-e)
IO_ISSUE = 1.5e-6
HINT_COST = 0.5e-6                # extract + CMS update
HINT_TIMEOUT = 0.2e-3               # hint side channel flushes aggressively:
#                                   hints are tiny and latency-critical
ASYNC_RESUME = 4e-6               # async I/O completion handling per tuple
#                                   (paper §VI-A: thread/completion overheads)
FUSED_LAUNCH = 4e-6               # one fused device-program dispatch (§14)
FUSED_LANE = 0.3e-6               # per-lane share of a fused batch: the
#                                   interpreter's ~3µs/tuple collapses to
#                                   the kernel's per-element cost


class Sim:
    def __init__(self):
        self.t = 0.0
        self._heap: List = []
        self._seq = itertools.count()

    def at(self, t: float, fn: Callable, *args) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), fn, args))

    def after(self, delay: float, fn: Callable, *args) -> None:
        self.at(self.t + delay, fn, *args)

    def run_until(self, t_end: float) -> None:
        while self._heap and self._heap[0][0] <= t_end:
            t, _, fn, args = heapq.heappop(self._heap)
            self.t = t
            fn(*args)
        self.t = max(self.t, t_end)

    def purge(self, pred: Callable[[Tuple], bool]) -> int:
        """Drop scheduled events matching ``pred((t, seq, fn, args))`` —
        the failure-injection path (DESIGN.md §7) uses this to kill the
        dead incarnation's pending callbacks (service completions, I/O
        completions, source ticks) so they cannot fire into the restored
        state."""
        kept = [ev for ev in self._heap if not pred(ev)]
        n = len(self._heap) - len(kept)
        heapq.heapify(kept)
        self._heap = kept
        return n


class Channel:
    """One src_op -> dst_op edge with per-(src,dst)-subtask network buffers.

    Implements the Flink-style network stack of DESIGN.md §2: records
    accumulate in an 8 KiB buffer per subtask pair and flush on size or
    timeout (constants in §8).  ``kind`` distinguishes the data edge from
    the hint side channel (§3), which flushes on the much shorter
    ``HINT_TIMEOUT`` because hints are tiny and latency-critical.  The
    ``partition`` function picks the destination subtask per key — by
    default ``hash_partition``, or a ``ShardPlane`` router when the
    destination operator runs the sharded state plane (§9).  Control
    messages (markers, barriers) broadcast and flush immediately so they
    never reorder behind buffered records.
    """

    _ids = itertools.count()

    def __init__(self, sim: Sim, dst_op: "Operator", kind: str,
                 partition: Callable[[Any, int], int],
                 n_src: int, timeout: float = BUFFER_TIMEOUT,
                 codec: Optional[str] = None):
        self.sim = sim
        self.chan_id = next(Channel._ids)
        self.dst = dst_op
        self.kind = kind                  # data | hint
        self.partition = partition
        self.timeout = timeout
        # "delta" = per-flush delta compression of sorted key batches
        # (runtime/compression.py, DESIGN.md §13).  Affects byte
        # ACCOUNTING only: flush thresholds and the delay model keep
        # operating on raw sizes, so enabling the codec never perturbs
        # latency semantics — bytes_sent vs bytes_raw shows the saving.
        self.codec = codec
        # chaos hook (streaming/chaos.py, DESIGN.md §15): a fault
        # schedule may attach a ChannelChaos here to drop hints at send
        # time or stretch flush delays.  None (the default) keeps the
        # hot path to one attribute check; the FIFO arrival clamp below
        # makes any added delay ordering-safe.
        self.chaos = None
        self.bufs: Dict[Tuple[int, int], List] = defaultdict(list)
        self.buf_bytes: Dict[Tuple[int, int], int] = defaultdict(int)
        self.flush_scheduled: Dict[Tuple[int, int], bool] = defaultdict(bool)
        self.last_arrival: Dict[Tuple[int, int], float] = defaultdict(float)
        self.bytes_sent = 0
        self.bytes_raw = 0
        self.msgs_sent = 0

    def send(self, src_sub: int, msg: Any) -> None:
        if isinstance(msg, CheckpointBarrier):
            # barriers broadcast and flush like markers, but are tagged
            # with the (channel, src subtask) input they travelled on so
            # the destination can ALIGN across all its inputs (DESIGN.md
            # §7); flushing keeps each copy ordered behind the pre-barrier
            # records it covers
            for d in range(self.dst.parallelism):
                self.bufs[(src_sub, d)].append(
                    CheckpointBarrier(msg.checkpoint_id,
                                      origin=(self.chan_id, src_sub)))
                self._flush(src_sub, d)
            return
        if isinstance(msg, Marker):
            # control messages are broadcast and flush the buffer (order!)
            for d in range(self.dst.parallelism):
                self.bufs[(src_sub, d)].append(msg)
                self._flush(src_sub, d)
            return
        if isinstance(msg, Watermark):
            # watermarks broadcast like markers, tagged with the (channel,
            # src subtask) input they travelled on so the destination can
            # take the min across ALL its inputs (DESIGN.md §10); flushing
            # keeps them ordered behind the records they cover
            for d in range(self.dst.parallelism):
                self.bufs[(src_sub, d)].append(
                    Watermark(msg.ts, origin=(self.chan_id, src_sub)))
                self._flush(src_sub, d)
            return
        if self.chaos is not None and isinstance(msg, Hint) \
                and self.chaos.drop(msg):
            return                        # hint lost in transit (§15)
        key = getattr(msg, "key", None)
        d = self.partition(key, self.dst.parallelism)
        slot = (src_sub, d)
        self.bufs[slot].append(msg)
        self.buf_bytes[slot] += getattr(msg, "size", 64)
        if self.buf_bytes[slot] >= BUFFER_BYTES:
            self._flush(src_sub, d)
        elif not self.flush_scheduled[slot]:
            self.flush_scheduled[slot] = True
            self.sim.after(self.timeout, self._timeout_flush, src_sub, d)

    def _timeout_flush(self, s: int, d: int) -> None:
        self.flush_scheduled[(s, d)] = False
        if self.bufs[(s, d)]:
            self._flush(s, d)

    def _flush(self, s: int, d: int) -> None:
        batch = self.bufs[(s, d)]
        if not batch:
            return
        self.bufs[(s, d)] = []
        nbytes = self.buf_bytes[(s, d)]
        self.buf_bytes[(s, d)] = 0
        raw = nbytes + 8 * len(batch)
        self.bytes_raw += raw
        self.bytes_sent += self._wire_bytes(batch, raw)
        self.msgs_sent += len(batch)
        delay = NET_LATENCY + NET_PER_MSG * len(batch)
        if self.chaos is not None:
            delay += self.chaos.delay()
        # the per-message term makes a small batch faster than a LARGE
        # batch flushed just before it; a TCP-like channel never reorders,
        # so clamp arrival to per-(src,dst)-pair FIFO — watermarks and
        # checkpoint barriers (§7, §10) rely on never overtaking the
        # records they cover
        arrive = max(self.sim.t + delay, self.last_arrival[(s, d)])
        self.last_arrival[(s, d)] = arrive
        self.sim.at(arrive, self.dst.deliver_batch, d, batch,
                    (self.chan_id, s))

    def _wire_bytes(self, batch: List, raw: int) -> int:
        """Bytes this flush puts on the wire.  With the delta codec, the
        batch's hint keys ship as sorted delta streams plus an f32
        access timestamp each (``hint_batch_nbytes``); control messages
        and anything else keep their raw size."""
        if self.codec is None:
            return raw
        hint_keys = [m.key for m in batch if isinstance(m, Hint)]
        if not hint_keys:
            return raw
        other = sum(getattr(m, "size", 64) + 8 for m in batch
                    if not isinstance(m, Hint))
        return hint_batch_nbytes(hint_keys) + other


# hash_partition lives in repro_torch.streaming.shards (one canonical definition
# shared with the shard plane); re-exported here for existing callers.


class Operator:
    """Base dataflow operator (DESIGN.md §2).

    Each of ``parallelism`` subtasks pulls ONE message at a time from its
    input queue; ``handle`` returns the service time the discrete-event
    clock charges before the subtask takes the next message, so queueing
    delay emerges from the simulation rather than being modelled.  Parked
    messages resume through the higher-priority ``ready`` queue.  ``emit``
    fans out to every data edge, ``emit_hint`` to every hint side channel
    (§3); each channel routes per key.
    """

    def __init__(self, engine: "Engine", name: str, parallelism: int,
                 service_time: float = 2e-6):
        self.engine = engine
        self.sim = engine.sim
        self.name = name
        self.parallelism = parallelism
        self.service_time = service_time
        self.queues: List[deque] = [deque() for _ in range(parallelism)]
        self.ready: List[deque] = [deque() for _ in range(parallelism)]
        self.busy = [False] * parallelism
        self.busy_time = [0.0] * parallelism
        self.out_data: List[Channel] = []
        self.out_hint: List[Channel] = []
        self.plan_pos = 0
        self.processed = 0
        self._barrier_seen = set()
        # barrier alignment state (DESIGN.md §7): per-subtask active
        # alignment {epoch, arrived origins, buffered post-barrier msgs,
        # t0}; barrier_expected counts data-edge (channel, src subtask)
        # inputs, maintained by Engine.connect alongside wm_expected
        self._align: List[Optional[dict]] = [None] * parallelism
        self.barrier_expected = 0
        # event-time watermark state (DESIGN.md §10): per-subtask current
        # watermark, last value seen per input (channel, src subtask), and
        # the number of inputs that must report before the min is valid
        # (set by Engine.connect as data edges are wired)
        self.wm = [float("-inf")] * parallelism
        self._wm_in: List[Dict[Any, float]] = \
            [dict() for _ in range(parallelism)]
        self.wm_expected = 0

    def extra_metrics(self) -> Dict[str, Any]:
        """Operator-specific counters surfaced by ``Engine.metrics``
        under ``{name}_{key}``; subclasses extend via ``super()``."""
        return {}

    # ------------------------------------------------------------- plumbing
    def deliver_batch(self, sub: int, batch: List[Any],
                      origin: Any = None) -> None:
        """``origin`` identifies the (channel, src subtask) a network
        batch travelled on; engine-internal deliveries (self-addressed
        FIRE messages, shard forwarding, migration replay, recovery
        re-delivery) pass None and bypass barrier alignment."""
        if origin is not None and self.barrier_expected > 0 \
                and self.engine.barriers_active and (
                self._align[sub] is not None
                or any(isinstance(m, CheckpointBarrier) for m in batch)):
            # only pay the filter when checkpointing is in use AND an
            # alignment is open or a barrier is arriving — the common
            # no-checkpoint batch passes through untouched
            batch = self._align_filter(sub, batch, origin)
        if batch:
            self.queues[sub].extend(batch)
            self._kick(sub)

    def _align_filter(self, sub: int, batch: List[Any],
                      origin: Any) -> List[Any]:
        """Aligned-barrier protocol (DESIGN.md §7), run at delivery time.

        The first barrier copy of an epoch opens an alignment: from then
        on, messages from inputs whose barrier already arrived are
        POST-barrier and get buffered.  When the last expected input
        reports, an ``_AlignedBarrier`` sentinel is enqueued (behind all
        pre-barrier messages — channels are FIFO, so everything still in
        the queue is pre-barrier) followed by the buffered traffic.  One
        epoch aligns at a time; the coordinator never overlaps epochs."""
        out = []
        for msg in batch:
            al = self._align[sub]
            if isinstance(msg, CheckpointBarrier):
                if al is None:
                    al = self._align[sub] = {
                        "epoch": msg.checkpoint_id, "arrived": set(),
                        "buffer": [], "t0": self.sim.t}
                if origin in al["arrived"] \
                        or msg.checkpoint_id != al["epoch"]:
                    if origin in al["arrived"]:
                        # a NEWER epoch's barrier from an already-aligned
                        # input is post-barrier traffic: buffer it, and
                        # the reprocessing below opens its alignment once
                        # the current epoch completes (overlapping
                        # triggers must not wedge the subtask)
                        al["buffer"].append((origin, msg))
                    continue              # else: stale copy, drop
                al["arrived"].add(origin)
                if len(al["arrived"]) >= self.barrier_expected:
                    out.append(_AlignedBarrier(
                        al["epoch"], self.sim.t - al["t0"],
                        len(al["buffer"])))
                    buffered = al["buffer"]
                    self._align[sub] = None
                    # buffered traffic re-enters the filter: it may carry
                    # the NEXT epoch's barriers
                    for o, m in buffered:
                        out.extend(self._align_filter(sub, [m], o))
            elif al is not None and origin in al["arrived"]:
                al["buffer"].append((origin, msg))
            else:
                out.append(msg)
        return out

    def _kick(self, sub: int) -> None:
        if not self.busy[sub] and (self.ready[sub] or self.queues[sub]):
            self._start(sub)

    def _start(self, sub: int) -> None:
        if self.busy[sub]:
            return
        q = self.ready[sub] if self.ready[sub] else self.queues[sub]
        if not q:
            return
        msg = q.popleft()
        self.busy[sub] = True
        svc = self.handle(sub, msg)
        if svc is None:
            svc = self.service_time
        self.busy_time[sub] += svc
        self.sim.after(svc, self._finish, sub)

    def _finish(self, sub: int) -> None:
        self.busy[sub] = False
        self._kick(sub)

    def emit(self, sub: int, msg: Any) -> None:
        for ch in self.out_data:
            ch.send(sub, msg)

    def emit_hint(self, sub: int, msg: Any) -> None:
        for ch in self.out_hint:
            ch.send(sub, msg)

    # ----------------------------------------------------------- watermarks
    def _recv_watermark(self, sub: int, w: Watermark) -> None:
        """Min-of-inputs watermark propagation (DESIGN.md §10): the
        subtask's watermark advances only once every input (channel, src
        subtask) pair has reported, and then to the minimum across them."""
        cur = self._wm_in[sub].get(w.origin, float("-inf"))
        if w.ts > cur:
            self._wm_in[sub][w.origin] = w.ts
        if len(self._wm_in[sub]) < self.wm_expected:
            return
        new = min(self._wm_in[sub].values())
        if new > self.wm[sub]:
            self.wm[sub] = new
            self.on_watermark(sub, new)
            self.emit_watermark(sub, new)

    def on_watermark(self, sub: int, wm: float) -> None:
        """Hook: the subtask's event-time watermark advanced to ``wm``."""

    def emit_watermark(self, sub: int, wm: float) -> None:
        for ch in self.out_data:
            ch.send(sub, Watermark(wm))

    # ------------------------------------------------------------ behaviour
    def handle(self, sub: int, msg: Any) -> Optional[float]:
        if isinstance(msg, Watermark):
            self._recv_watermark(sub, msg)
            return 2e-7
        if isinstance(msg, Marker):
            self.on_marker(sub, msg)
            return 1e-7
        if isinstance(msg, _AlignedBarrier):
            return self._on_aligned_barrier(sub, msg)
        if isinstance(msg, CheckpointBarrier):
            # barriers normally complete at delivery time (_align_filter);
            # a barrier reaching handle() was injected without channel
            # origin — treat it as a single-input alignment
            if (msg.checkpoint_id, sub) in self._barrier_seen:
                return 1e-7
            self._barrier_seen.add((msg.checkpoint_id, sub))
            return self._on_aligned_barrier(
                sub, _AlignedBarrier(msg.checkpoint_id, 0.0, 0))
        self.processed += 1
        return self.process(sub, msg)

    # ----------------------------------------------------------- checkpoint
    def _on_aligned_barrier(self, sub: int, ab: _AlignedBarrier) -> float:
        """The subtask reached the epoch's consistent cut (DESIGN.md §7):
        snapshot local state, report to the engine/coordinator, forward
        the barrier downstream."""
        payload = self.snapshot_state(sub, ab.epoch)
        self.engine.on_snapshot(ab.epoch, self.name, sub, payload,
                                ab.stall, ab.buffered)
        self.emit(sub, CheckpointBarrier(ab.epoch))
        if payload is not None:
            return 1e-6 * max(1, payload.get("n_flushed", 0))
        return 1e-7

    def snapshot_state(self, sub: int, epoch: int) -> Optional[dict]:
        """Hook: return this subtask's durable snapshot payload (None for
        stateless operators — they only align and forward).  Stateless
        soft state (CMS counters, adaptation statistics) is deliberately
        NOT snapshotted: a recorded deviation, see DESIGN.md §7."""
        return None

    def restore_extra(self, sub: int, extra: Optional[dict]) -> None:
        """Hook: re-install operator-specific registries from a snapshot
        payload's ``extra`` block (window registries §10, join retention
        §11, shard-plane ownership §9)."""

    def reset_volatile(self) -> None:
        """Failure handling (DESIGN.md §7): discard everything a process
        crash would lose — queues, watermark state, alignment state.
        Subclasses drop caches, I/O lanes, and parked work on top."""
        for s in range(self.parallelism):
            self.queues[s].clear()
            self.ready[s].clear()
            self.busy[s] = False
        self.wm = [float("-inf")] * self.parallelism
        self._wm_in = [dict() for _ in range(self.parallelism)]
        self._align = [None] * self.parallelism
        self._barrier_seen.clear()

    def on_marker(self, sub: int, m: Marker) -> None:
        self.emit(sub, m)

    def process(self, sub: int, tup: Tuple_) -> Optional[float]:
        self.emit(sub, tup)
        return self.service_time


class MapOp(Operator):
    """Stateless transform; optionally a lookahead (Hint Extractor inside)."""

    def __init__(self, engine, name, parallelism, fn=None,
                 service_time=2e-6, key_of: Optional[Callable] = None,
                 cms_conf: Optional[dict] = None,
                 filter_conf: Optional[dict] = None):
        super().__init__(engine, name, parallelism, service_time)
        self.fn = fn
        self.key_of = key_of               # state-access key extractor
        self.hint_active = False
        if key_of is not None:
            # hint admission (DESIGN.md §13); cms_conf stays a separate
            # kwarg for existing callers and folds into the filter
            conf = dict(filter_conf or {})
            conf.setdefault("cms_conf", cms_conf)
            self.filters: Optional[List[HintFilter]] = [
                HintFilter(**conf) for _ in range(parallelism)]
        else:
            self.filters = None
        # bound by Engine.register_prefetching: the downstream stateful
        # operator's PrefetchRecorder, so suppression verdicts can be
        # graded against what the cache actually did next (§13)
        self.sink_recorder = None
        self.hints_emitted = 0
        self.hints_suppressed = 0
        self.speculative_hints = 0

    @property
    def cms(self):
        """Per-subtask CMS sketches (compat view over the filters)."""
        return [f.cms for f in self.filters] if self.filters else None

    def _admit(self, sub: int, key, freq_key=None) -> bool:
        """Run one hint through the subtask's HintFilter; True = emit.
        Suppressions report to the sink recorder for retroactive
        grading."""
        if self.filters[sub].admit(key, self.sim.t, freq_key):
            self.hints_emitted += 1
            return True
        self.hints_suppressed += 1
        if self.sink_recorder is not None:
            self.sink_recorder.on_suppressed(key)
        return False

    def on_marker(self, sub: int, m: Marker) -> None:
        # side-channel copy first: the hint path must never trail the data
        # copy of the same marker or slack would be measured against the
        # NEXT round's marker
        if self.key_of is not None:
            self.emit_hint(sub, Marker(m.marker_id, lookahead_id=self.name))
        self.emit(sub, m)

    def reset_volatile(self) -> None:
        super().reset_volatile()
        if self.filters is not None:
            # filter state (CMS counters, residency map, budget) is
            # process-local soft state: a crash loses it and admission
            # re-learns (DESIGN.md §7)
            for f in self.filters:
                f.reset()

    def _emit_hints_for(self, sub: int, o: Tuple_) -> float:
        """Hint Extractor for one output tuple; returns the extraction
        cost.  The windowed lookahead (streaming/windows.py) overrides
        this single hook to emit per-pane deadline hints."""
        k = self.key_of(o)
        if k is None:
            return 0.0
        if self._admit(sub, k):
            self.emit_hint(sub, Hint(k, o.ts, origin=self.name,
                                     emit_t=self.sim.t))
        return HINT_COST

    def extra_metrics(self) -> Dict[str, Any]:
        out = super().extra_metrics()
        if self.filters:
            agg: Dict[str, int] = {}
            for f in self.filters:
                for k, v in f.counters.items():
                    agg[k] = agg.get(k, 0) + v
            out["hint_filter"] = {"mode": self.filters[0].mode, **agg}
            out["speculative_hints"] = self.speculative_hints
        return out

    def process(self, sub: int, tup: Tuple_) -> Optional[float]:
        out = self.fn(tup) if self.fn else tup
        svc = self.service_time
        if out is None:
            return svc
        outs = out if isinstance(out, list) else [out]
        for o in outs:
            if tup.trace is not None and o.trace is None:
                o.trace = tup.trace        # sampled span rides derived tuples
            if self.hint_active and self.key_of is not None:
                svc += self._emit_hints_for(sub, o)
            self.emit(sub, o)
        return svc


class SourceOp(Operator):
    """Rate-driven source; generator yields (key, payload, size) or
    (key, payload, size, event_ts) for out-of-order event time.

    With ``watermark_interval`` > 0 the source runs a bounded-out-of-
    orderness watermark generator (DESIGN.md §10): every interval it
    emits ``Watermark(max emitted event ts - oo_bound)`` on its data
    edges — the promise that no tuple more than ``oo_bound`` behind the
    frontier will follow (the generator's late tail beyond the bound is
    exactly what the windowed late-data path handles).

    With ``replayable=True`` the source models a DURABLE LOG in front of
    the pipeline (a Kafka-style topic, DESIGN.md §7): the generator runs
    on a LOGICAL clock (one ``interval`` per record, so the record
    sequence is a pure function of position, independent of processing
    stalls), every record is appended to ``log``, and recovery can
    ``rewind`` a subtask to a checkpointed ``offset`` and replay —
    first draining the log at ``replay_speedup`` x the live rate
    (catch-up), then resuming live generation where the logical clock
    left off.  Event timestamps come from the record (or the logical
    clock), so a replayed stream carries the SAME event times and the
    event-time results are reproducible across a failure.
    """

    def __init__(self, engine, name, parallelism, rate: float, gen,
                 service_time=1e-6, watermark_interval: float = 0.0,
                 oo_bound: float = 0.0, replayable: bool = False):
        super().__init__(engine, name, parallelism, service_time)
        self.rate = rate
        self.gen = gen
        self.stopped = False
        # load-shift knob (streaming/chaos.py, DESIGN.md §15): scales the
        # WALL-CLOCK tick pacing only.  The logical clock still advances
        # one ``interval`` per record, so the record sequence — and with
        # it the durable log and every event timestamp — is identical at
        # any rate_scale; a load shift changes when records ARRIVE, never
        # what they say.
        self.rate_scale = 1.0
        self.watermark_interval = watermark_interval
        self.oo_bound = oo_bound
        self._max_ts = [float("-inf")] * parallelism
        # durable-log state (replayable mode, DESIGN.md §7)
        self.replayable = replayable
        self.log: List[List] = [[] for _ in range(parallelism)]
        self.log_base = [0] * parallelism      # offset of log[sub][0]
        self.replay_pos = [0] * parallelism    # next position to emit
        self.logical_t = [0.0] * parallelism
        self.replay_speedup = 1.0
        self.replayed = 0
        self.replay_done_t = [None] * parallelism
        self._interval = 1.0 / (rate / parallelism)

    def start(self) -> None:
        per = self.rate / self.parallelism
        self._interval = 1.0 / per
        for s in range(self.parallelism):
            self.sim.after(1.0 / per * (s + 1) / self.parallelism,
                           self._tick, s, 1.0 / per)
            if self.watermark_interval > 0:
                self.sim.after(self.watermark_interval * (s + 1)
                               / self.parallelism, self._wm_tick, s)

    def _emit_rec(self, sub: int, lt: float, rec) -> None:
        now = self.sim.t
        ts = rec[3] if len(rec) > 3 else (lt if self.replayable else now)
        tup = Tuple_(ts=ts, key=rec[0], payload=rec[1], size=rec[2],
                     ingest_t=now)
        tracer = self.engine.tracer
        if tracer.sample_every:            # span sampling (off by default)
            tup.trace = tracer.maybe_start(now)
        if ts > self._max_ts[sub]:
            self._max_ts[sub] = ts
        self.processed += 1
        self.busy_time[sub] += self.service_time
        self.emit(sub, tup)

    def _tick(self, sub: int, interval: float) -> None:
        if self.stopped:
            return
        if self.replayable:
            end = self.log_base[sub] + len(self.log[sub])
            if self.replay_pos[sub] < end:
                # catch-up: re-emit logged records at replay speed
                lt, rec = self.log[sub][self.replay_pos[sub]
                                        - self.log_base[sub]]
                self.replay_pos[sub] += 1
                self.replayed += 1
                self._emit_rec(sub, lt, rec)
                if self.replay_pos[sub] >= end:
                    self.replay_done_t[sub] = self.sim.t
                self.sim.after(interval / self.replay_speedup,
                               self._tick, sub, interval)
                return
            lt = self.logical_t[sub]
            self.logical_t[sub] = lt + interval
            rec = self.gen(lt)
            if rec is not None:
                self.log[sub].append((lt, rec))
                self.replay_pos[sub] = end + 1
                self._emit_rec(sub, lt, rec)
            self.sim.after(interval / self.rate_scale, self._tick, sub,
                           interval)
            return
        now = self.sim.t
        rec = self.gen(now)
        if rec is not None:
            self._emit_rec(sub, now, rec)
        self.sim.after(interval / self.rate_scale, self._tick, sub, interval)

    def _wm_tick(self, sub: int) -> None:
        if self.stopped:
            return
        if self._max_ts[sub] > float("-inf"):
            wm = self._max_ts[sub] - self.oo_bound
            if wm > self.wm[sub]:
                self.wm[sub] = wm
                self.emit_watermark(sub, wm)
        self.sim.after(self.watermark_interval, self._wm_tick, sub)

    # ------------------------------------------------- durable log / replay
    def offset(self, sub: int) -> int:
        """Checkpointed log position: the next record to emit (everything
        before it is pre-barrier at this source)."""
        return self.replay_pos[sub]

    def trim_log(self, sub: int, offset: int) -> None:
        """Reclaim log records no restore can need (before the last
        COMPLETED epoch's offset)."""
        cut = offset - self.log_base[sub]
        if cut > 0:
            del self.log[sub][:cut]
            self.log_base[sub] = offset

    def rewind(self, sub: int, offset: int) -> None:
        """Recovery (DESIGN.md §7): reset the emit cursor to a
        checkpointed offset.  Watermark state restarts from scratch —
        the replayed stream re-advances it."""
        if offset < self.log_base[sub]:
            raise ValueError(f"offset {offset} already trimmed "
                             f"(base {self.log_base[sub]})")
        self.replay_pos[sub] = offset
        self._max_ts[sub] = float("-inf")
        self.replay_done_t[sub] = None

    def resume(self, replay_speedup: float = 1.0) -> None:
        """Restart ticking after a failure: drain the log at
        ``replay_speedup`` x the live rate, then continue generating."""
        if not self.replayable:
            raise RuntimeError(f"{self.name} is not replayable")
        self.stopped = False
        self.replay_speedup = replay_speedup
        for s in range(self.parallelism):
            self.sim.after(self._interval * (s + 1) / self.parallelism,
                           self._tick, s, self._interval)
            if self.watermark_interval > 0:
                self.sim.after(self.watermark_interval * (s + 1)
                               / self.parallelism, self._wm_tick, s)


@dataclass
class _AlignedBarrier:
    """Engine-internal sentinel enqueued when the LAST expected barrier
    copy of an epoch is delivered to a subtask (DESIGN.md §7).  It sits
    in the input queue behind every pre-barrier message, so by the time
    it is handled all pre-barrier effects are applied — the consistent
    cut at which ``snapshot_state`` runs."""
    epoch: int
    stall: float              # first-to-last barrier-copy delivery time
    buffered: int             # post-barrier messages parked meanwhile


@dataclass
class _IOReq:
    kind: str            # read | prefetch | write
    key: Any
    hint_ts: float = 0.0
    entry: Any = None    # for writes
    origin: str = ""     # lookahead that triggered a prefetch


class StatefulOp(Operator):
    """Keyed stateful operator with pluggable cache policy and access mode.

    Implements the paper's three access modes (DESIGN.md §2): ``sync`` (a
    cache miss blocks the subtask for the full backend fetch), ``async``
    (a miss parks the tuple and the CPU moves on), and ``prefetch`` (async
    + Keyed Prefetching: upstream hints feed the TAC, §3).  Each subtask
    owns a cache, a backend partition, and a PrefetchingManager; I/O runs
    over ``io_workers`` bounded lanes (the state thread pool).

    With ``shards`` set, the operator joins the sharded state plane (§9):
    keyed messages are guarded by shard ownership — a message for a shard
    this subtask no longer owns is forwarded one hop to the owner, and a
    message for a shard whose state is still in transit parks until
    ``migrate_shard``'s re-admission completes.  Prefetch hits are
    additionally counted per shard.
    """

    def __init__(self, engine, name, parallelism, apply_fn,
                 backend_model: BackendModel, cache_capacity: int,
                 policy: str = "lru", mode: str = "sync",
                 io_workers: int = 4, state_size: int = 200,
                 service_time: float = 3e-6, read_only: bool = False,
                 default_state=None, gamma: float = 0.003,
                 miss_threshold: float = 0.0,
                 dense_backend: bool = False,
                 deadline_aware: bool = False,
                 shards: Optional[ShardPlane] = None,
                 fused: Optional[FusedSpec] = None,
                 fused_batch: int = 64, device: str = "cuda"):
        super().__init__(engine, name, parallelism, service_time)
        if shards is not None and shards.n_owners != parallelism:
            raise ValueError(f"ShardPlane has {shards.n_owners} owners for "
                             f"parallelism {parallelism}")
        # fused execution mode (DESIGN.md §14): the keyed plane lives on
        # device behind a FusedPlane and runs of data tuples batch into
        # one jitted program; all control-plane paths stay interpreted
        if fused is not None:
            if shards is not None:
                raise ValueError("fused mode runs on the unsharded plane")
            if policy != "tac":
                raise ValueError("fused mode requires policy='tac'")
        self.fused_spec = fused
        self.fused_batch = int(fused_batch)
        self.device = device
        self.shards = shards
        self.shard_pending: Dict[int, List[Any]] = {}
        self.apply_fn = apply_fn           # (tup, state) -> (state', outputs)
        self.mode = mode
        self.state_size = state_size
        self.read_only = read_only
        self.policy = policy
        self.cache_capacity = cache_capacity
        self.deadline_aware = deadline_aware
        self.caches = []
        self.backends = []
        self.managers: List[PrefetchingManager] = []
        for s in range(parallelism):
            self.caches.append(self._new_cache())
            self.backends.append(StateBackend(
                backend_model, default_factory=default_state,
                assume_present=dense_backend))
            self.managers.append(PrefetchingManager(
                name, s, engine.controller, gamma=gamma,
                miss_threshold=miss_threshold,
                shared=self.managers[0] if self.managers else None))
        # event-time lateness horizon for hint admission (windowed
        # subclasses widen it); with wm at -inf nothing is ever late
        self.hint_lateness = 0.0
        # prefetch-quality telemetry (DESIGN.md §12): one recorder for
        # all subtasks bridges TAC staged/used/wasted outcomes and the
        # I/O layer's late stagings into the metrics registry
        self.recorder = PrefetchRecorder(engine.registry,
                                         f"engine.{name}",
                                         lambda: engine.sim.t)
        self.access_hist = engine.registry.histogram(
            f"engine.{name}.access.latency")
        self.pf_demand = engine.registry.counter(
            f"engine.{name}.prefetch.demand_fetches")
        self._attach_obs()
        # first-park processing time per key: the "first need" timestamp
        # a late staging's negative lead time is measured against
        self._park_t: List[Dict[Any, float]] = \
            [dict() for _ in range(parallelism)]
        self.io_free = [io_workers] * parallelism
        self.io_q: List[deque] = [deque() for _ in range(parallelism)]
        self.waiting: List[Dict[Any, List[Tuple_]]] = \
            [defaultdict(list) for _ in range(parallelism)]
        self.in_flight: List[set] = [set() for _ in range(parallelism)]
        # memtable semantics for in-flight write-backs (DESIGN.md §3):
        # an entry popped for async write-back stays readable here until
        # its write LANDS — otherwise a concurrent fetch of the same key
        # reads the backend's stale copy and the in-flight updates are
        # lost (a real lost-update race; RocksDB's memtable is exactly
        # this shield)
        self.wb_pending: List[Dict[Any, Any]] = \
            [dict() for _ in range(parallelism)]
        self.io_workers = io_workers
        self.blocked_time = [0.0] * parallelism
        self.outputs = 0
        self.miss_reported = [False] * parallelism
        # hint WAL (DESIGN.md §7): hints are tiny (key + ts), so logging
        # them durably is cheap; on recovery the log for the replay
        # horizon is re-issued through the PrefetchingManager to warm the
        # cold cache before replayed data arrives.  Only populated when a
        # CheckpointCoordinator is attached (the coordinator trims it at
        # each completed epoch).
        self.hint_log: List[List] = [[] for _ in range(parallelism)]

    def _attach_obs(self) -> None:
        """Wire the recorder into every TAC and the access-latency
        histogram into every manager (re-run after reset_volatile
        recreates the caches)."""
        for c in self.caches:
            if isinstance(c, (TimestampAwareCache, FusedPlane)):
                c.recorder = self.recorder
        for m in self.managers:
            m.lat_hist = self.access_hist

    def _new_cache(self):
        if self.fused_spec is not None:
            return FusedPlane(self.cache_capacity,
                              entry_size=self.state_size,
                              spec=self.fused_spec,
                              deadline_aware=self.deadline_aware,
                              batch=self.fused_batch,
                              device=self.device)
        if self.policy == "tac":
            # deadline_aware: window panes carry far-future fire
            # deadlines, where plain min-ts eviction would remove the
            # panes firing next (core/tac.py, DESIGN.md §10)
            return TimestampAwareCache(self.cache_capacity,
                                       deadline_aware=self.deadline_aware)
        if self.policy == "clock":
            return ClockCache(self.cache_capacity)
        return LRUCache(self.cache_capacity)

    # ------------------------------------------------------------- messages
    def handle(self, sub: int, msg: Any) -> Optional[float]:
        if isinstance(msg, Watermark):
            self._recv_watermark(sub, msg)
            return 2e-7
        if self.shards is not None and \
                isinstance(msg, (Hint, Tuple_)) and msg.key is not None:
            routed = self._shard_guard(sub, msg)
            if routed is not None:
                return routed
        if isinstance(msg, Marker):
            if msg.lookahead_id is not None:      # via hint channel
                self.managers[sub].on_marker_hint(msg.marker_id,
                                                  msg.lookahead_id,
                                                  self.sim.t)
            else:
                self.managers[sub].on_marker_data(msg.marker_id, self.sim.t)
                self.emit(sub, msg)
            return 1e-7
        if isinstance(msg, (_AlignedBarrier, CheckpointBarrier)):
            # the aligned-barrier cut, snapshot, and forward live on the
            # base class; snapshot_state below adds the keyed payload
            return Operator.handle(self, sub, msg)
        if isinstance(msg, Hint):
            return self._on_hint(sub, msg)
        self.processed += 1
        return self._on_data(sub, msg)

    # ------------------------------------------------------- sharded plane
    def _shard_guard(self, sub: int, msg: Any) -> Optional[float]:
        """Ownership check for keyed messages on the sharded plane
        (DESIGN.md §9).  Returns the service time when the message was
        intercepted (forwarded or parked), None to process normally."""
        plane = self.shards
        shard = plane.shard_of(msg.key)
        owner = plane.owner[shard]
        if owner != sub:
            # in flight across an ownership flip: one extra hop (Megaphone
            # routes at the new owner; stale deliveries self-correct)
            plane.misroutes += 1
            self.sim.after(NET_LATENCY, self.deliver_batch, owner, [msg])
            return 0.2e-6
        if shard in plane.migrating:
            # state still in transit: park until re-admission, then replay
            plane.parked_in_migration += 1
            self.shard_pending.setdefault(shard, []).append(msg)
            return 0.2e-6
        return None

    def migrate_shard(self, shard: int, dst_sub: int) -> None:
        """Key-range migration (DESIGN.md §9, à la Megaphone): flip
        ownership (new traffic parks at ``dst_sub``), drain the source
        subtask's cache entries and backend partition for the shard, model
        the bulk state transfer, then re-admit at the destination with
        preserved timestamps and replay everything parked."""
        plane = self.shards
        if plane is None:
            raise RuntimeError(f"{self.name} has no ShardPlane")
        if not 0 <= shard < plane.n_shards:
            raise ValueError(f"shard {shard} out of range")
        src = plane.owner[shard]
        if src == dst_sub:
            return
        plane.begin_migration(shard, dst_sub)
        in_shard = lambda k: plane.shard_of(k) == shard
        entries = self.caches[src].export_entries(in_shard)
        # dirty entries whose write-back is STILL IN FLIGHT at the source
        # left the eviction buffer already, so the cache drain missed
        # them — their latest state must ride the migration too, or a
        # fetch at the destination racing the write-back reads the stale
        # backend copy (the cross-subtask face of the memtable race; the
        # in-flight write itself still lands at the destination backend,
        # idempotently, via the owner-directed write in _io_done)
        for key in [k for k in self.wb_pending[src] if in_shard(k)]:
            entries.append(self.wb_pending[src][key])
        # parked tuples whose fetch is still in flight at the source move
        # with the shard; their completions are dropped by the owner guard
        # in _io_done (the destination refetches on replay if needed)
        for key in [k for k in self.waiting[src] if in_shard(k)]:
            self.shard_pending.setdefault(shard, []).extend(
                self.waiting[src].pop(key))
        # likewise tuples already resumed into the ready queue but not yet
        # processed: they would otherwise run at the drained source
        keep = deque()
        for tup in self.ready[src]:
            if in_shard(tup.key):
                self.shard_pending.setdefault(shard, []).append(tup)
            else:
                keep.append(tup)
        self.ready[src] = keep
        # authoritative backend partition moves off the tuple path
        self.backends[dst_sub].import_keys(
            self.backends[src].export_keys(in_shard))
        nbytes = sum(e.size for e in entries)
        delay = MIGRATE_RTT + nbytes / MIGRATE_BANDWIDTH
        mig_id = next(self.engine._event_ids)
        self.engine.log_event("migrate_begin", id=mig_id, op=self.name,
                              shard=shard, src=src, dst=dst_sub,
                              bytes=nbytes)
        self.sim.after(delay, self._finish_migration, shard, dst_sub,
                       entries, mig_id)

    def _finish_migration(self, shard: int, dst_sub: int,
                          entries: List[Any],
                          mig_id: Optional[int] = None) -> None:
        # TAC entries keep their timestamps (a prefetched entry whose
        # hint ts lies in the future stays protected across the move);
        # LRU/Clock entries carry none and re-enter at migration time
        self.caches[dst_sub].import_entries(entries, now_ts=self.sim.t)
        self.shards.last_finish_t = self.sim.t
        self.shards.finish_migration(shard)
        self.engine.log_event("migrate_end", id=mig_id, shard=shard,
                              entries=len(entries))
        pending = self.shard_pending.pop(shard, [])
        if pending:
            self.deliver_batch(dst_sub, pending)

    def _on_hint(self, sub: int, h: Hint) -> float:
        mgr = self.managers[sub]
        if h.emit_t:
            # hint-channel delay: lookahead emit -> operator receive
            self.recorder.on_channel_delay(self.sim.t - h.emit_t)
        if self.engine.coordinator is not None:
            # hint WAL for prefetch-warmed recovery (DESIGN.md §7)
            self.hint_log[sub].append((self.sim.t, h.key, h.ts))
        # hints whose access ts fell behind the lateness horizon target
        # state the operator will drop or has purged (windowed, §10);
        # with no watermarks wm is -inf and the check never fires
        if mgr.on_hint(h.key, h.ts, self.caches[sub],
                       watermark=self.wm[sub],
                       lateness=self.hint_lateness):
            mgr.hints.take(h.key)         # unprocessed -> in-flight
            self._io_enqueue(sub, _IOReq("prefetch", h.key, h.ts,
                                         origin=h.origin))
        return 0.4e-6       # hash probe + buffer insert, no deserialization

    def _on_data(self, sub: int, tup: Tuple_) -> float:
        cache = self.caches[sub]
        tr = tup.trace
        if tr is not None:
            tr.mark_state(self.name, self.sim.t)
        state = cache.lookup(tup.key, tup.ts)
        if state is not None:
            if tr is not None and tr.hit is None:
                tr.hit = True
            if self.recorder.pending_suppressed:
                # grade a pending hint suppression for this key: the key
                # was resident, so the suppression was correct (§13)
                self.recorder.on_access(tup.key, hit=True)
            if self.mode == "prefetch":
                self.managers[sub].prefetch_hits += 1
                if self.shards is not None:
                    self.shards.prefetch_hits[
                        self.shards.shard_of(tup.key)] += 1
            return self._apply(sub, tup, state)
        wb = self.wb_pending[sub].get(tup.key)
        if wb is not None:
            # key's latest state rides an in-flight write-back: a backend
            # fetch would read STALE data — serve from the memtable
            if tr is not None and tr.hit is None:
                tr.hit = True
            if self.recorder.pending_suppressed:
                self.recorder.on_access(tup.key, hit=True)
            cache.insert(tup.key, wb.state, tup.ts, size=self.state_size)
            return self._apply(sub, tup, wb.state)
        # miss
        if tr is not None and tr.hit is None:
            tr.hit = False
        if self.recorder.pending_suppressed:
            # the suppressed hint would have prefetched this key:
            # incorrect suppression (it costs a demand fetch)
            self.recorder.on_access(tup.key, hit=False)
        if self.mode == "prefetch" and not self.managers[sub].enabled:
            la = self.managers[sub].on_cache_misses(self.sim.t)
            if la is not None:
                self.engine.set_lookahead(self.name, la)
        if self.mode == "sync":
            state, lat = self.backends[sub].fetch(tup.key, self.state_size)
            cache.insert(tup.key, state, tup.ts, size=self.state_size)
            self.managers[sub].record_access_latency(lat)
            self.blocked_time[sub] += lat
            self.pf_demand.inc()
            if tr is not None:
                tr.fetch_s += lat
            return lat + self._apply(sub, tup, state)
        # async / prefetch: park the tuple, fetch if not already in flight
        if tr is not None:
            tr.mark_park(self.sim.t)
        if tup.key not in self._park_t[sub]:
            self._park_t[sub][tup.key] = self.sim.t
        self.waiting[sub][tup.key].append(tup)
        if tup.key not in self.in_flight[sub]:
            self.pf_demand.inc()
            self._io_enqueue(sub, _IOReq("read", tup.key, tup.ts),
                             front=True)
        # completed-fetch scanning cost grows with outstanding async ops
        return IO_ISSUE * (1.0 + len(self.in_flight[sub]) / 32.0)

    # ------------------------------------------------------------------- IO
    def _io_enqueue(self, sub: int, req: _IOReq, front: bool = False) -> None:
        if req.kind in ("read", "prefetch"):
            if req.key in self.in_flight[sub]:
                return
            self.in_flight[sub].add(req.key)
        if front:
            self.io_q[sub].appendleft(req)
        else:
            self.io_q[sub].append(req)
        self._io_kick(sub)

    def _io_kick(self, sub: int) -> None:
        cache = self.caches[sub]
        while self.io_free[sub] > 0:
            if self.io_q[sub]:
                req = self.io_q[sub].popleft()
            else:
                wb = cache.pop_writeback()
                if wb is None:
                    return
                req = _IOReq("write", wb.key, entry=wb)
                self.wb_pending[sub][wb.key] = wb
            self.io_free[sub] -= 1
            if req.kind == "write":
                lat = self.backends[sub].latency(self.state_size)
            else:
                _, lat = self.backends[sub].peek_latency(req.key,
                                                         self.state_size)
            self.sim.after(lat, self._io_done, sub, req, lat)

    def _completion_dead(self, sub: int, req: _IOReq) -> bool:
        """Hook: True when the state this completion targets was PURGED
        while the I/O was in flight (fired window panes, §10) — the write
        or insert must not resurrect it.  Base operators never purge."""
        return False

    def _on_dead_parked(self, sub: int, tup: Tuple_) -> None:
        """Hook: a tuple parked on a key whose state was purged mid-fetch
        (windowed subclasses count it as late)."""

    def _io_done(self, sub: int, req: _IOReq, lat: float) -> None:
        self.io_free[sub] += 1
        cache = self.caches[sub]
        mgr = self.managers[sub]
        if req.kind == "write":
            pend = self.wb_pending[sub]
            if pend.get(req.key) is req.entry:
                del pend[req.key]         # memtable entry landed
            # a write-back in flight across a migration must land in the
            # CURRENT owner's partition (the shard's backend entries moved
            # at drain time and this lane still holds the latest state) —
            # unless the state was purged meanwhile (dead panes must not
            # be resurrected in the backend)
            if not self._completion_dead(sub, req):
                dst = sub if self.shards is None \
                    else self.shards.owner_of(req.key)
                self.backends[dst].write(req.key, req.entry.state,
                                         self.state_size)
        elif self.shards is not None and \
                self.shards.owner_of(req.key) != sub:
            # the shard migrated while this fetch was in flight: its cache
            # entries and waiting tuples already moved, so the completion
            # is dropped (the destination refetches on replay if needed)
            mgr.hints.complete(req.key)
            mgr.hints.discard(req.key)
            self.in_flight[sub].discard(req.key)
            self._park_t[sub].pop(req.key, None)
        elif self._completion_dead(sub, req):
            # the pane was purged while this fetch was in flight: drop
            # the completion, and anything parked on it is late
            mgr.hints.complete(req.key)
            mgr.hints.discard(req.key)
            self.in_flight[sub].discard(req.key)
            self._park_t[sub].pop(req.key, None)
            for tup in self.waiting[sub].pop(req.key, []):
                self._on_dead_parked(sub, tup)
        else:
            state, _ = self.backends[sub].fetch(req.key, self.state_size)
            wb = self.wb_pending[sub].get(req.key)
            if wb is not None:
                state = wb.state          # memtable is newer than backend
            hint_ts = mgr.hints.complete(req.key)
            mgr.hints.discard(req.key)    # clear any stale unprocessed entry
            self.in_flight[sub].discard(req.key)
            prefetched = req.kind == "prefetch"
            timely = prefetched and req.key not in self.waiting[sub]
            ts = hint_ts if hint_ts is not None else req.hint_ts
            cache.insert(req.key, state, ts, size=self.state_size,
                         prefetched=timely, origin=req.origin)
            if prefetched:
                self.recorder.on_stage_latency(lat)
                if not timely:
                    # a tuple parked on the key before staging completed:
                    # the hint was accurate but NOT timely — negative
                    # lead time against the first park
                    self.recorder.on_late(
                        self._park_t[sub].get(req.key, self.sim.t))
            if req.kind == "read" or req.key in self.waiting[sub]:
                mgr.record_access_latency(lat)
            # wake parked tuples
            parked = self.waiting[sub].pop(req.key, None)
            self._park_t[sub].pop(req.key, None)
            if parked:
                self.ready[sub].extend(parked)
                self._kick(sub)
        self._io_kick(sub)

    # ------------------------------------------------------------ computing
    def _apply(self, sub: int, tup: Tuple_, state: Any) -> float:
        # CONTRACT (DESIGN.md §7): an apply_fn that mutates state IN
        # PLACE and returns the SAME object skips the dirty-write below.
        # The live run stays consistent (cache and backend share the
        # object), but the key never re-enters a checkpoint delta, so a
        # restore would revert it.  Checkpointed jobs must either return
        # a new object (copy-on-write, as every shipped query does) or
        # write the mutated state back explicitly (as IntervalJoinOp
        # does, joins.py §11).
        new_state, outputs = self.apply_fn(tup, state)
        if not self.read_only and new_state is not state:
            self.caches[sub].write(tup.key, new_state, tup.ts,
                                   size=self.state_size)
            self._io_kick(sub)             # opportunistic write-back
        tr = tup.trace
        if tr is not None:
            tr.mark_apply(self.sim.t)
        for o in outputs:
            self.outputs += 1
            if tr is not None and getattr(o, "trace", None) is None:
                o.trace = tr
            self.emit(sub, o)
        if not outputs:
            self._trace_absorbed(tr)
        return self.service_time

    def _trace_absorbed(self, tr) -> None:
        """Finalize a sampled tuple CONSUMED into operator state with no
        1:1 output (windowed aggregation, unmatched join probe, late
        drop): its critical path ends at apply — a later window fire or
        join match is a different tuple's emission, not the tail of this
        one's span (DESIGN.md §12)."""
        if tr is not None:
            tr.mark_apply(self.sim.t)   # downstream = 0 for absorbed spans
            self.engine.tracer.finish(tr, self.sim.t)

    def handle_parked(self, sub: int, tup: Tuple_) -> float:
        tr = tup.trace
        if tr is not None:
            tr.mark_resume(self.sim.t)
        state = self.caches[sub].lookup(tup.key, tup.ts)
        refetch = 0.0
        if state is None:
            wb = self.wb_pending[sub].get(tup.key)
            if wb is not None:              # memtable shield (see __init__)
                self.caches[sub].insert(tup.key, wb.state, tup.ts,
                                        size=self.state_size)
                return ASYNC_RESUME + self._apply(sub, tup, wb.state)
        if state is None:                   # evicted before processing:
            # the refetch is synchronous on the tuple path, so it is charged
            # at full backend latency (presence-aware, like the sync path)
            state, refetch = self.backends[sub].fetch(tup.key,
                                                      self.state_size)
            self.caches[sub].insert(tup.key, state, tup.ts,
                                    size=self.state_size)
            self.managers[sub].record_access_latency(refetch)
            self.blocked_time[sub] += refetch
            self.pf_demand.inc()
            if tr is not None:
                tr.fetch_s += refetch
        return ASYNC_RESUME + refetch + self._apply(sub, tup, state)

    def _start(self, sub: int) -> None:
        # parked tuples resume through the ready queue with full processing
        if self.busy[sub]:
            return
        if self.ready[sub]:
            tup = self.ready[sub].popleft()
            self.busy[sub] = True
            # resumed tuples bypass handle(), so the shard-ownership guard
            # must run here too (the shard may have migrated in between)
            svc = None
            if self.shards is not None:
                svc = self._shard_guard(sub, tup)
            if svc is None:
                svc = self.handle_parked(sub, tup)
            self.busy_time[sub] += svc
            self.sim.after(svc, self._finish, sub)
            return
        if self.fused_spec is not None and self.queues[sub] \
                and isinstance(self.queues[sub][0], Tuple_):
            # fused hot path (DESIGN.md §14): the head RUN of data tuples
            # becomes one fixed-width device batch; control messages
            # (watermarks, hints, barriers, markers) stay on the
            # interpreted path above and naturally fence batches
            self.busy[sub] = True
            svc = self._fused_drain(sub)
            self.busy_time[sub] += svc
            self.sim.after(svc, self._finish, sub)
            return
        super()._start(sub)

    # ------------------------------------------------------ fused data path
    def _fused_prospect(self, sub: int, tup: Tuple_):
        """PURE preview of the state keys ``tup`` will touch and whether
        it is a window fire — drives the batch conflict check (a fire
        and an update of the same key never share a batch, §14)."""
        return (tup.key,), False

    def _fused_expand(self, sub: int, tup: Tuple_,
                      keys=None) -> List[Lane]:
        """Turn one dequeued tuple into device lanes (``keys`` is the
        prospect's precomputed key tuple, so expansion never redoes the
        window assignment).  Windowed subclasses expand to panes and
        take the late checks here — mirroring their ``_on_data``
        expansion."""
        return [Lane(tup.key, tup.ts, self.fused_spec.weight_raw(tup),
                     False, False, tup)]

    def _fused_fire(self, sub: int, lane: Lane, state: Any) -> None:
        raise RuntimeError("fire lane on a non-windowed operator")

    def _fused_late(self, sub: int, lane: Lane, state: Any) -> None:
        raise RuntimeError("late-update lane on a non-windowed operator")

    def _fused_lane_tuple(self, lane: Lane) -> Tuple_:
        """The tuple a lane parks/applies as: the source tuple itself,
        or (windowed) a pane-keyed copy — identical to the expansion the
        interpreted ``_on_data`` would have built."""
        tup = lane.tup
        if lane.key is tup.key or lane.key == tup.key:
            return tup
        return Tuple_(tup.ts, lane.key, tup.payload, tup.size,
                      tup.ingest_t, trace=tup.trace)

    def _fused_drain(self, sub: int) -> float:
        """Assemble one batch from the head run of data tuples, then run
        it through the device plane (§14).  Assembly stops at the batch
        width, at the first non-data message, or at a fire/update
        conflict (the conflicting tuple waits for the next batch, which
        preserves sequential per-key semantics)."""
        q = self.queues[sub]
        B = self.fused_batch
        lanes: List[Lane] = []
        fire_keys: set = set()
        upd_keys: set = set()
        n_tuples = 0
        while q and isinstance(q[0], Tuple_):
            tup = q[0]
            keys, is_fire = self._fused_prospect(sub, tup)
            fence = upd_keys if is_fire else fire_keys
            if fence and any(k in fence for k in keys):
                break
            if lanes and len(lanes) + len(keys) > B:
                break
            q.popleft()
            n_tuples += 1
            self.processed += 1
            new = self._fused_expand(sub, tup, keys)
            for ln in new:
                (fire_keys if ln.fire else upd_keys).add(ln.key)
            lanes.extend(new)
            if len(lanes) >= B:
                break
        svc = 5e-7 * n_tuples           # dequeue + expand, per tuple
        # a single tuple expanding wider than the batch runs chunked —
        # in-order chunks of one drain preserve per-key sequencing
        for i in range(0, len(lanes), B):
            svc += self._fused_step(sub, lanes[i:i + B])
        return svc

    def _fused_step(self, sub: int, lanes: List[Lane]) -> float:
        """One device batch + host post-step.  Device-HIT lanes finished
        on device (state read/updated/written back in the jitted
        program); every other lane is re-adjudicated IN LANE ORDER
        through the interpreted cold paths (eviction-buffer restores,
        memtable shield, sync refetch or parking) so counters, emits,
        and state stay sequential-equivalent (§14)."""
        plane = self.caches[sub]
        mgr = self.managers[sub]
        spec = self.fused_spec
        n = len(lanes)
        res = plane.batch_step(lanes)
        svc = FUSED_LAUNCH + FUSED_LANE * n
        if self.mode == "prefetch":
            mgr.prefetch_hits += int(res.hit.sum())
        # vectorized fast path: a PLAIN hit lane (update absorbed on
        # device — not a fire, not a late update, no per-lane emits)
        # needs no host work at all unless a trace or the hint-quality
        # recorder is watching.  Only the exceptional lanes get the
        # per-lane branch cascade below.
        lane_idx = range(n)
        if spec.emit_of is None and not self.recorder.pending_suppressed:
            late = np.fromiter((ln.late_update for ln in lanes), bool, n)
            plain = res.hit & ~res.fire & ~late
            if plain.any() and not any(ln.tup.trace is not None
                                       for ln in lanes):
                lane_idx = np.nonzero(~plain)[0].tolist()
        for i in lane_idx:
            ln = lanes[i]
            tup = ln.tup
            tr = tup.trace
            if tr is not None:
                tr.mark_state(self.name, self.sim.t)
            if res.hit[i]:
                if tr is not None and tr.hit is None:
                    tr.hit = True
                if self.recorder.pending_suppressed:
                    self.recorder.on_access(ln.key, hit=True)
                if ln.fire:
                    self._fused_fire(sub, ln, plane.decode_lane(res, i))
                elif ln.late_update:
                    self._fused_late(sub, ln, plane.decode_lane(res, i))
                else:
                    # per-lane emits from the composed post-lane value
                    # (read enrichment, or sum/max specs with emit_of);
                    # no emit_of = the update is absorbed on device
                    outs = spec.emit_of(tup, plane.decode_lane(res, i)) \
                        if spec.emit_of is not None else []
                    if tr is not None:
                        tr.mark_apply(self.sim.t)
                    for o in outs:
                        self.outputs += 1
                        if tr is not None and \
                                getattr(o, "trace", None) is None:
                            o.trace = tr
                        self.emit(sub, o)
                    if not outs:
                        self._trace_absorbed(tr)
                continue
            # ---- non-hit lane: interpreted adjudication, lane order
            ptup = self._fused_lane_tuple(ln)
            state = plane.lookup(ln.key, ln.ts)
            if state is not None:
                # eviction-buffer restore, or a key admitted by an
                # earlier lane's cold path in this very drain
                if tr is not None and tr.hit is None:
                    tr.hit = True
                if self.recorder.pending_suppressed:
                    self.recorder.on_access(ln.key, hit=True)
                if self.mode == "prefetch":
                    mgr.prefetch_hits += 1
                svc += self._apply(sub, ptup, state)
                continue
            wb = self.wb_pending[sub].get(ln.key)
            if wb is not None:
                if tr is not None and tr.hit is None:
                    tr.hit = True
                if self.recorder.pending_suppressed:
                    self.recorder.on_access(ln.key, hit=True)
                plane.insert(ln.key, wb.state, ln.ts,
                             size=self.state_size)
                svc += self._apply(sub, ptup, wb.state)
                continue
            if tr is not None and tr.hit is None:
                tr.hit = False
            if self.recorder.pending_suppressed:
                self.recorder.on_access(ln.key, hit=False)
            if self.mode == "prefetch" and not mgr.enabled:
                la = mgr.on_cache_misses(self.sim.t)
                if la is not None:
                    self.engine.set_lookahead(self.name, la)
            if self.mode == "sync":
                state, lat = self.backends[sub].fetch(ln.key,
                                                      self.state_size)
                plane.insert(ln.key, state, ln.ts, size=self.state_size)
                mgr.record_access_latency(lat)
                self.blocked_time[sub] += lat
                self.pf_demand.inc()
                if tr is not None:
                    tr.fetch_s += lat
                svc += lat + self._apply(sub, ptup, state)
                continue
            if tr is not None:
                tr.mark_park(self.sim.t)
            if ln.key not in self._park_t[sub]:
                self._park_t[sub][ln.key] = self.sim.t
            self.waiting[sub][ln.key].append(ptup)
            if ln.key not in self.in_flight[sub]:
                self.pf_demand.inc()
                self._io_enqueue(sub, _IOReq("read", ln.key, ln.ts),
                                 front=True)
            svc += IO_ISSUE * (1.0 + len(self.in_flight[sub]) / 32.0)
        self._io_kick(sub)          # opportunistic write-back, per batch
        return svc

    def periodic_evaluate(self) -> None:
        mgr = self.managers[0]
        if not any(m.enabled for m in self.managers):
            return
        mgr.enabled = True
        new = mgr.evaluate(self.caches, self.sim.t)
        if new is not None:
            self.engine.set_lookahead(self.name, new)

    # ---------------------------------------------------- snapshot / restore
    def snapshot_state(self, sub: int, epoch: int) -> dict:
        """Barrier-time snapshot of this subtask's durable state
        (DESIGN.md §7).  Three parts:

          * TAC dirty drain (paper §IV-E): every modified entry —
            resident or staged in the eviction buffer — is written
            through to the backend so the backend delta below covers it;
          * backend DELTA: keys written/deleted since the last epoch
            (incremental — the SnapshotStore composes full state);
          * in-flight keyed work that a restart would otherwise lose:
            tuples parked on outstanding fetches, tuples parked behind an
            in-flight shard migration, and the HintsBuffer contents.

        The export itself runs off the tuple path (like the migration
        drain, §9) and is metered as snapshot bytes, not workload reads;
        the RESTORE of these bytes is charged at backend speed
        (streaming/recovery.py) — no free bulk I/O in either direction.
        """
        import copy
        cache = self.caches[sub]
        dirty = cache.flush_dirty()
        for e in dirty:
            self.backends[sub].write(e.key, e.state, self.state_size)
        # write-backs still in flight at the cut carry pre-barrier state
        # that would otherwise land only in the NEXT epoch's delta: write
        # them through now (idempotent with the completion's own write)
        for e in self.wb_pending[sub].values():
            self.backends[sub].write(e.key, e.state, self.state_size)
        delta, deleted = self.backends[sub].snapshot_delta()
        mgr = self.managers[sub]
        # cache MANIFEST: resident keys + their TAC timestamps (no state
        # payloads — a few bytes per key).  Recovery warmup re-fetches
        # these alongside the hint WAL: the hottest keys are exactly the
        # ones CMS suppression keeps OUT of the hint stream while they
        # sit resident, so without the manifest a warmed restore would
        # stage only the cold tail (DESIGN.md §7)
        manifest = [(e.key, getattr(e, "ts", 0.0))
                    for e in getattr(cache, "entries", {}).values()]
        payload = {
            "n_flushed": len(dirty),
            "delta": delta,
            "deleted": deleted,
            "hints": dict(mgr.hints.in_flight) | dict(mgr.hints.unprocessed),
            "manifest": manifest,
            "inflight": copy.deepcopy(self._snapshot_inflight(sub)),
            "extra": self.snapshot_extra(sub),
            "bytes": len(delta) * self.state_size,
        }
        self.engine.ack_barrier(b_id=epoch, op=self.name, sub=sub,
                                n_flushed=len(dirty))
        return payload

    def _snapshot_inflight(self, sub: int) -> List[Any]:
        """Keyed messages whose state effects are NOT yet applied at the
        barrier cut and that the source will NOT replay (they were
        emitted before the epoch's offsets): parked-on-fetch tuples and
        mid-migration parked traffic.  Windowed subclasses add pending
        FIRE messages (§10)."""
        out = []
        for parked in self.waiting[sub].values():
            out.extend(parked)
        if self.shards is not None:
            for shard, msgs in self.shard_pending.items():
                if self.shards.owner[shard] == sub:
                    out.extend(msgs)
        return out

    def snapshot_extra(self, sub: int) -> Optional[dict]:
        """Operator-specific registries riding the snapshot (window
        registries §10, join retention §11).  The shard-plane owner table
        is included so recovery restores routing consistent with where
        the backend partitions were cut (§9; migrations serialize with
        epochs, so the table is stable across one epoch's cut)."""
        import copy
        if self.shards is not None:
            return {"plane_owner": copy.deepcopy(list(self.shards.owner))}
        return None

    def restore_extra(self, sub: int, extra: Optional[dict]) -> None:
        if extra and self.shards is not None and "plane_owner" in extra:
            self.shards.owner = list(extra["plane_owner"])

    def reset_volatile(self) -> None:
        """A process crash loses every cache, I/O lane, and parked tuple;
        backends are cleared too — the authoritative copy lives in the
        SnapshotStore and is re-imported by recovery (DESIGN.md §7)."""
        super().reset_volatile()
        p = self.parallelism
        self.caches = [self._new_cache() for _ in range(p)]
        self._attach_obs()
        self._park_t = [dict() for _ in range(p)]
        self.waiting = [defaultdict(list) for _ in range(p)]
        self.in_flight = [set() for _ in range(p)]
        self.wb_pending = [dict() for _ in range(p)]
        self.io_q = [deque() for _ in range(p)]
        self.io_free = [self.io_workers] * p
        self.miss_reported = [False] * p
        self.shard_pending.clear()
        if self.shards is not None:
            self.shards.migrating.clear()
        from repro_torch.core.hints import HintsBuffer
        for m in self.managers:
            m.hints = HintsBuffer()
            m._marker_hint_t.clear()
        for b in self.backends:
            b.reset()


class SinkOp(Operator):
    def process(self, sub: int, tup: Tuple_) -> Optional[float]:
        self.engine.record_latency(self.sim.t, tup)
        return 1e-6


class Engine:
    """Dataflow driver: plan assembly, clock, markers, metrics.

    Owns the discrete-event clock (``Sim``), the operator plan, the
    centralised PrefetchingController (DESIGN.md §3), checkpoint
    coordination (§7), and the end-of-run metrics rollup — including the
    per-shard routing/migration counters of any operator on the sharded
    state plane (§9).  ``connect`` wires channels (data or hint side
    channel), ``register_prefetching`` declares the candidate lookaheads
    for one stateful operator, and ``run`` drives sources + periodic
    markers until the requested duration has elapsed.
    """

    def __init__(self, marker_interval: float = 0.100):
        self.sim = Sim()
        self.controller = PrefetchingController(marker_interval)
        self.operators: Dict[str, Operator] = {}
        self._candidate_ops: Dict[str, List[str]] = {}
        self.order: List[str] = []
        # observability plane (DESIGN.md §12): the registry is the one
        # sink for every counter/gauge/histogram; the tracer samples
        # per-tuple critical-path spans (off unless enable_tracing)
        self.registry = MetricsRegistry()
        self.tracer = Tracer(self.registry)
        self._export_path: Optional[str] = None
        self._export_interval = 0.0
        # temporal plane (DESIGN.md §16): interval time series + health
        # detectors on the logical clock, plus a bounded event log the
        # Perfetto export fuses with the sampled spans.  All off by
        # default; the hot-path cost when off is one flag check at the
        # few event sites (epoch/migration/fire/recovery)
        self.timeline: Optional[Timeline] = None
        self.health: Optional[HealthMonitor] = None
        self.events: List[Tuple[str, float, dict]] = []
        self.record_events = False
        self._event_cap = 65536
        self._event_ids = itertools.count(1)
        self._timeline_on = False
        # sink latency: percentiles come from the UNCAPPED streaming
        # sketch (no truncation bias); the bounded deques keep the most
        # RECENT samples for timeline slicing (recovery/sharding
        # benchmarks cut windows around an injected event)
        self.latency_cap = 2_000_000
        self.latencies: deque = deque(maxlen=self.latency_cap)
        self.latency_t: deque = deque(maxlen=self.latency_cap)
        self._sink_hist = self.registry.histogram("engine.sink.latency")
        self._sink_count = self.registry.counter("engine.sink.count")
        self._marker_ids = itertools.count()
        self.marker_interval = marker_interval
        self.lookahead_timeline: List[Tuple[float, str]] = []
        self.checkpoint_acks: Dict[int, List] = {}
        # fault-tolerance plane (DESIGN.md §7): a CheckpointCoordinator
        # (streaming/recovery.py) attaches itself here; the engine-level
        # alignment counters below fill regardless so legacy
        # trigger_checkpoint callers still see stall metrics
        self.coordinator = None
        # flipped (permanently) by the first trigger_checkpoint: keeps
        # the per-batch barrier scan and alignment machinery entirely
        # off the delivery hot path of non-checkpointed runs
        self.barriers_active = False
        self.snapshots_taken = 0
        self.align_stall_total = 0.0
        self.align_stall_max = 0.0
        self.align_buffered = 0

    # -------------------------------------------------------------- building
    def add(self, op: Operator) -> Operator:
        op.plan_pos = len(self.order)
        self.operators[op.name] = op
        self.order.append(op.name)
        return op

    def connect(self, src: Operator, dst: Operator,
                partition=hash_partition, kind: str = "data",
                timeout: float = BUFFER_TIMEOUT,
                codec: Optional[str] = None) -> None:
        ch = Channel(self.sim, dst, kind, partition, src.parallelism,
                     timeout, codec=codec)
        if kind == "hint":
            src.out_hint.append(ch)
        else:
            src.out_data.append(ch)
            # watermarks and checkpoint barriers flow on data edges only:
            # every (channel, src subtask) pair must report before the
            # min-of-inputs advances / the barrier alignment completes
            dst.wm_expected += src.parallelism
            dst.barrier_expected += src.parallelism

    def register_prefetching(self, stateful: StatefulOp,
                             lookaheads: List[MapOp],
                             compress_hints: bool = False) -> None:
        """Declare candidate lookaheads (ordered source -> closest) and wire
        the hint side channels.  On the sharded plane the hint channels
        partition by shard OWNERSHIP (DESIGN.md §9): each hint reaches
        exactly the subtask whose prefetcher owns the key.  With
        ``compress_hints`` the channels account bytes under the delta
        codec (§13).  Binding also points each lookahead's suppression
        verdicts at the stateful operator's recorder for grading."""
        cands = [LookaheadCandidate(op.name, op.plan_pos)
                 for op in lookaheads]
        self.controller.register(stateful.name, cands)
        self._candidate_ops[stateful.name] = [op.name for op in lookaheads]
        plane = getattr(stateful, "shards", None)
        hint_partition = plane.route_hint if plane is not None \
            else hash_partition
        for op in lookaheads:
            op.sink_recorder = stateful.recorder
            self.connect(op, stateful, partition=hint_partition,
                         kind="hint", timeout=HINT_TIMEOUT,
                         codec="delta" if compress_hints else None)

    def migrate_shard(self, op_name: str, shard: int, dst_sub: int,
                      at: Optional[float] = None) -> None:
        """Schedule (or run now) a key-range migration on a sharded
        stateful operator — the rebalance entry point for benchmarks and
        an elasticity controller.  With a CheckpointCoordinator attached,
        migrations SERIALIZE with checkpoint epochs (DESIGN.md §7): a
        migration requested while an epoch is in flight is deferred until
        the epoch completes, so one epoch's cut never straddles an
        ownership flip."""
        op = self.operators[op_name]
        if not isinstance(op, StatefulOp):
            raise TypeError(f"{op_name} is not a StatefulOp")
        if at is None:
            self._do_migrate(op_name, shard, dst_sub)
        else:
            self.sim.at(at, self._do_migrate, op_name, shard, dst_sub)

    def _do_migrate(self, op_name: str, shard: int, dst_sub: int) -> None:
        coord = self.coordinator
        if coord is not None and (coord.pending is not None
                                  or coord.in_recovery):
            coord.defer_migration(op_name, shard, dst_sub)
            return
        self.operators[op_name].migrate_shard(shard, dst_sub)

    def set_lookahead(self, stateful_name: str, lookahead_name: str) -> None:
        for name in self._candidate_ops.get(stateful_name, []):
            op = self.operators.get(name)
            if isinstance(op, MapOp):
                want = name == lookahead_name
                if op.hint_active != want:
                    op.hint_active = want
        if (not self.lookahead_timeline
                or self.lookahead_timeline[-1][1] != lookahead_name):
            self.lookahead_timeline.append((self.sim.t, lookahead_name))

    # -------------------------------------------------------------- running
    def record_latency(self, now: float, tup: Tuple_) -> None:
        lat = now - tup.ingest_t
        self.latencies.append(lat)
        self.latency_t.append(now)
        self._sink_hist.observe(lat)
        self._sink_count.inc()
        if tup.trace is not None:
            self.tracer.finish(tup.trace, now)

    # -------------------------------------------------- observability plane
    def enable_tracing(self, sample_every: int = 64) -> None:
        """Turn on per-tuple critical-path span sampling (DESIGN.md §12):
        every Nth source tuple carries a TupleTrace finalized at the
        sink.  Off by default — the disabled cost is one flag check per
        source tuple."""
        self.tracer.enable(sample_every)

    def enable_export(self, path: str, interval: float = 1.0) -> None:
        """Append a registry snapshot line to ``path`` every ``interval``
        sim seconds (JSONL: ``{"t": ..., "delta": {...}, "metrics":
        {...}}`` — see ``MetricsRegistry.export_jsonl``)."""
        self._export_path = path
        self._export_interval = interval
        self.sim.after(interval, self._export_tick)

    def _export_tick(self) -> None:
        self._sync_registry()
        self.registry.export_jsonl(self._export_path, t=self.sim.t)
        self.sim.after(self._export_interval, self._export_tick)

    def enable_timeline(self, interval: float = 0.1, capacity: int = 600,
                        detectors: bool = True, **health_kw) -> None:
        """Turn on the temporal plane (DESIGN.md §16): every
        ``interval`` sim seconds, mirror the operator counters and cut a
        timeline interval (counter deltas, gauge samples, histogram
        interval sketches) into a bounded ring; with ``detectors``, run
        the health detectors over each cut and log their alerts.  Extra
        keyword args tune ``HealthMonitor`` thresholds."""
        self.timeline = Timeline(self.registry, interval, capacity)
        if detectors:
            stateful = [n for n, op in self.operators.items()
                        if isinstance(op, StatefulOp)]
            self.health = HealthMonitor(self.timeline, stateful,
                                        **health_kw)
        self.record_events = True
        self._timeline_on = True
        self.sim.after(interval, self._timeline_tick)

    def stop_timeline(self) -> None:
        """Freeze the temporal plane: no further cuts or detector
        updates (the chaos harness calls this before its drain phase,
        where throughput legitimately falls to zero)."""
        self._timeline_on = False

    def _timeline_tick(self) -> None:
        if not self._timeline_on or self.timeline is None:
            return
        self._sync_registry()
        iv = self.timeline.tick(self.sim.t)
        if self.health is not None:
            for a in self.health.observe(iv):
                self.log_event("alert", alert_kind=a.kind, op=a.op,
                               value=a.value)
        self.sim.after(self.timeline.interval, self._timeline_tick)

    def log_event(self, kind: str, **fields) -> None:
        """Append to the bounded engine event log (epoch barriers,
        migrations, failures/recoveries, window fires, alerts) for the
        Perfetto export.  No-op unless ``record_events`` is on."""
        if not self.record_events or len(self.events) >= self._event_cap:
            return
        self.events.append((kind, self.sim.t, fields))

    def trigger_checkpoint(self, checkpoint_id: int) -> None:
        """Inject an epoch's barriers at every source subtask (each
        downstream operator aligns over all of them, DESIGN.md §7).  The
        CheckpointCoordinator drives this on an interval and records
        source offsets first; calling it directly still produces aligned
        snapshots and ``checkpoint_acks`` (but backend deltas only cover
        writes since delta tracking was switched on — attach a
        coordinator before data flows for restorable snapshots)."""
        self.barriers_active = True
        for op in self.operators.values():
            if isinstance(op, StatefulOp):
                for bk in op.backends:
                    bk.track_deltas = True
        b = CheckpointBarrier(checkpoint_id)
        for name in self.order:
            op = self.operators[name]
            if isinstance(op, SourceOp):
                for s in range(op.parallelism):
                    for ch in op.out_data:
                        ch.send(s, b)

    def ack_barrier(self, b_id: int, op: str, sub: int,
                    n_flushed: int) -> None:
        self.checkpoint_acks.setdefault(b_id, []).append(
            (self.sim.t, op, sub, n_flushed))

    def on_snapshot(self, epoch: int, op: str, sub: int,
                    payload: Optional[dict], stall: float,
                    buffered: int) -> None:
        """One (operator, subtask) reached the epoch's aligned cut."""
        self.snapshots_taken += 1
        self.align_stall_total += stall
        self.align_stall_max = max(self.align_stall_max, stall)
        self.align_buffered += buffered
        if self.coordinator is not None:
            self.coordinator.on_operator_snapshot(epoch, op, sub, payload,
                                                  stall, buffered)

    def _inject_marker(self) -> None:
        mid = next(self._marker_ids)
        m = Marker(mid)
        for name in self.order:
            op = self.operators[name]
            if isinstance(op, SourceOp):
                for ch in op.out_data:
                    ch.send(0, m)
        for name in self.order:
            op = self.operators[name]
            if isinstance(op, StatefulOp):
                op.periodic_evaluate()
        self.sim.after(self.marker_interval, self._inject_marker)

    def run(self, duration: float, warmup: float = 0.0) -> Dict[str, Any]:
        for op in self.operators.values():
            if isinstance(op, SourceOp):
                op.start()
        self.sim.after(self.marker_interval, self._inject_marker)
        if warmup > 0:
            self.sim.run_until(warmup)
            self.latencies.clear()
            self.latency_t.clear()
            # latency percentiles cover the measured window only: reset
            # the sink sketch/count and drop warmup-sampled spans (the
            # cumulative hint/cache counters intentionally keep counting
            # across warmup, exactly like before)
            self._sink_hist.sketch = QuantileSketch()
            self._sink_count.value = 0
            self.tracer.reset()
        self.sim.run_until(warmup + duration)
        for op in self.operators.values():
            if isinstance(op, StatefulOp):
                # close the suppression ledger (§13): anything still
                # pending at end of run was never accessed again
                op.recorder.flush_pending()
        return self.metrics(duration, warmup)

    # -------------------------------------------------------------- metrics
    def metrics(self, duration: float, warmup: float) -> Dict[str, Any]:
        sk = self._sink_hist.sketch
        n = self._sink_count.value
        # percentiles from the UNCAPPED streaming sketch — the bounded
        # `latencies` deque would bias long runs toward recent samples
        out = {
            "n_outputs": n,
            "throughput": n / duration,
            "p50": sk.quantile(0.50),
            "p90": sk.quantile(0.90),
            "p99": sk.quantile(0.99),
            "p999": sk.quantile(0.999),
            "max": sk.vmax if n else 0.0,
        }
        busy = sum(sum(op.busy_time) for op in self.operators.values())
        slots = sum(op.parallelism for op in self.operators.values())
        out["cpu_util"] = busy / (slots * (duration + warmup))
        # per-operator busy fraction (Flink busyTimeMsPerSecond analogue:
        # includes synchronous I/O wait, paper Table I)
        for name, op in self.operators.items():
            out[f"util_{name}"] = (sum(op.busy_time)
                                   / (op.parallelism * (duration + warmup)))
        data_bytes = hint_bytes = hint_bytes_raw = 0
        codecs_active = False
        for op in self.operators.values():
            for ch in op.out_data:
                data_bytes += ch.bytes_sent
            for ch in op.out_hint:
                hint_bytes += ch.bytes_sent
                hint_bytes_raw += ch.bytes_raw
                codecs_active = codecs_active or ch.codec is not None
        out["data_bytes"] = data_bytes
        out["hint_bytes"] = hint_bytes
        out["net_overhead"] = hint_bytes / max(1, data_bytes)
        if codecs_active:
            out["hint_bytes_raw"] = hint_bytes_raw
            out["hint_compression"] = hint_bytes_raw / max(1, hint_bytes)
        for name, op in self.operators.items():
            if isinstance(op, StatefulOp):
                out[f"{name}_hit_rate"] = sum(
                    c.hits for c in op.caches) / max(
                    1, sum(c.hits + c.misses for c in op.caches))
                out[f"{name}_queued"] = sum(len(q) for q in op.queues)
                out[f"{name}_backend_reads"] = sum(
                    b.reads for b in op.backends)
                out[f"{name}_backend_writes"] = sum(
                    b.writes for b in op.backends)
                out[f"{name}_backend_bytes_read"] = sum(
                    b.bytes_read for b in op.backends)
                out[f"{name}_backend_bytes_written"] = sum(
                    b.bytes_written for b in op.backends)
                out[f"{name}_prefetch_hits"] = sum(
                    m.prefetch_hits for m in op.managers)
                out[f"{name}_hints_received"] = sum(
                    m.hints_received for m in op.managers)
                out[f"{name}_hints_late"] = sum(
                    m.hints_late for m in op.managers)
                out[f"{name}_hints_duplicate"] = sum(
                    m.hints_duplicate for m in op.managers)
                # hint timeliness/accuracy rollup (DESIGN.md §12): the
                # per-hint outcome split, signed lead times, and the
                # precision/recall headline ratios
                out[f"{name}_hint_quality"] = op.recorder.quality_block(
                    out[f"{name}_prefetch_hits"],
                    op.pf_demand.value,
                    out[f"{name}_hints_duplicate"],
                    out[f"{name}_hints_late"])
                ev: Dict[str, int] = {}
                for c in op.caches:
                    for k, v in getattr(c, "eviction_block",
                                        lambda: {})().items():
                        ev[k] = ev.get(k, 0) + v
                if ev:
                    out[f"{name}_evictions"] = ev
                lsk = op.access_hist.sketch
                if lsk.count:
                    out[f"{name}_access_p50"] = lsk.quantile(0.50)
                    out[f"{name}_access_p99"] = lsk.quantile(0.99)
                fp = [c for c in op.caches if isinstance(c, FusedPlane)]
                if fp:
                    # fused-plane rollup (§14): device tallies + batch
                    # occupancy (underfilled batches waste launch cost)
                    out[f"{name}_fused"] = {
                        "batches": sum(c.batches for c in fp),
                        "lanes": sum(c.lanes for c in fp),
                        "fill_ratio": sum(c.lanes for c in fp) / max(
                            1, sum(c.batches * c.batch for c in fp)),
                        "device_hits": sum(c.device_hits for c in fp),
                        "device_misses": sum(c.device_misses for c in fp),
                        "device_conflicts": sum(c.device_conflicts
                                                for c in fp),
                    }
                if op.shards is not None:
                    # per-shard routed-plane counters (DESIGN.md §9), not
                    # just the global totals above
                    out[f"{name}_shard_plane"] = op.shards.snapshot()
        if self.snapshots_taken:
            # checkpoint-plane counters (DESIGN.md §7), alongside the
            # per-shard block above
            out["checkpoint"] = {
                "snapshots_taken": self.snapshots_taken,
                "align_stall_total": self.align_stall_total,
                "align_stall_max": self.align_stall_max,
                "align_stall_avg": self.align_stall_total
                / self.snapshots_taken,
                "align_buffered": self.align_buffered,
            }
            if self.coordinator is not None:
                out["checkpoint"].update(self.coordinator.metrics_block())
        if self.coordinator is not None and self.coordinator.recoveries:
            out["recovery"] = self.coordinator.recovery_block()
        for name, op in self.operators.items():
            # operator-specific counters (windowed fires/late paths, burst
            # hints, ...) without the engine importing those modules
            extra = getattr(op, "extra_metrics", None)
            if callable(extra):
                for k, v in extra().items():
                    out[f"{name}_{k}"] = v
            if any(w > float("-inf") for w in op.wm):
                out[f"{name}_watermark"] = list(op.wm)
                lag = self._wm_lag(op)
                if lag is not None:
                    out[f"{name}_watermark_lag"] = lag
        if self.tracer.active:
            # sampled critical-path breakdown (DESIGN.md §12)
            out["trace"] = self.tracer.summary()
        if self.timeline is not None:
            # temporal-plane rollup (DESIGN.md §16)
            out["timeline"] = self.timeline.block()
        if self.health is not None:
            out["health"] = self.health.block()
            out["alerts"] = [a.as_dict() for a in self.health.alerts]
        self._sync_registry()
        return out

    def _wm_lag(self, op: Operator) -> Optional[float]:
        """Event-time watermark lag: the source frontier (max emitted
        event ts) minus the operator's slowest subtask watermark."""
        frontier = max((m for s in self.operators.values()
                        if isinstance(s, SourceOp) for m in s._max_ts),
                       default=float("-inf"))
        low = min(op.wm)
        if frontier == float("-inf") or low == float("-inf"):
            return None
        return frontier - low

    def _sync_registry(self) -> None:
        """Mirror the operator-local counters into their catalogued
        registry names (DESIGN.md §12).  Hot paths keep their plain-int
        counters; this runs only at snapshot/export time, so the live
        registry view stays consistent without taxing the data path."""
        r = self.registry
        data_bytes = hint_bytes = busy = 0.0
        slots = 0
        for name, op in self.operators.items():
            for ch in op.out_data:
                data_bytes += ch.bytes_sent
            for ch in op.out_hint:
                hint_bytes += ch.bytes_sent
            busy += sum(op.busy_time)
            slots += op.parallelism
            pre = f"engine.{name}"
            r.counter(f"{pre}.processed").set(op.processed)
            elapsed = max(self.sim.t, 1e-12)
            r.gauge(f"{pre}.busy_frac").set(
                sum(op.busy_time) / (op.parallelism * elapsed))
            r.gauge(f"{pre}.queue.depth").set(
                sum(len(q) for q in op.queues)
                + sum(len(q) for q in getattr(op, "ready", [])))
            lag = self._wm_lag(op)
            if lag is not None:
                r.gauge(f"{pre}.watermark.lag").set(lag)
            if not isinstance(op, StatefulOp):
                continue
            r.counter(f"{pre}.cache.hits").set(
                sum(c.hits for c in op.caches))
            r.counter(f"{pre}.cache.misses").set(
                sum(c.misses for c in op.caches))
            r.counter(f"{pre}.backend.reads").set(
                sum(b.reads for b in op.backends))
            r.counter(f"{pre}.backend.writes").set(
                sum(b.writes for b in op.backends))
            r.counter(f"{pre}.hints.received").set(
                sum(m.hints_received for m in op.managers))
            r.counter(f"{pre}.hints.late").set(
                sum(m.hints_late for m in op.managers))
            r.counter(f"{pre}.hints.duplicate").set(
                sum(m.hints_duplicate for m in op.managers))
            r.counter(f"{pre}.prefetch.hits").set(
                sum(m.prefetch_hits for m in op.managers))
            ev: Dict[str, int] = {}
            for c in op.caches:
                for k, v in getattr(c, "eviction_block",
                                    lambda: {})().items():
                    ev[k] = ev.get(k, 0) + v
            for k, v in ev.items():
                r.counter(f"{pre}.evict.{k}").set(v)
            fp = [c for c in op.caches if isinstance(c, FusedPlane)]
            if fp:
                r.counter(f"{pre}.fused.batches").set(
                    sum(c.batches for c in fp))
                r.counter(f"{pre}.fused.lanes").set(
                    sum(c.lanes for c in fp))
                r.gauge(f"{pre}.fused.fill_ratio").set(
                    sum(c.lanes for c in fp) / max(
                        1, sum(c.batches * c.batch for c in fp)))
                r.counter(f"{pre}.fused.device_hits").set(
                    sum(c.device_hits for c in fp))
                r.counter(f"{pre}.fused.device_misses").set(
                    sum(c.device_misses for c in fp))
                r.counter(f"{pre}.fused.device_conflicts").set(
                    sum(c.device_conflicts for c in fp))
            if op.shards is not None:
                op.shards.registry_sync(r, pre, op.shard_pending)
        r.counter("engine.net.data_bytes").set(int(data_bytes))
        r.counter("engine.net.hint_bytes").set(int(hint_bytes))
        r.gauge("engine.cpu.util").set(
            busy / max(1e-12, slots * self.sim.t))
        if self.snapshots_taken:
            r.counter("checkpoint.snapshots_taken").set(self.snapshots_taken)
            r.gauge("checkpoint.align_stall_total").set(
                self.align_stall_total)
            r.gauge("checkpoint.align_stall_max").set(self.align_stall_max)
            r.counter("checkpoint.align_buffered").set(self.align_buffered)
        if self.coordinator is not None:
            self.coordinator.registry_sync(r)
