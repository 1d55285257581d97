"""Fault-tolerance plane: barrier-aligned checkpoints of the keyed-state
plane with prefetch-warmed recovery (DESIGN.md §7).

The paper targets applications that "run forever"; this module makes the
engine survive them.  Three pieces:

  * ``CheckpointCoordinator`` — injects epoch-numbered barriers at every
    source subtask on an interval; operators ALIGN the barrier copies
    across their inputs (buffering post-barrier traffic, metering the
    alignment stall — ``engine.py``), snapshot their keyed state at the
    aligned cut (TAC dirty drain → backend delta, window/join registries,
    HintsBuffer contents, in-flight parked tuples), and the coordinator
    completes the epoch once every (operator, subtask) acked and the
    write landed.  Migrations serialize with epochs (§9 ∩ §7) so no cut
    ever straddles an ownership flip.

  * ``SnapshotStore`` — composes the per-epoch incremental deltas into
    materialized per-partition state (RocksDB-style incremental
    checkpoints), optionally persisting each epoch's delta through the
    same async atomic writer the training checkpoints use
    (``checkpoint/manager.py``).  Only COMPLETED epochs are restorable:
    a failure between alignment and persist rolls the epoch back.

  * failure injection + recovery — ``inject_failure_at`` kills the job
    mid-run (volatile state dropped, pending callbacks purged, in-flight
    network lost); recovery restores the last completed epoch at backend
    speed (no free bulk reads), rewinds the replayable sources to the
    snapshotted offsets, and replays.  The headline is the RECOVERY
    WARMUP (``mode="warmed"``): the cache comes back cold, and the first
    seconds of replay would pay on-demand backend latency — exactly the
    paper's baseline p99 spike.  Warmed recovery re-issues the logged
    hint stream for the replay horizon (the hint WAL + the snapshotted
    HintsBuffer) through the existing ``PrefetchingManager`` BEFORE the
    replayed data path resumes, staging the hot set off the tuple path —
    the same latency-conscious state movement Megaphone applies to
    migration, applied to restarts.

Recorded deviations (§7): emit-side effects are at-least-once (a window
that fired between the cut and the failure re-fires after recovery —
state effects stay exactly-once, duplicates appear only on the emit
path); lookahead soft state (CMS counters) and operator adaptation
statistics are not snapshotted (the controller is coordinator-side and
survives; CMS re-learns).
"""
from __future__ import annotations

import copy
import itertools
import pickle
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.streaming.engine import (Channel, Engine, Operator, SourceOp,
                                    StatefulOp, _IOReq)

# calibrated snapshot-plane constants (DESIGN.md §8): one RTT to the
# durable store per epoch plus the delta at backbone bandwidth (same
# class as the migration bulk path)
SNAPSHOT_RTT = 1e-3
SNAPSHOT_BANDWIDTH = 1.2e9
# warmup replay budget, in multiples of the cache's entry capacity: the
# data replay consumes staged entries while later prefetches issue, so
# modest oversubscription raises coverage — but an UNBOUNDED replay
# (e.g. a long hint WAL over a uniform key tail) thrashes the cache and
# stretches the warmup lead for keys that evict before use
WARMUP_BUDGET_SLACK = 1.5


class SnapshotStore:
    """Durable store for epoch snapshots (DESIGN.md §7).

    Holds per-epoch records (offsets, per-(op, subtask) payloads) and the
    MATERIALIZED per-partition backend state composed from the
    incremental deltas — persisting a delta applies its writes and
    tombstones over the previous epoch's view, so restore hands back full
    state without replaying every epoch.  With ``directory`` set, each
    completed epoch's delta record is additionally pickled to disk
    through ``checkpoint.manager.AsyncAtomicWriter`` (same single-writer
    + atomic-rename discipline as training checkpoints); the in-memory
    view stays authoritative for the simulated restore path.
    """

    def __init__(self, directory: Optional[str] = None, keep: int = 3):
        self.records: Dict[int, dict] = {}
        self.materialized: Dict[Tuple[str, int], Dict[Any, Any]] = {}
        self.last_epoch: Optional[int] = None
        self.keep = keep
        self.persisted_bytes = 0
        self._writer = None
        if directory is not None:
            from repro_torch.checkpoint.manager import AsyncAtomicWriter
            self._writer = AsyncAtomicWriter(directory)

    def persist(self, epoch: int, record: dict) -> None:
        """Publish a completed epoch: apply its deltas to the
        materialized view, retain the record, GC old records."""
        for op_sub, payload in record["ops"].items():
            if not payload:
                continue
            base = self.materialized.setdefault(op_sub, {})
            for k in payload.get("deleted", ()):
                base.pop(k, None)
            base.update(payload.get("delta", {}))
        self.records[epoch] = record
        self.last_epoch = epoch
        self.persisted_bytes += record.get("bytes", 0)
        for e in sorted(self.records)[:-self.keep]:
            del self.records[e]
        if self._writer is not None:
            blob = pickle.dumps({"epoch": epoch, "record": record})

            def _write(tmp):
                with open(f"{tmp}/record.pkl", "wb") as f:
                    f.write(blob)

            self._writer.submit(f"epoch_{epoch:08d}", _write)

    def latest(self) -> Optional[Tuple[int, dict]]:
        if self.last_epoch is None:
            return None
        return self.last_epoch, self.records[self.last_epoch]

    def wait(self) -> None:
        if self._writer is not None:
            self._writer.wait()


class CheckpointCoordinator:
    """JobManager-side checkpoint driver (DESIGN.md §7).

    One epoch in flight at a time: ``trigger`` records the replayable
    sources' offsets, then injects the epoch's barriers at every source
    subtask; downstream alignment and snapshots report back through
    ``Engine.on_snapshot``; once every (operator, subtask) acked, the
    epoch completes after the modelled store write
    (``SNAPSHOT_RTT + bytes / SNAPSHOT_BANDWIDTH``).  A trigger landing
    while shards are migrating is deferred (and vice versa — see
    ``Engine.migrate_shard``): the epoch cut and the ownership flip are
    never concurrent, which is also what keeps shard-forwarding off the
    alignment window.
    """

    def __init__(self, engine: Engine, interval: float = 0.5,
                 store: Optional[SnapshotStore] = None,
                 defer_delay: float = 0.02):
        self.engine = engine
        self.sim = engine.sim
        self.interval = interval
        self.defer_delay = defer_delay
        self.store = store if store is not None else SnapshotStore()
        engine.coordinator = self
        # delta tracking must start BEFORE data flows, or the first
        # epoch's incremental delta misses pre-attach state (backends
        # keep it off otherwise — see StateBackend.track_deltas)
        for op in engine.operators.values():
            if isinstance(op, StatefulOp):
                for bk in op.backends:
                    bk.track_deltas = True
        self._epochs = itertools.count(1)
        self.pending: Optional[dict] = None
        self._queued_migrations: List[Tuple[str, int, int]] = []
        self.in_recovery = False
        # counters (surfaced via Engine.metrics "checkpoint"/"recovery")
        self.epochs_completed = 0
        self.skipped_triggers = 0
        self.deferred_triggers = 0
        self.rolled_back = 0
        self.stale_acks = 0
        self.snapshot_bytes_total = 0
        self.failures = 0
        self.warmup_hints = 0
        self.recoveries: List[dict] = []

    # ------------------------------------------------------------- triggering
    def start(self) -> None:
        self.sim.after(self.interval, self._tick)

    def _tick(self) -> None:
        self.trigger()
        self.sim.after(self.interval, self._tick)

    def _migrating(self) -> bool:
        """True while any shard is in transit OR within the post-landing
        QUIESCE window: tuples partitioned under the old owner table can
        sit in channel buffers for up to the flush timeout and then take
        the one-hop forward (which carries no channel origin, bypassing
        alignment) — a barrier cut inside that tail could process a
        pre-barrier tuple after the snapshot and lose its effects.
        Deferring the trigger until the tail drains closes the window
        (DESIGN.md §7 ∩ §9)."""
        quiesce = 0.0
        for op in self.engine.operators.values():
            for ch in op.out_data:
                quiesce = max(quiesce, ch.timeout)
        from repro_torch.streaming.engine import NET_LATENCY
        quiesce += 3 * NET_LATENCY
        now = self.sim.t
        for op in self.engine.operators.values():
            if isinstance(op, StatefulOp) and op.shards is not None:
                if op.shards.migrating:
                    return True
                if now - op.shards.last_finish_t < quiesce:
                    return True
        return False

    def trigger(self) -> None:
        if self.pending is not None or self.in_recovery:
            self.skipped_triggers += 1
            return
        if self._migrating():
            # serialize with the in-flight migration (§9 ∩ §7)
            self.deferred_triggers += 1
            self.sim.after(self.defer_delay, self.trigger)
            return
        epoch = next(self._epochs)
        offsets = {}
        expected = set()
        for name, op in self.engine.operators.items():
            if isinstance(op, SourceOp):
                if op.replayable:
                    offsets[name] = [op.offset(s)
                                     for s in range(op.parallelism)]
            else:
                expected.update((name, s) for s in range(op.parallelism))
        self.pending = {"epoch": epoch, "t0": self.sim.t,
                        "offsets": offsets, "acks": {},
                        "expected": expected, "bytes": 0}
        self.engine.log_event("epoch_trigger", id=epoch)
        self.engine.trigger_checkpoint(epoch)

    def defer_migration(self, op_name: str, shard: int,
                        dst_sub: int) -> None:
        """Called by ``Engine._do_migrate`` when an epoch is in flight."""
        self._queued_migrations.append((op_name, shard, dst_sub))

    # --------------------------------------------------------------- epoching
    def on_operator_snapshot(self, epoch: int, op: str, sub: int,
                             payload: Optional[dict], stall: float,
                             buffered: int) -> None:
        p = self.pending
        if p is None or p["epoch"] != epoch:
            self.stale_acks += 1
            return
        p["acks"][(op, sub)] = payload
        if set(p["acks"]) >= p["expected"]:
            p["bytes"] = sum(pl.get("bytes", 0)
                             for pl in p["acks"].values() if pl)
            delay = SNAPSHOT_RTT + p["bytes"] / SNAPSHOT_BANDWIDTH
            self.sim.after(delay, self._complete, epoch)

    def _complete(self, epoch: int) -> None:
        p = self.pending
        if p is None or p["epoch"] != epoch:
            return                        # a failure rolled this epoch back
        self.store.persist(epoch, {
            "epoch": epoch, "t0": p["t0"], "offsets": p["offsets"],
            "ops": p["acks"], "bytes": p["bytes"]})
        self.epochs_completed += 1
        self.snapshot_bytes_total += p["bytes"]
        self.engine.log_event("epoch_complete", id=epoch,
                              bytes=p["bytes"])
        self.pending = None
        # reclaim logs no restore can need any more
        for name, offs in p["offsets"].items():
            src = self.engine.operators[name]
            for s, off in enumerate(offs):
                src.trim_log(s, off)
        for op in self.engine.operators.values():
            if isinstance(op, StatefulOp):
                for s in range(op.parallelism):
                    op.hint_log[s] = [h for h in op.hint_log[s]
                                      if h[0] >= p["t0"]]
        # run migrations that waited for the epoch (§9 ∩ §7)
        queued, self._queued_migrations = self._queued_migrations, []
        for op_name, shard, dst_sub in queued:
            self.engine._do_migrate(op_name, shard, dst_sub)

    def metrics_block(self) -> Dict[str, Any]:
        return {
            "epochs_completed": self.epochs_completed,
            "last_completed_epoch": self.store.last_epoch,
            "snapshot_bytes_total": self.snapshot_bytes_total,
            "skipped_triggers": self.skipped_triggers,
            "deferred_triggers": self.deferred_triggers,
            "rolled_back": self.rolled_back,
            "interval": self.interval,
        }

    def registry_sync(self, registry) -> None:
        """Mirror the checkpoint/recovery-plane counters into the
        metrics registry (``checkpoint.*`` / ``recovery.*``, DESIGN.md
        §12); called by ``Engine._sync_registry``."""
        registry.counter("checkpoint.completed").set(self.epochs_completed)
        registry.counter("checkpoint.bytes").set(self.snapshot_bytes_total)
        if self.recoveries:
            rb = self.recovery_block()
            registry.counter("recovery.count").set(rb["failures"])
            registry.counter("recovery.warmup_hints").set(
                rb["warmup_hints"])
            registry.gauge("recovery.restore_s").set(
                rb.get("last_downtime", 0.0))

    # ----------------------------------------------------- failure / recovery
    def fail(self, mode: str = "warmed", down_time: float = 0.05,
             replay_speedup: float = 4.0,
             warmup_lead: Optional[float] = None) -> None:
        """Kill the job NOW and recover from the last completed epoch.

        ``mode``: ``"warmed"`` replays the hint WAL through the
        PrefetchingManagers before the data path resumes; ``"cold"``
        restores state only (the paper's on-demand baseline after
        restore).  ``down_time`` models detection + reschedule;
        ``replay_speedup`` is the catch-up rate multiple.
        """
        if mode not in ("warmed", "cold"):
            raise ValueError(f"mode {mode!r}")
        if self.in_recovery:
            # a second failure landing inside the first recovery's
            # restore/warmup window would interleave two incarnations'
            # resume callbacks (double-scheduled source ticks, doubled
            # replay); overlapping failures are out of scope — fail loud
            raise RuntimeError("failure injected while a recovery is "
                               "already in flight")
        eng = self.engine
        now = self.sim.t
        self.failures += 1
        if self.pending is not None:
            # epoch aligned-but-not-persisted: roll back (DESIGN.md §7)
            self.rolled_back += 1
            self.pending = None
        # migrations deferred behind the rolled-back epoch stay queued:
        # the rebalance request survives the crash (it is control-plane
        # intent, not task state) and replays after restore, exactly
        # like migrations requested during the outage
        self.in_recovery = True
        # the dead incarnation: pending service/I-O completions, source
        # ticks, and in-flight network buffers all die with the process
        purged = self.sim.purge(
            lambda ev: isinstance(getattr(ev[2], "__self__", None),
                                  (Operator, Channel)))
        for op in eng.operators.values():
            for ch in op.out_data + op.out_hint:
                ch.bufs.clear()
                ch.buf_bytes.clear()
                ch.flush_scheduled.clear()
            if isinstance(op, SourceOp):
                op.stopped = True
            op.reset_volatile()
        rec = self.store.latest()
        entry = {"t_fail": now, "mode": mode, "purged_events": purged,
                 "epoch": rec[0] if rec else None, "down_time": down_time,
                 "fid": self.failures}
        self.recoveries.append(entry)
        eng.log_event("failure", id=self.failures, mode=mode)
        self.sim.after(down_time, self._restore, rec, entry, mode,
                       replay_speedup, warmup_lead)

    def _restore(self, rec, entry: dict, mode: str, replay_speedup: float,
                 warmup_lead: Optional[float]) -> None:
        """Re-import the last completed epoch at backend speed, then (for
        ``warmed``) replay the hint WAL, then resume the sources."""
        eng = self.engine
        restore_bytes = 0
        max_delay = 0.0
        record = rec[1] if rec else None
        if record is not None:
            for (op_name, sub), snap in record["ops"].items():
                op = eng.operators[op_name]
                if not isinstance(op, StatefulOp):
                    continue
                items = self.store.materialized.get((op_name, sub), {})
                n = op.backends[sub].restore_snapshot(copy.deepcopy(items))
                b = n * op.state_size
                restore_bytes += b
                # the bulk re-import is a charged backend read: partition
                # restore runs at backend speed, in parallel across subs
                max_delay = max(max_delay, op.backends[sub].latency(b))
                op.restore_extra(sub, copy.deepcopy(snap.get("extra"))
                                 if snap else None)
        t_ready = self.sim.t + max_delay
        entry["restore_bytes"] = restore_bytes
        entry["restore_delay"] = max_delay
        if mode == "warmed" and record is not None:
            plan, n_hints = self._plan_warmup(record)
            self.sim.at(t_ready, self._warmup, plan)
            if warmup_lead is None:
                # enough lead for the I/O lanes to drain the hint replay
                io = sum(op.io_workers * op.parallelism
                         for op in eng.operators.values()
                         if isinstance(op, StatefulOp)) or 1
                lat = max((op.backends[0].latency(op.state_size)
                           for op in eng.operators.values()
                           if isinstance(op, StatefulOp)), default=0.0)
                warmup_lead = min(0.5, 1.2 * lat * n_hints / io)
        else:
            warmup_lead = 0.0
        entry["warmup_lead"] = warmup_lead
        t_resume = t_ready + warmup_lead
        entry["t_resume"] = t_resume
        entry["downtime"] = t_resume - entry["t_fail"]
        self.sim.at(t_resume, self._resume, record, entry, replay_speedup)

    def _plan_warmup(self, record: dict):
        """Build the capped per-(op, subtask) warmup replay (DESIGN.md
        §7): the cache MANIFEST first (resident at the cut = proven
        hot), then the snapshotted HintsBuffer, then the hint WAL newest
        first — deduped and CAPPED at the cache's entry capacity.  A
        replay longer than the cache thrashes: later prefetches evict
        earlier ones, the lead grows, and the warmup stages churn
        instead of the hot set."""
        plan = {}
        total = 0
        for (op_name, sub), snap in record["ops"].items():
            op = self.engine.operators[op_name]
            if not isinstance(op, StatefulOp) or not snap:
                continue
            budget = int(WARMUP_BUDGET_SLACK
                         * max(1, op.cache_capacity
                               // max(1, op.state_size)))
            replay = list(snap.get("manifest", ()))
            replay += list(snap.get("hints", {}).items())
            wal = [(k, ts) for (t, k, ts) in op.hint_log[sub]
                   if t >= record["t0"]]
            replay += reversed(wal)
            seen = set()
            capped = []
            for key, ts in replay:
                if key in seen:
                    continue
                seen.add(key)
                capped.append((key, ts))
                if len(capped) >= budget:
                    break
            plan[(op_name, sub)] = capped
            total += len(capped)
        return plan, total

    def _warmup(self, plan: dict) -> None:
        """Recovery warmup (the headline, DESIGN.md §7): re-issue the
        planned hint replay through the ordinary prefetch path
        (admission, dedup, charged ``peek_latency`` I/O), so the hot set
        stages while the data path is still down."""
        for (op_name, sub), replay in plan.items():
            op = self.engine.operators[op_name]
            for key, ts in replay:
                # logged at the subtask that received it, re-routed by the
                # RESTORED ownership (a post-epoch migration rolled back)
                tgt = op.shards.owner_of(key) if op.shards is not None \
                    else sub
                mgr = op.managers[tgt]
                if mgr.on_hint(key, ts, op.caches[tgt],
                               watermark=op.wm[tgt],
                               lateness=op.hint_lateness):
                    mgr.hints.take(key)
                    op._io_enqueue(tgt, _IOReq("prefetch", key, ts,
                                               origin="recovery"))
                    self.warmup_hints += 1

    def _resume(self, record: Optional[dict], entry: dict,
                replay_speedup: float) -> None:
        eng = self.engine
        offsets = record["offsets"] if record else {}
        for name, op in eng.operators.items():
            if not isinstance(op, SourceOp):
                continue
            if op.replayable:
                offs = offsets.get(name)
                for s in range(op.parallelism):
                    op.rewind(s, offs[s] if offs else op.log_base[s])
                op.resume(replay_speedup=replay_speedup)
            else:
                # non-replayable source: restart live (records during the
                # outage are lost — why the benchmarks run replayable)
                op.stopped = False
                op.start()
        if record is not None:
            # tuples whose effects were NOT in the cut and that no source
            # will replay: parked fetches, mid-migration parks, pending
            # FIREs — re-delivered for exactly-once state effects
            for (op_name, sub), snap in record["ops"].items():
                if snap and snap.get("inflight"):
                    eng.operators[op_name].deliver_batch(
                        sub, copy.deepcopy(snap["inflight"]))
        entry["warmup_hints"] = self.warmup_hints
        self.in_recovery = False
        eng.log_event("recovered", id=entry.get("fid"),
                      warmup_hints=self.warmup_hints)
        # migrations requested during the outage waited for the restore
        queued, self._queued_migrations = self._queued_migrations, []
        for op_name, shard, dst_sub in queued:
            eng._do_migrate(op_name, shard, dst_sub)

    def recovery_block(self) -> Dict[str, Any]:
        last = dict(self.recoveries[-1]) if self.recoveries else {}
        last.pop("purged_events", None)
        replayed = sum(op.replayed for op in self.engine.operators.values()
                       if isinstance(op, SourceOp))
        return {"failures": self.failures, "warmup_hints": self.warmup_hints,
                "replayed": replayed, **{f"last_{k}": v
                                         for k, v in last.items()}}


def inject_failure_at(engine: Engine, at: float, mode: str = "warmed",
                      down_time: float = 0.05,
                      replay_speedup: float = 4.0,
                      warmup_lead: Optional[float] = None) -> None:
    """Schedule a whole-job failure at sim time ``at`` (the streaming
    analogue of ``runtime.supervisor.inject_failure_at``): the attached
    ``CheckpointCoordinator`` kills volatile state and recovers from the
    last completed epoch in ``mode`` ("warmed" | "cold")."""
    coord = engine.coordinator
    if not isinstance(coord, CheckpointCoordinator):
        raise RuntimeError("attach a CheckpointCoordinator before "
                           "injecting failures")
    engine.sim.at(at, coord.fail, mode, down_time, replay_speedup,
                  warmup_lead)
