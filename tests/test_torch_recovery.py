# The port's twin of tests/test_recovery.py: `repro.` -> `repro_torch.`
"""Fault-tolerance plane tests (DESIGN.md §7): barrier alignment,
epoch-numbered snapshots, failure injection at adversarial points, and
prefetch-warmed recovery.

Quick by design (sub-second to few-second discrete-event runs): tier-1.
"""
from collections import defaultdict

import pytest

from repro_torch.streaming.backend import IN_MEMORY, LOCAL_NVME, StateBackend
from repro_torch.streaming.engine import (Engine, MapOp, SinkOp, SourceOp,
                                    StatefulOp)
from repro_torch.streaming.events import Tuple_, WindowKey
from repro_torch.streaming.nexmark import NexmarkConfig, build_query
from repro_torch.streaming.recovery import (CheckpointCoordinator, SnapshotStore,
                                      inject_failure_at)
from repro_torch.streaming.windows import WindowAssigner, WindowedStatefulOp


def _noop_gen(now):
    return (int(now * 1000) % 7, {"v": 1}, 100)


def _q5_engine(rate=3_000, seed=7, late_prob=0.0, oo_bound=0.15,
               interval=0.4, **kw):
    cfg = NexmarkConfig(rate=rate, active_window=1.0, oo_bound=oo_bound,
                        seed=seed, late_prob=late_prob)
    eng = build_query("q5", "tac", "prefetch", cfg, cache_entries=256,
                      parallelism=2, source_parallelism=1, io_workers=4,
                      buffer_timeout=0.002, window_size=0.5,
                      window_slide=0.5, replayable=True, **kw)
    coord = CheckpointCoordinator(eng, interval=interval)
    coord.start()
    return eng, coord


def _capture_sink(eng):
    got = defaultdict(set)
    sink = eng.operators["sink"]

    def capture(sub, tup):
        got[(tup.ts, tup.key)].add(tup.payload[2])
        return 1e-6

    sink.process = capture
    return got


# ------------------------------------------------------------- alignment
def test_barrier_aligns_across_inputs_and_meters_stall():
    """A two-input operator must not snapshot until BOTH inputs
    delivered the epoch's barrier; post-barrier traffic from the early
    input is buffered behind the aligned cut and the stall is metered."""
    from repro_torch.streaming.engine import _AlignedBarrier
    from repro_torch.streaming.events import CheckpointBarrier
    eng = Engine()
    m = eng.add(MapOp(eng, "m", 1))
    m.barrier_expected = 2
    pre_b = Tuple_(0.0, "preB", None, 100)
    post_a = Tuple_(0.0, "postA", None, 100)
    # input A delivers its barrier first: alignment opens
    out = m._align_filter(0, [CheckpointBarrier(1)], ("chA", 0))
    assert out == [] and m._align[0]["arrived"] == {("chA", 0)}
    # post-barrier traffic from A buffers; pre-barrier from B flows
    assert m._align_filter(0, [post_a], ("chA", 0)) == []
    assert m._align_filter(0, [pre_b], ("chB", 0)) == [pre_b]
    eng.sim.t = 0.003
    out = m._align_filter(0, [CheckpointBarrier(1)], ("chB", 0))
    # last input reported: sentinel first, then the buffered traffic
    assert isinstance(out[0], _AlignedBarrier)
    assert out[0].epoch == 1 and out[0].buffered == 1
    assert out[0].stall == pytest.approx(0.003)
    assert out[1] is post_a
    assert m._align[0] is None


def test_barrier_end_to_end_snapshots_every_subtask():
    eng = Engine()
    a = eng.add(SourceOp(eng, "a", 1, 3000.0, _noop_gen))
    b = eng.add(SourceOp(eng, "b", 1, 2000.0, _noop_gen))
    m = eng.add(MapOp(eng, "m", 2))
    sink = eng.add(SinkOp(eng, "sink", 1))
    eng.connect(a, m)
    eng.connect(b, m)
    eng.connect(m, sink)
    assert m.barrier_expected == 2 and sink.barrier_expected == 2
    eng.sim.after(0.5, eng.trigger_checkpoint, 1)
    eng.run(duration=1.0)
    # every (operator, subtask) reached the aligned cut exactly once
    assert eng.snapshots_taken == m.parallelism + sink.parallelism


def test_coordinator_completes_epochs_and_trims_logs():
    eng, coord = _q5_engine()
    eng.run(duration=2.0)
    assert coord.epochs_completed >= 3
    assert coord.store.last_epoch == coord.epochs_completed
    # completed-epoch offsets trimmed the durable log
    src = eng.operators["source"]
    assert src.log_base[0] > 0
    # metrics surface the checkpoint block alongside the per-shard ones
    m = eng.metrics(2.0, 0.0)
    assert m["checkpoint"]["epochs_completed"] == coord.epochs_completed
    assert m["checkpoint"]["align_stall_avg"] >= 0.0


def test_backend_snapshot_delta_is_incremental_with_tombstones():
    b = StateBackend(IN_MEMORY)
    b.track_deltas = True                 # coordinator attach does this
    b.write("a", {"n": 1})
    b.write("b", {"n": 2})
    delta, deleted = b.snapshot_delta()
    assert set(delta) == {"a", "b"} and not deleted
    # mutating the live dict must not mutate the exported copy
    live = b.data["a"]
    live["n"] = 99
    assert delta["a"]["n"] == 1
    b.delete("b")
    b.write("c", {"n": 3})
    delta2, deleted2 = b.snapshot_delta()
    # incremental: "a" was not re-written since the last cut, so only
    # "c" rides the second delta; "b" leaves a tombstone
    assert set(delta2) == {"c"}
    assert deleted2 == {"b"}


# ------------------------------------------------- exactly-once recovery
@pytest.mark.parametrize("mode", ["warmed", "cold"])
def test_failure_recovery_preserves_windowed_counts(mode):
    """ISSUE 5 acceptance: a run with an injected mid-stream failure
    produces the same q5 tumbling counts as an unfailed run (exactly-once
    STATE effects; emit-path duplicates are the recorded deviation and
    are deduped by (window, key) here)."""
    def run(fail):
        eng, coord = _q5_engine()
        got = _capture_sink(eng)
        if fail:
            inject_failure_at(eng, at=1.5, mode=mode)
        eng.run(duration=4.4 if fail else 3.9)
        return got

    base, failed = run(False), run(True)
    horizon = 2.2     # window ends covered by both runs' logical streams
    compared = 0
    for (end, key), counts in base.items():
        if end > horizon:
            continue
        compared += 1
        assert failed.get((end, key)) == counts, (end, key)
    for (end, key) in failed:
        assert end > horizon or (end, key) in base, (end, key)
    assert compared > 300


def test_warmed_recovery_reissues_hints_and_prefetches():
    eng, coord = _q5_engine()
    inject_failure_at(eng, at=1.5, mode="warmed")
    m = eng.run(duration=3.0)
    rec = m["recovery"]
    assert rec["failures"] == 1
    assert rec["warmup_hints"] > 0
    assert rec["replayed"] > 0
    assert rec["last_mode"] == "warmed"
    assert rec["last_restore_bytes"] > 0
    # the source caught back up to live generation
    src = eng.operators["source"]
    assert all(d is not None for d in src.replay_done_t)


def test_cold_recovery_issues_no_warmup_hints():
    eng, coord = _q5_engine()
    inject_failure_at(eng, at=1.5, mode="cold")
    m = eng.run(duration=3.0)
    assert m["recovery"]["warmup_hints"] == 0
    assert m["recovery"]["replayed"] > 0


# ------------------------------------------------- adversarial failures
def test_failure_between_alignment_and_persist_rolls_back_epoch():
    """An epoch whose snapshots all acked but whose store write has not
    completed must NOT be restorable: the failure rolls it back and
    recovery restores the previous epoch."""
    eng, coord = _q5_engine(interval=0.5)

    fired = {}

    def fail_mid_persist(epoch):
        # called when the last ack lands, BEFORE the store write delay
        if epoch == 2 and "t" not in fired:
            fired["t"] = eng.sim.t
            coord.fail(mode="cold")

    orig = coord.on_operator_snapshot

    def spy(epoch, op, sub, payload, stall, buffered):
        orig(epoch, op, sub, payload, stall, buffered)
        if coord.pending is not None and epoch == 2 \
                and set(coord.pending["acks"]) >= coord.pending["expected"]:
            fail_mid_persist(epoch)

    coord.on_operator_snapshot = spy
    eng.run(duration=2.5)
    assert "t" in fired, "epoch 2 never fully acked"
    assert coord.rolled_back == 1
    # restored from epoch 1, not the rolled-back epoch 2
    assert coord.recoveries[0]["epoch"] == 1
    # and the job keeps checkpointing afterwards
    assert coord.epochs_completed >= 2


def test_migration_and_epoch_serialize():
    """A migration requested while an epoch is in flight is deferred to
    epoch completion; a trigger landing mid-migration is deferred too —
    no epoch cut ever straddles an ownership flip (§9 ∩ §7)."""
    cfg = NexmarkConfig(rate=3000, active_window=1.0, oo_bound=0.2, seed=7)
    eng = build_query("q7", "tac", "prefetch", cfg, cache_entries=256,
                      parallelism=2, source_parallelism=1, io_workers=4,
                      buffer_timeout=0.002, window_size=0.5, n_shards=8,
                      replayable=True)
    coord = CheckpointCoordinator(eng, interval=0.3)
    coord.start()
    st = eng.operators["stateful"]

    # force "epoch in flight" and request a migration: it must queue
    coord.pending = {"epoch": 99, "t0": 0.0, "offsets": {}, "acks": {},
                     "expected": {("x", 0)}, "bytes": 0}
    eng.migrate_shard("stateful", 0, 1)
    assert coord._queued_migrations == [("stateful", 0, 1)]
    assert not st.shards.migrating
    coord.pending = None

    # force "migration in flight" and trigger: it must defer
    st.shards.migrating[3] = 1
    before = coord.deferred_triggers
    coord.trigger()
    assert coord.deferred_triggers == before + 1
    assert coord.pending is None
    st.shards.migrating.clear()

    # end-to-end: barrier racing a real mid-run migration still converges
    eng.migrate_shard("stateful", 0, 1, at=0.45)
    m = eng.run(duration=1.6, warmup=0.4)
    assert st.shards.migrations == 1
    assert coord.epochs_completed >= 2
    assert m["stateful_fires"] > 0


def test_late_tuples_straddle_restore_with_lateness_preserved():
    """§10 allowed-lateness semantics across recovery: late tuples in the
    replayed/post-restore stream still take the drop/update paths against
    the RESTORED window registry, and restored fired windows do not
    refire."""
    # lateness horizon (0.1) tighter than the late tail (up to 2x the
    # 0.2 oo bound): some late tuples update, others drop
    eng, coord = _q5_engine(late_prob=0.05, oo_bound=0.2,
                            allowed_lateness=0.1)
    inject_failure_at(eng, at=1.5, mode="warmed")
    m = eng.run(duration=4.0)
    st = eng.operators["stateful"]
    assert m["recovery"]["failures"] == 1
    assert st.late_updates > 0            # q5 late-side updates still flow
    assert st.late_dropped > 0            # beyond-horizon drops still flow
    assert st.fires > 0


def test_restored_fired_registry_blocks_refire_and_keeps_update_path():
    """Unit: a window registry snapshot taken after a fire, restored into
    a fresh incarnation, must (a) not refire the fired key on the next
    watermark, (b) route a late tuple for it through the late-update
    path."""
    eng = Engine()
    win = WindowedStatefulOp(
        eng, "w", 1, WindowAssigner(1.0),
        lambda t, a: (a or 0) + 1, lambda k, wid, end, acc: ("c", k, acc),
        IN_MEMORY, 10_000, policy="tac", mode="sync", state_size=100,
        allowed_lateness=0.5, late_policy="update")
    win.windows[0][0] = {"keys": {7}, "fired": True, "fired_keys": {7}}
    extra = win.snapshot_extra(0)
    win.reset_volatile()
    assert win.windows[0] == {}
    win.restore_extra(0, extra)
    assert win.windows[0][0]["fired_keys"] == {7}
    batches = []
    win.deliver_batch = lambda sub, batch, origin=None: \
        batches.append(batch)
    win.on_watermark(0, 1.2)
    assert batches == []                  # no refire of the restored key
    outs = []
    win.emit = lambda sub, msg: outs.append(msg)
    win._apply(0, Tuple_(0.9, WindowKey(7, 0), {"k": 7}, 100, 0.9), 1)
    assert win.late_updates == 1 and len(outs) == 1


def test_interval_join_registry_rides_snapshot():
    """q20 path: retention deadlines and purge marks restore with the
    epoch, so expiry resumes and dead keys stay dead (§11 ∩ §7)."""
    from repro_torch.streaming.joins import IntervalJoinOp
    eng = Engine()
    j = IntervalJoinOp(eng, "j", 1, lambda p: p["s"],
                       lambda k, l, r: (l, r), (0.0, 5.0), IN_MEMORY,
                       10_000, policy="tac", mode="sync", state_size=100)
    j.retention[0] = {"k1": 7.5, "k2": 3.0}
    j._purged[0] = {"dead"}
    extra = j.snapshot_extra(0)
    j.reset_volatile()
    assert j.retention[0] == {} and j._purged[0] == set()
    j.restore_extra(0, extra)
    assert j.retention[0] == {"k1": 7.5, "k2": 3.0}
    assert j._purged[0] == {"dead"}


def test_q20_interval_join_failure_recovery_end_to_end():
    cfg = NexmarkConfig(rate=5_000, active_window=6.0, oo_bound=0.25,
                        seed=7)
    eng = build_query("q20", "tac", "prefetch", cfg, cache_entries=256,
                      parallelism=2, source_parallelism=1, io_workers=2,
                      buffer_timeout=0.0005, allowed_lateness=0.1,
                      replayable=True)
    coord = CheckpointCoordinator(eng, interval=0.4)
    coord.start()
    inject_failure_at(eng, at=1.6, mode="warmed")
    m = eng.run(duration=3.2)
    assert m["recovery"]["failures"] == 1
    assert m["recovery"]["warmup_hints"] > 0
    assert m["join_joined"] > 0
    assert m["n_outputs"] > 0


# ------------------------------------------------------- engine plumbing
def test_channel_never_reorders_across_batch_sizes():
    """A small batch flushed just after a large one must not overtake it
    (the per-message delay term would otherwise reorder): barriers and
    watermarks rely on per-(src,dst) FIFO."""
    from repro_torch.streaming.engine import Channel

    class _Dst:
        parallelism = 1

        def __init__(self):
            self.seen = []

        def deliver_batch(self, sub, batch, origin=None):
            self.seen.extend(batch)

    eng = Engine()
    dst = _Dst()
    ch = Channel(eng.sim, dst, "data", lambda k, n: 0, 1)
    big = [Tuple_(0.0, i, None, 200) for i in range(60)]
    for t in big:                          # > 8 KiB: size-flush
        ch.send(0, t)
    ch.send(0, Tuple_(0.0, "tail", None, 10))
    ch._flush(0, 0)                        # tiny batch right behind
    eng.sim.run_until(1.0)
    assert [m.key for m in dst.seen][:60] == [t.key for t in big]
    assert dst.seen[-1].key == "tail"


def test_inflight_writeback_readable_until_landed():
    """Memtable semantics: a dirty entry popped for async write-back must
    stay readable — a fetch racing the write-back otherwise reads the
    backend's stale copy and loses the in-flight updates."""
    eng = Engine()
    outs = []

    def apply_fn(tup, state):
        s = dict(state)
        s["n"] += 1
        return s, []

    st = eng.add(StatefulOp(eng, "s", 1, apply_fn, LOCAL_NVME,
                            cache_capacity=100, policy="lru", mode="async",
                            io_workers=1, state_size=100,
                            default_state=lambda k: {"n": 0}))
    # key A dirty in cache with 5 applied updates; backend still stale
    st.caches[0].write("A", {"n": 5}, 1.0, size=100)
    st.backends[0].write("A", {"n": 0}, 100)
    # capacity 100 = one entry: inserting B evicts A to the write-back
    # path; _io_kick pops it into the in-flight memtable
    st.caches[0].insert("B", {"n": 0}, 1.0, size=100)
    st._io_kick(0)
    assert "A" in st.wb_pending[0]
    # a tuple for A arriving NOW must see n=5, not the backend's n=0
    st._on_data(0, Tuple_(2.0, "A", {}, 100, 2.0))
    eng.sim.run_until(0.1)
    assert st.caches[0].lookup("A", 3.0)["n"] == 6


def test_snapshot_store_persists_to_disk_via_async_writer(tmp_path):
    store = SnapshotStore(directory=str(tmp_path))
    store.persist(1, {"t0": 0.0, "offsets": {}, "bytes": 10,
                      "ops": {("s", 0): {"delta": {"k": 1},
                                         "deleted": set()}}})
    store.persist(2, {"t0": 0.5, "offsets": {}, "bytes": 10,
                      "ops": {("s", 0): {"delta": {"k": 2},
                                         "deleted": set()}}})
    store.wait()
    assert store.materialized[("s", 0)] == {"k": 2}
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["epoch_00000001", "epoch_00000002"]
    import pickle
    with open(tmp_path / "epoch_00000002" / "record.pkl", "rb") as f:
        rec = pickle.load(f)
    assert rec["epoch"] == 2


def test_trigger_defers_through_post_migration_quiesce():
    """A trigger landing in the forwarding tail right after a migration
    LANDS must defer: stale-partitioned tuples forwarded around the flip
    bypass alignment, so the cut waits for the tail to drain."""
    cfg = NexmarkConfig(rate=2000, active_window=1.0, oo_bound=0.2, seed=7)
    eng = build_query("q7", "tac", "prefetch", cfg, cache_entries=256,
                      parallelism=2, source_parallelism=1, io_workers=4,
                      buffer_timeout=0.002, window_size=0.5, n_shards=8,
                      replayable=True)
    coord = CheckpointCoordinator(eng, interval=10.0)   # manual triggers
    st = eng.operators["stateful"]
    st.shards.last_finish_t = 5.0
    eng.sim.t = 5.0001                   # just after the landing
    before = coord.deferred_triggers
    coord.trigger()
    assert coord.deferred_triggers == before + 1 and coord.pending is None
    eng.sim.t = 5.0 + 0.002 + 1.0        # tail drained
    coord.trigger()
    assert coord.pending is not None


def test_inflight_writeback_rides_migration():
    """Cross-subtask face of the memtable race: a dirty entry whose
    write-back is in flight at migration time left the eviction buffer,
    so the drain must carry its LATEST state to the destination."""
    from repro_torch.streaming.shards import ShardPlane

    def apply_fn(tup, state):
        return state, []

    eng = Engine()
    plane = ShardPlane(4, 2)
    st = eng.add(StatefulOp(eng, "s", 2, apply_fn, LOCAL_NVME,
                            cache_capacity=100, policy="tac", mode="async",
                            io_workers=1, state_size=100,
                            default_state=lambda k: {"n": 0},
                            shards=plane))
    key = next(k for k in range(100) if plane.shard_of(k) == 0)
    src = plane.owner[0]
    st.backends[src].write(key, {"n": 0}, 100)       # stale durable copy
    st.caches[src].write(key, {"n": 7}, 1.0, size=100)
    # evict the dirty entry and pop it into the in-flight write lane
    st.caches[src].insert("filler", {}, 1.0, size=100)
    st._io_kick(src)
    assert key in st.wb_pending[src]
    assert not st.caches[src].contains(key)
    st.migrate_shard(0, 1 - src)
    eng.sim.run_until(0.1)               # transfer + write-back land
    # the destination cache got n=7, not the stale backend n=0
    assert st.caches[1 - src].lookup(key, 2.0)["n"] == 7
    # and the in-flight write landed at the destination's partition
    assert st.backends[1 - src].data[key]["n"] == 7


def test_delta_tracking_off_without_coordinator():
    """Runs that never checkpoint must not accumulate delta/tombstone
    sets (unbounded growth over purged panes); coordinator attach flips
    tracking on for every backend."""
    b = StateBackend(IN_MEMORY)
    b.write("a", {"n": 1})
    b.delete("a")
    assert not b._epoch_dirty and not b._epoch_deleted
    eng, coord = _q5_engine()
    st = eng.operators["stateful"]
    assert all(bk.track_deltas for bk in st.backends)


def test_overlapping_trigger_epochs_do_not_wedge_alignment():
    """Two back-to-back trigger_checkpoint calls (no coordinator, which
    would serialize them): a later epoch's barrier arriving while an
    earlier alignment is open buffers and re-opens cleanly — every
    subtask snapshots once per epoch and traffic keeps flowing."""
    eng = Engine()
    a = eng.add(SourceOp(eng, "a", 1, 3000.0, _noop_gen))
    b = eng.add(SourceOp(eng, "b", 1, 2000.0, _noop_gen))
    m = eng.add(MapOp(eng, "m", 2))
    sink = eng.add(SinkOp(eng, "sink", 1))
    eng.connect(a, m)
    eng.connect(b, m)
    eng.connect(m, sink)
    eng.sim.after(0.5, eng.trigger_checkpoint, 1)
    eng.sim.after(0.5001, eng.trigger_checkpoint, 2)   # overlaps epoch 1
    res = eng.run(duration=1.5)
    # both epochs reached every (operator, subtask) — nothing wedged
    assert eng.snapshots_taken == 2 * (m.parallelism + sink.parallelism)
    assert all(al is None for al in m._align)
    # and the pipeline kept producing after the overlap
    assert res["n_outputs"] > 0
    late = [t for t in eng.latency_t if t > 0.6]
    assert late, "no sink output after the overlapping epochs"
