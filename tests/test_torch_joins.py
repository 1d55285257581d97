# The port's twin of tests/test_joins.py: `repro.` -> `repro_torch.`
"""Stream-stream join tests (DESIGN.md §11).

Quick by design (sub-second discrete-event runs, unit-level races):
tier-1 loop, like test_windows.py.
"""
import pytest

from repro_torch.streaming.backend import IN_MEMORY, LOCAL_NVME
from repro_torch.streaming.engine import Engine, MapOp, SinkOp, SourceOp
from repro_torch.streaming.events import Hint, Tuple_, Watermark
from repro_torch.streaming.joins import (LEFT, RIGHT, IntervalJoinOp,
                                   JoinLookaheadOp, WindowedJoinOp)
from repro_torch.streaming.nexmark import NexmarkConfig, build_query
from repro_torch.streaming.windows import WindowAssigner


# --------------------------------------------------------------- helpers
class _CollectSink(SinkOp):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.got = []

    def process(self, sub, tup):
        self.got.append((tup.key, tup.payload))
        return super().process(sub, tup)


def _mk_interval(eng, lo=0.0, hi=1.0, lateness=0.0, mode="sync",
                 parallelism=1, shards=None, **kw):
    kw.setdefault("backend_model", IN_MEMORY)
    return IntervalJoinOp(
        eng, "join", parallelism,
        side_of=lambda p: p.get("side"),
        join_fn=lambda key, l, r: ("match", l["v"], r["v"]),
        bounds=(lo, hi), cache_capacity=1_000_000,
        allowed_lateness=lateness, policy="tac", mode=mode,
        state_size=100, shards=shards, **kw)


def _interval_pipeline(eng, gen, rate=2000.0, lo=0.0, hi=0.5,
                       lateness=0.0, oo_bound=0.0):
    src = eng.add(SourceOp(eng, "src", 1, rate, gen,
                           watermark_interval=0.05, oo_bound=oo_bound))
    join = eng.add(_mk_interval(eng, lo=lo, hi=hi, lateness=lateness))
    sink = eng.add(_CollectSink(eng, "sink", 1))
    eng.connect(src, join)
    eng.connect(join, sink, partition=lambda k, n: 0)
    return join, sink


def _lr(side, v):
    return {"side": side, "v": v}


# -------------------------------------------------- interval correctness
def test_interval_join_matches_within_bounds():
    """Pairs with r.ts - l.ts in [lo, hi] match regardless of arrival
    order; pairs outside do not."""
    eng = Engine()
    seq = [  # (delay_index, key, side, ts_offset)
        (0, "k", LEFT, 0.00),
        (1, "k", RIGHT, 0.10),    # in  [0, 0.5]  -> match
        (2, "k", RIGHT, 0.60),    # out (> hi)    -> no match
        (3, "j", RIGHT, 0.05),    # right before its left (out of order)
        (4, "j", LEFT, 0.02),     # matches the buffered right (0.03 in)
    ]
    emitted = {"i": 0}

    def gen(now):
        i = emitted["i"]
        if i >= len(seq):
            return None
        emitted["i"] += 1
        _, key, side, off = seq[i]
        return (key, _lr(side, i), 100, off)

    # oo_bound covers the fixture's event-time spread so the watermark
    # never classifies the deliberately out-of-order arrivals as late
    join, sink = _interval_pipeline(eng, gen, rate=100.0, hi=0.5,
                                    oo_bound=1.0)
    eng.run(duration=1.0)
    assert join.joined == 2
    vals = sorted(p[1:] for _, p in sink.got)
    assert vals == [(0, 1), (4, 3)]


def test_interval_join_one_sided_only_arrivals_expire_silently():
    """Left entries that never see a right partner produce no output and
    their keys purge — cache drop + backend delete, no write-back — once
    the watermark passes their retention deadline."""
    eng = Engine()
    n = {"i": 0}

    def gen(now):
        n["i"] += 1
        return (n["i"], _lr(LEFT, n["i"]), 100)    # unique keys, left only

    join, sink = _interval_pipeline(eng, gen, rate=500.0, hi=0.1)
    eng.run(duration=1.0)
    assert join.joined == 0 and sink.got == []
    assert join.keys_expired > 0
    # purged keys are gone everywhere: registry, cache, and backend
    assert sum(len(r) for r in join.retention) < 500 * 1.0
    assert join.backends[0].writes == 0 or \
        len(join.backends[0].data) < join.keys_expired
    assert join.caches[0].writebacks == 0    # purge never stages write-back


def test_interval_join_late_inside_and_outside_lateness():
    """A tuple whose retention deadline is inside the allowed-lateness
    horizon still joins (late join); beyond the horizon it drops."""
    eng = Engine()
    seq = [
        (0, "k", LEFT, 0.00),     # left at ts 0, deadline 0.1
        (1, "k", RIGHT, 0.05),    # on-time match
    ]
    # after the watermark passes ~0.5: a right at ts=0.08 has deadline
    # 0.08; with lateness 0.5 it is INSIDE the horizon -> late join;
    # with lateness 0 it is outside -> dropped
    extra = [("k", RIGHT, 0.08)]
    state = {"i": 0, "x": 0}

    def gen(now):
        if state["i"] < len(seq):
            i = state["i"]
            state["i"] += 1
            _, key, side, off = seq[i]
            return (key, _lr(side, i), 100, off)
        if now > 0.5 and state["x"] < len(extra):
            key, side, off = extra[state["x"]]
            state["x"] += 1
            return (key, _lr(side, 90 + state["x"]), 100, off)
        return (999, _lr(LEFT, -1), 50, now)       # watermark driver
    join, sink = _interval_pipeline(eng, gen, rate=200.0, hi=0.1,
                                    lateness=0.5)
    eng.run(duration=1.0)
    assert join.joined == 2
    assert join.late_joins >= 1

    # same shape with zero lateness: the straggler drops
    eng2 = Engine()
    state["i"], state["x"] = 0, 0
    join2, sink2 = _interval_pipeline(eng2, gen, rate=200.0, hi=0.1,
                                      lateness=0.0)
    eng2.run(duration=1.0)
    assert join2.joined == 1
    assert join2.late_dropped >= 1


def test_interval_expiry_races_in_flight_prefetch():
    """A key expiring while its prefetch is in flight: the completion
    must be dropped (no resurrection in cache or backend) and tuples
    parked on it count late."""
    eng = Engine()
    join = eng.add(_mk_interval(eng, hi=0.1, mode="prefetch",
                                backend_model=LOCAL_NVME))
    join.managers[0].enabled = True
    # a left entry registers the key with deadline 0.1
    join.deliver_batch(0, [Tuple_(0.0, "k", _lr(LEFT, 1), 100, 0.0)])
    eng.sim.run_until(0.01)
    assert "k" in join.retention[0]
    # evict the resident entry so a hint must schedule a real prefetch
    join.caches[0].drop("k")
    join.handle(0, Hint("k", 0.05, origin="la"))
    assert "k" in join.in_flight[0]
    # a data tuple parks on the same in-flight key
    join.waiting[0]["k"].append(Tuple_(0.05, "k", _lr(RIGHT, 2), 100, 0.05))
    # watermark passes the retention deadline before the I/O completes
    join._recv_watermark(0, Watermark(5.0, origin=("c", 0)))
    join.on_watermark(0, 5.0)
    assert "k" not in join.retention[0]
    assert "k" in join._purged[0]
    before_late = join.late_dropped
    eng.sim.run_until(1.0)                   # let the fetch complete
    assert not join.caches[0].contains("k")  # completion dropped
    assert "k" not in join.backends[0].data
    assert join.late_dropped == before_late + 1   # parked tuple was late
    assert "k" not in join.in_flight[0]


def test_keys_with_all_entries_declined_still_expire():
    """A key whose tuples keep_fn all declines still materializes
    (empty) state on the read path; the retention registry must learn it
    anyway so the watermark purge reclaims it."""
    eng = Engine()
    join = eng.add(_mk_interval(eng, hi=0.1, mode="sync",
                                keep_fn=lambda side, p: False))
    join.deliver_batch(0, [Tuple_(1.0, "k", _lr(LEFT, 1), 100, 1.0)])
    eng.sim.run_until(0.01)
    assert join.retention[0]["k"] == pytest.approx(1.1)
    join.on_watermark(0, 5.0)
    assert "k" not in join.retention[0]
    assert "k" not in join.backends[0].data
    assert not join.caches[0].contains("k")


def test_interval_key_rebirth_clears_purge_mark():
    """New data for a purged key revives it: its I/O is valid again and
    the retention registry re-learns the deadline."""
    eng = Engine()
    join = eng.add(_mk_interval(eng, hi=0.1, mode="sync"))
    join._purged[0].add("k")
    join.deliver_batch(0, [Tuple_(10.0, "k", _lr(LEFT, 1), 100, 10.0)])
    eng.sim.run_until(0.01)
    assert "k" not in join._purged[0]
    assert join.retention[0]["k"] == pytest.approx(10.1)


# ----------------------------------------------------------- windowed q8
def test_windowed_join_fires_cogrouped_panes():
    """Co-grouped pane fires emit only when both sides are present in
    the (key, window); one-sided panes count as unmatched."""
    eng = Engine()
    assigner = WindowAssigner(0.2)
    seq = {"i": 0}

    def gen(now):
        i = seq["i"]
        seq["i"] += 1
        key = i % 4
        # keys 0/1 get both sides, 2 only left, 3 only right
        side = LEFT if (key in (0, 1) and i % 8 < 4) or key == 2 \
            else RIGHT
        return (key, _lr(side, i), 100)

    src = eng.add(SourceOp(eng, "src", 1, 2000.0, gen,
                           watermark_interval=0.05, oo_bound=0.0))
    join = eng.add(WindowedJoinOp(
        eng, "join", 1, assigner,
        side_of=lambda p: p.get("side"),
        join_fn=lambda key, L, R: ("both", key, len(L), len(R)),
        backend_model=IN_MEMORY, cache_capacity=1_000_000,
        policy="tac", mode="sync", state_size=100))
    sink = eng.add(_CollectSink(eng, "sink", 1))
    eng.connect(src, join)
    eng.connect(join, sink, partition=lambda k, n: 0)
    eng.run(duration=1.0)
    assert join.joined > 0
    assert join.unmatched[LEFT] > 0 and join.unmatched[RIGHT] > 0
    keys = {k for k, _ in sink.got}
    assert keys <= {0, 1}                    # only two-sided panes emit


def test_q8_end_to_end_with_prefetch():
    cfg = NexmarkConfig(rate=4000, active_window=1.0, oo_bound=0.2, seed=7)
    eng = build_query("q8", "tac", "prefetch", cfg, cache_entries=256,
                      parallelism=2, source_parallelism=1, io_workers=4,
                      buffer_timeout=0.002, window_size=0.5)
    m = eng.run(duration=2.0, warmup=0.5)
    assert m["join_fires"] > 0 and m["join_joined"] > 0
    assert m["join_hints_received"] > 0
    assert m["join_prefetch_hits"] > 0
    assert m["n_outputs"] > 0
    assert eng.controller.active["join"] == "join_lookahead"


# ------------------------------------------------------------ lookaheads
def test_join_lookahead_one_sided_suppresses_build_side():
    eng = Engine()
    la = JoinLookaheadOp(eng, "la", 1,
                         side_of=lambda p: p.get("side"),
                         key_of=lambda t: t.key,
                         hint_sides=(RIGHT,), bounds=(0.0, 1.0),
                         probe_ahead=0.5)
    la.hint_active = True
    hints = []
    la.emit_hint = lambda sub, h: hints.append(h)
    la._emit_hints_for(0, Tuple_(1.0, "k", _lr(LEFT, 1), 100, 1.0))
    assert hints == [] and la.side_suppressed == 1
    la._emit_hints_for(0, Tuple_(1.0, "k", _lr(RIGHT, 2), 100, 1.0))
    assert len(hints) == 1 and la.side_hints[RIGHT] == 1


def test_join_lookahead_interval_deadline_capped_at_probe_ahead():
    """Build-side hints carry the predicted FIRST probe time (capped
    retention deadline), never the full interval end (which would pin
    the key for its whole matchable life) and never less than the
    tuple's own access time."""
    eng = Engine()
    la = JoinLookaheadOp(eng, "la", 1,
                         side_of=lambda p: p.get("side"),
                         key_of=lambda t: t.key,
                         bounds=(0.0, 30.0), probe_ahead=0.5)
    la.hint_active = True
    hints = []
    la.emit_hint = lambda sub, h: hints.append(h)
    la._emit_hints_for(0, Tuple_(10.0, "a", _lr(LEFT, 1), 100, 10.0))
    assert hints[-1].ts == pytest.approx(10.5)     # not 40.0
    la._emit_hints_for(0, Tuple_(10.0, "b", _lr(RIGHT, 2), 100, 10.0))
    assert hints[-1].ts == pytest.approx(10.0)     # floored at access ts
    # arrival ablation: plain event ts on both sides
    la.hint_ts_mode = "arrival"
    la._emit_hints_for(0, Tuple_(20.0, "c", _lr(LEFT, 3), 100, 20.0))
    assert hints[-1].ts == pytest.approx(20.0)


def test_join_lookahead_requires_exactly_one_kind():
    eng = Engine()
    with pytest.raises(ValueError):
        JoinLookaheadOp(eng, "la", 1, side_of=lambda p: LEFT,
                        key_of=lambda t: t.key)
    with pytest.raises(ValueError):
        JoinLookaheadOp(eng, "la2", 1, side_of=lambda p: LEFT,
                        key_of=lambda t: t.key,
                        assigner=WindowAssigner(1.0), bounds=(0.0, 1.0))
    with pytest.raises(ValueError):          # deadline mode needs a cap
        JoinLookaheadOp(eng, "la3", 1, side_of=lambda p: LEFT,
                        key_of=lambda t: t.key, bounds=(0.0, 1.0))


# ------------------------------------------------------------ shard plane
def test_cross_side_hint_mid_migration():
    """A cross-side hint arriving while its shard's state is in transit
    parks at the new owner and still triggers its prefetch there; the
    retention registry migrates with the shard."""
    from repro_torch.streaming.shards import ShardPlane
    eng = Engine()
    plane = ShardPlane(4, 2)
    join = eng.add(_mk_interval(eng, hi=5.0, mode="prefetch",
                                parallelism=2, shards=plane,
                                backend_model=LOCAL_NVME))
    for mgr in join.managers:
        mgr.enabled = True
    # key 0 lives in shard 0, owned by sub 0; register it with a deadline
    join.deliver_batch(0, [Tuple_(0.0, 0, _lr(LEFT, 1), 100, 0.0)])
    eng.sim.run_until(0.01)
    assert join.retention[0][0] == pytest.approx(5.0)
    # start migrating shard 0 -> sub 1 (state in transit)
    join.migrate_shard(0, 1)
    assert 0 in plane.migrating
    assert join.retention[1][0] == pytest.approx(5.0)  # registry moved
    assert 0 not in join.retention[0]
    # a cross-side hint for the migrating key lands at the NEW owner and
    # parks (shard guard), then replays after re-admission
    join.deliver_batch(1, [Hint(0, 1.0, origin="la")])
    eng.sim.run_until(0.02)
    assert plane.parked_in_migration >= 1
    eng.sim.run_until(0.5)                    # transfer + replay complete
    assert 0 not in plane.migrating
    assert join.managers[1].hints_received >= 1
    # the replayed hint's prefetch ran at the destination
    assert join.caches[1].contains(0) or 0 in join.in_flight[1]


def test_q20_interval_join_end_to_end_sharded_migration():
    """q20 on the sharded plane with a mid-run rebalance keeps joining
    and expiring across the move."""
    cfg = NexmarkConfig(rate=6000, active_window=2.0, oo_bound=0.2, seed=7)
    eng = build_query("q20", "tac", "prefetch", cfg, cache_entries=128,
                      parallelism=2, source_parallelism=1, io_workers=4,
                      buffer_timeout=0.002, n_shards=8,
                      allowed_lateness=0.1)
    eng.migrate_shard("join", 0, 1, at=0.9)
    m = eng.run(duration=1.8, warmup=0.5)
    join = eng.operators["join"]
    assert join.shards.migrations == 1
    assert m["join_joined"] > 0
    assert m["join_keys_expired"] > 0
    assert m["n_outputs"] > 0


def test_q20_without_event_time_keeps_legacy_plan():
    """cfg.oo_bound == 0 keeps the original processing-time incremental
    q20 (the paper-figure baseline): a plain StatefulOp, no join op."""
    cfg = NexmarkConfig(rate=1000)
    eng = build_query("q20", "lru", "sync", cfg)
    assert "join" not in eng.operators
    assert "stateful" in eng.operators


def test_interval_join_rejects_bad_bounds():
    eng = Engine()
    with pytest.raises(ValueError):
        _mk_interval(eng, lo=2.0, hi=1.0)
