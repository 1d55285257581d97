"""The port's fused plane (``repro_torch.streaming.fused``) on the CPU,
through the harness of tests/test_fused.py: each case runs the port's
interpreted and fused operators and the reference package's fused
operator on the same tuple stream under the QUIESCED protocol, and
state, emitted tuples and the §12 counter totals must all be bit-equal.
Then the slice as a whole: NEXMark q5/q7 and YSB built fused by both
packages must agree on outputs, latency percentiles (simulated time),
hit rate and the fused rollup.
"""
import importlib
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from _hypothesis_compat import given, settings, st  # noqa: E402
from _torch_port import one_thread  # noqa: E402,F401

def mods(pkg):
    def m(name):
        return importlib.import_module(f"{pkg}.streaming.{name}")
    return m("backend"), m("engine"), m("events"), m("fused"), m("windows")


def fused_kw(pkg, spec, batch):
    kw = dict(fused=spec, fused_batch=batch)
    if pkg == "repro_torch":
        kw["device"] = "cpu"
    return kw


def count_spec(pkg):
    return mods(pkg)[3].FusedSpec(
        kind="sum", width=1, weight_of=lambda tup: 1.0,
        encode=lambda s: None if s is None else [float(s)],
        decode=lambda v: int(round(float(v[0]))))


def max_spec(pkg):
    return mods(pkg)[3].FusedSpec(
        kind="max", width=1, weight_of=lambda tup: float(tup.payload),
        encode=lambda s: None if s is None else [float(s)],
        decode=lambda v: int(round(float(v[0]))))


def _counters(op):
    cache = op.caches[0]
    return dict(hits=cache.hits, misses=cache.misses,
                evictions=cache.evictions, writebacks=cache.writebacks,
                by_reason=cache.eviction_block(), processed=op.processed,
                outputs=op.outputs, pf_demand=op.pf_demand.value)


def _final_state(op, state_size):
    for e in op.caches[0].flush_dirty():
        op.backends[0].write(e.key, e.state, state_size)
    return dict(op.backends[0].data)


# ------------------------------------------------------------ base operator
def run_base(pkg, keys, fused, cache_entries=8, batch=8):
    backend, engine, events, _, _ = mods(pkg)
    eng = engine.Engine()
    kw = dict(policy="tac", mode="async", cache_capacity=cache_entries * 64,
              state_size=64, io_workers=2)
    if fused:
        kw.update(fused_kw(pkg, count_spec(pkg), batch))

    def apply_count(tup, state):
        return ((state or 0) + 1, [])

    op = engine.StatefulOp(eng, "agg", 1, apply_count, backend.LOCAL_NVME,
                           **kw)
    eng.add(op)
    t = 0.0
    for i in range(0, len(keys), 6):
        op.deliver_batch(0, [events.Tuple_(float(j), keys[j], None, 64, 0.0)
                             for j in range(i, min(i + 6, len(keys)))])
        t += 0.05
        eng.sim.run_until(t)
    eng.sim.run_until(t + 1.0)
    return _final_state(op, 64), _counters(op)


def assert_base_parity(keys):
    interp = run_base("repro_torch", keys, fused=False)
    port = run_base("repro_torch", keys, fused=True)
    ref = run_base("repro", keys, fused=True)
    assert port == interp, f"port fused vs interpreted\n{port}\n{interp}"
    assert port == ref, f"port fused vs reference fused\n{port}\n{ref}"
    return port[1]


def test_base_parity_with_evictions_and_parking():
    keys = [1, 2, 3, 1, 1, 4, 2, 9, 9, 1, 5, 6, 7, 8, 10, 11, 1, 2, 12, 1]
    ci = assert_base_parity(keys)
    assert ci["evictions"] > 0
    assert ci["pf_demand"] > 0


def test_base_parity_single_hot_key():
    assert_base_parity([7] * 23)


def test_base_parity_all_distinct():
    assert_base_parity(list(range(30)))


@settings(max_examples=8, deadline=None)
@given(st.lists(st.integers(min_value=0, max_value=12),
                min_size=1, max_size=40))
def test_base_parity_property(keys):
    assert_base_parity(keys)


# -------------------------------------------------------- windowed operator
def collect_sink(engine, eng):
    """A sink of ``engine``'s package that records (ts, key, payload)."""
    class Collect(engine.SinkOp):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.got = []

        def process(self, sub, tup):
            self.got.append((tup.ts, tup.key, tup.payload))
            return super().process(sub, tup)
    return Collect(eng, "sink", 1)


def run_windowed(pkg, keys_ts, fused, lateness, late_policy, size=10.0,
                 cache_entries=6, batch=8, wm_lag=6.0, max_kind=False):
    backend, engine, events, _, windows = mods(pkg)
    eng = engine.Engine()
    kw = dict(policy="tac", mode="async", cache_capacity=cache_entries * 64,
              state_size=64, io_workers=2, allowed_lateness=lateness,
              late_policy=late_policy)
    if max_kind:
        def agg(tup, state):
            p = tup.payload
            return p if state is None or p > state else state

        def emit(base, wid, end, acc):
            return ("max", base, acc) if acc is not None else None

        def payload_of(k, ts):
            return (k * 7919 + int(ts * 10)) % 9973 + 1
        spec = max_spec(pkg)
    else:
        def agg(tup, state):
            return (state or 0) + 1

        def emit(base, wid, end, acc):
            return ("count", base, acc) if acc else None
        payload_of = None
        spec = count_spec(pkg)
    if fused:
        kw.update(fused_kw(pkg, spec, batch))
    op = windows.WindowedStatefulOp(eng, "win", 1,
                                    windows.WindowAssigner(size), agg, emit,
                                    backend.LOCAL_NVME, **kw)
    sink = collect_sink(engine, eng)
    eng.add(op)
    eng.add(sink)
    eng.connect(op, sink)
    t = 0.0
    hi = 0.0
    for i in range(0, len(keys_ts), 6):
        chunk = keys_ts[i:i + 6]
        op.deliver_batch(0, [
            events.Tuple_(ts, k, payload_of(k, ts) if payload_of else None,
                          64, 0.0) for k, ts in chunk])
        hi = max([hi] + [ts for _, ts in chunk])
        t += 0.05
        eng.sim.run_until(t)
        op.deliver_batch(0, [events.Watermark(hi - wm_lag)])
        t += 0.05
        eng.sim.run_until(t)
    op.deliver_batch(0, [events.Watermark(hi + 1000.0)])
    eng.sim.run_until(t + 2.0)
    ctr = _counters(op)
    ctr.update(fires=op.fires, late_dropped=op.late_dropped,
               late_updates=op.late_updates, purged=op.panes_purged)
    return sorted(sink.got), _final_state(op, 64), ctr


def assert_windowed_parity(keys_ts, lateness, late_policy, **kw):
    interp = run_windowed("repro_torch", keys_ts, False, lateness,
                          late_policy, **kw)
    port = run_windowed("repro_torch", keys_ts, True, lateness, late_policy,
                        **kw)
    ref = run_windowed("repro", keys_ts, True, lateness, late_policy, **kw)
    assert port == interp, f"port fused vs interpreted\n{port}\n{interp}"
    assert port == ref, f"port fused vs reference fused\n{port}\n{ref}"
    return port[2]


def _steady_stream():
    keys = [1, 2, 3, 1, 1, 4, 2, 9, 9, 1, 5, 6, 7, 8, 10, 11, 1, 2, 12, 1,
            3, 3, 5, 1, 2, 7, 9, 4, 4, 1]
    return [(k, i * 1.7) for i, k in enumerate(keys)]


def test_windowed_parity_no_lateness():
    ci = assert_windowed_parity(_steady_stream(), 0.0, "drop")
    assert ci["fires"] > 0
    assert ci["evictions"] > 0


def test_windowed_parity_update_policy_with_late_tuples():
    stream = _steady_stream()
    late = [(1, 3.0), (2, 5.0), (1, 12.0), (9, 14.0)]
    ci = assert_windowed_parity(stream[:18] + late + stream[18:], 40.0,
                                "update")
    assert ci["late_updates"] > 0


def test_windowed_parity_drop_policy_drops_late():
    stream = _steady_stream()
    late = [(1, 3.0), (2, 5.0), (1, 0.5)]
    ci = assert_windowed_parity(stream[:18] + late + stream[18:], 40.0,
                                "drop")
    assert ci["late_dropped"] > 0


def test_windowed_parity_horizon_drop():
    ci = assert_windowed_parity(_steady_stream() + [(5, 0.1), (6, 0.2)],
                                0.0, "drop")
    assert ci["late_dropped"] >= 2


def test_windowed_parity_max_kind():
    stream = [(k, i * 1.7) for i, k in enumerate(
        [1, 2, 1, 3, 1, 2, 4, 1, 5, 2, 1, 3, 6, 1, 2, 7, 1, 1])]
    assert_windowed_parity(stream, 0.0, "drop", max_kind=True)


# -------------------------------------------------------------- unit layer
def test_fused_requires_tac_policy():
    backend, engine, _, _, _ = mods("repro_torch")
    with pytest.raises(ValueError):
        engine.StatefulOp(engine.Engine(), "x", 1, lambda t, s: (s, []),
                          backend.LOCAL_NVME, cache_capacity=64,
                          policy="lru", mode="async",
                          **fused_kw("repro_torch",
                                     count_spec("repro_torch"), 8))


def test_fused_forbids_shards():
    from repro_torch.streaming.shards import ShardPlane
    backend, engine, _, _, _ = mods("repro_torch")
    with pytest.raises(ValueError):
        engine.StatefulOp(engine.Engine(), "x", 1, lambda t, s: (s, []),
                          backend.LOCAL_NVME, cache_capacity=64,
                          policy="tac", mode="async", shards=ShardPlane(2, 1),
                          **fused_kw("repro_torch",
                                     count_spec("repro_torch"), 8))


def test_fused_spec_rejects_unknown_kind():
    from repro_torch.streaming.fused import FusedSpec
    with pytest.raises(ValueError):
        FusedSpec(kind="median")


def _plane(capacity, batch):
    from repro_torch.streaming.fused import FusedPlane
    return FusedPlane(capacity, 8, count_spec("repro_torch"), batch=batch,
                      device="cpu")


def test_fusedplane_single_key_ops():
    plane = _plane(4 * 8, 4)
    assert plane.lookup("a", 1.0) is None
    plane.insert("a", 3, 1.0, dirty=True)
    assert plane.lookup("a", 2.0) == 3
    plane.write("a", 5, 3.0)
    assert plane.lookup("a", 3.0) == 5
    assert plane.contains("a")
    assert len(plane) == 1
    assert plane.drop("a")
    assert not plane.contains("a")
    assert plane.hits == 2 and plane.misses == 1


def test_fusedplane_eviction_and_writeback():
    plane = _plane(2 * 8, 4)
    plane.insert("a", 1, 1.0, dirty=True)
    plane.insert("b", 2, 2.0, dirty=True)
    plane.insert("c", 3, 3.0, dirty=True)       # evicts "a" (min ts)
    assert plane.evictions == 1
    assert plane.eviction_block() == {"capacity.demand": 1}
    assert "a" in plane.evict_buffer
    assert plane.lookup("a", 4.0) == 1
    assert plane.evictions == 2
    wb = plane.pop_writeback()
    assert wb is not None and plane.writebacks == 1


def test_fusedplane_evicts_a_landed_dirty_row_from_the_pool():
    # the victim's row reached the device before the eviction, so its
    # value comes back through a one-row pool gather
    plane = _plane(2 * 8, 4)
    plane.insert("a", 7, 1.0, dirty=True)
    plane.insert("b", 2, 2.0)
    plane._sync()
    plane.insert("c", 3, 3.0)
    assert plane.evict_buffer["a"].state == 7


def test_fusedplane_batch_step_composes_duplicates():
    from repro_torch.streaming.fused import Lane
    spec = count_spec("repro_torch")
    plane = _plane(4 * 8, 8)
    plane.insert("k", 10, 1.0, dirty=False)
    lanes = [Lane("k", 2.0, spec.weight(None), False, False, None)
             for _ in range(3)]
    res = plane.batch_step(lanes)
    assert res.hit.all()
    assert [plane.decode_lane(res, i) for i in range(3)] == [11, 12, 13]
    assert plane.lookup("k", 3.0) == 13
    assert plane.device_hits == 3 and plane.lanes == 3
    assert 0.0 < plane.fill_ratio <= 1.0
    miss = plane.batch_step(
        [Lane("nope", 4.0, spec.weight(None), False, False, None)])
    assert not miss.hit.any() and plane.device_misses == 1
    assert isinstance(res.new_vals, np.ndarray)


def test_fusedplane_flush_and_export_roundtrip():
    plane = _plane(4 * 8, 4)
    plane.insert("a", 1, 1.0, dirty=True)
    plane.insert("b", 2, 2.0, dirty=False)
    dirty = plane.flush_dirty()
    assert [e.key for e in dirty] == ["a"]
    ents = plane.export_entries(lambda k: True)
    assert {e.key for e in ents} == {"a", "b"}
    assert len(plane) == 0
    plane.import_entries(ents)
    assert plane.lookup("a", 5.0) == 1 and plane.lookup("b", 5.0) == 2


def test_fused_default_device_raises_without_cuda():
    """The default device is the card: with no CUDA device, building a
    fused plane or a fused query without ``device="cpu"`` raises instead
    of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.streaming.fused import FusedPlane
    from repro_torch.streaming.nexmark import NexmarkConfig, build_query
    from repro_torch.streaming.ysb import YSBConfig, build_ysb
    with pytest.raises(RuntimeError, match="CUDA"):
        FusedPlane(64, 8, count_spec("repro_torch"))
    with pytest.raises(RuntimeError, match="CUDA"):
        build_query("q5", "tac", "async", NexmarkConfig(oo_bound=0.3),
                    cache_entries=64, fused=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_ysb("tac", "async", YSBConfig(), cache_entries=64, fused=True)


# ---------------------------------------------------------- the whole slice
def run_slice(pkg, query):
    """A fused q5/q7/YSB run at a small size, as benchmarks/engine.py's
    full phase builds it."""
    kw = dict(device="cpu") if pkg == "repro_torch" else {}
    if query == "ysb":
        ysb = importlib.import_module(f"{pkg}.streaming.ysb")
        eng = ysb.build_ysb("tac", "async", ysb.YSBConfig(rate=2000, seed=11),
                            cache_entries=256, parallelism=2,
                            source_parallelism=1, io_workers=8, fused=True,
                            fused_batch=64, **kw)
    else:
        nx = importlib.import_module(f"{pkg}.streaming.nexmark")
        cfg = nx.NexmarkConfig(rate=2000, active_window=1.0, oo_bound=0.3,
                               seed=7)
        eng = nx.build_query(query, "tac", "async", cfg, cache_entries=256,
                             parallelism=2, source_parallelism=1,
                             io_workers=4, buffer_timeout=0.002, fused=True,
                             fused_batch=64, **kw)
    m = eng.run(duration=2.5, warmup=0.3)
    return {k: m.get(k) for k in ("n_outputs", "p50", "p99",
                                  "stateful_hit_rate", "stateful_fused")}


@pytest.mark.parametrize("query", ["q5", "q7", "ysb"])
def test_slice_matches_reference(query):
    port = run_slice("repro_torch", query)
    ref = run_slice("repro", query)
    assert port == ref
    assert port["n_outputs"] > 0
    assert port["stateful_fused"]["batches"] > 0


# a fused batch past the step kernel's old 256-lane cap
WIDE_BATCH = 1024


def run_wide(pkg, query):
    """q5 or YSB fused at batches of 1024 lanes (every step runs at the full
    width, padded), at a rate and buffer timeout that fill batches with
    tens to hundreds of lanes.  Returns the run's metrics, what the sinks
    received, each stateful operator's state (its dirty entries flushed to
    its backends) and the widest batch a plane took."""
    _, engine, _, _, _ = mods(pkg)
    kw = dict(device="cpu") if pkg == "repro_torch" else {}
    if query == "ysb":
        ysb = importlib.import_module(f"{pkg}.streaming.ysb")
        eng = ysb.build_ysb("tac", "async",
                            ysb.YSBConfig(rate=10000, seed=11),
                            cache_entries=256, parallelism=2,
                            source_parallelism=1, io_workers=8, fused=True,
                            fused_batch=WIDE_BATCH, **kw)
    else:
        nx = importlib.import_module(f"{pkg}.streaming.nexmark")
        cfg = nx.NexmarkConfig(rate=10000, active_window=1.0, oo_bound=0.3,
                               seed=7)
        eng = nx.build_query(query, "tac", "async", cfg, cache_entries=256,
                             parallelism=2, source_parallelism=1,
                             io_workers=4, buffer_timeout=0.05, fused=True,
                             fused_batch=WIDE_BATCH, **kw)
    got = []
    widest = [0]
    for op in eng.operators.values():
        if isinstance(op, engine.SinkOp):
            def process(sub, tup, name=op.name, orig=op.process):
                got.append((name, sub, tup.ts, repr(tup.key),
                            repr(tup.payload)))
                return orig(sub, tup)
            op.process = process
        if isinstance(op, engine.StatefulOp):
            for plane in op.caches:
                def batch_step(lanes, orig=plane.batch_step):
                    widest[0] = max(widest[0], len(lanes))
                    return orig(lanes)
                plane.batch_step = batch_step
    m = eng.run(duration=1.2, warmup=0.3)
    state = {}
    for name, op in eng.operators.items():
        if isinstance(op, engine.StatefulOp):
            for sub, (cache, be) in enumerate(zip(op.caches, op.backends)):
                for e in cache.flush_dirty():
                    be.write(e.key, e.state, op.state_size)
                state[(name, sub)] = sorted(
                    (repr(k), repr(v)) for k, v in be.data.items())
    return m, sorted(got), state, widest[0]


@pytest.mark.parametrize("query", ["q5", "ysb"])
def test_slice_at_a_wide_batch_matches_reference(query):
    """``StatefulOp(fused_batch=1024)`` on the port's CPU plane against the
    reference's: metrics (outputs, latency percentiles, hit rates, the
    fused rollup and every counter), emits and final state are equal."""
    port = run_wide("repro_torch", query)
    ref = run_wide("repro", query)
    assert port[0]["n_outputs"] > 0 and port[1]
    assert port[0]["stateful_fused"]["batches"] > 0
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert port[3] == ref[3] and port[3] > 64
