# The port's twin of tests/test_chaos.py: `repro.` -> `repro_torch.`
"""Chaos harness + exactly-once oracle tests (DESIGN.md §15).

Covers the three claims the harness makes: (1) a fault schedule replays
BIT-EXACTLY on the discrete-event clock, (2) concurrent faults do not
change the session query's state effects (the oracle passes), and (3)
when state IS corrupted the oracle catches it and the greedy minimizer
shrinks the schedule to a <= 2-event reproducer that pickles/loads.

Plus the seed-determinism audit: every workload generator (synthetic,
NEXMark, YSB) draws from one counter-based ``numpy.random.Generator``,
so two same-seed runs produce identical sink streams.
"""
import pickle

import pytest

from repro_torch.streaming.chaos import (FaultEvent, FaultSchedule,
                                   check_schedule, compare, minimize,
                                   run_schedule, save_artifact)
from repro_torch.streaming.nexmark import NexmarkConfig, NexmarkGen, build_query
from repro_torch.streaming.synthetic import SyntheticConfig, build_synthetic
from repro_torch.streaming.ysb import YSBConfig, YSBGen

T_CUT = 1.2                               # short logical stream: fast tests


# ------------------------------------------------------------- schedules
def test_random_schedule_is_reproducible_and_multi_kind():
    for seed in (5, 17, 901):
        a = FaultSchedule.random(seed)
        b = FaultSchedule.random(seed)
        assert a == b                     # pure function of the seed
        assert len(set(e.kind for e in a.events)) >= 2
        assert "corrupt" not in a.kinds()  # only injected explicitly
        assert all(0.4 <= e.at <= 1.6 for e in a.events)
    assert FaultSchedule.random(5) != FaultSchedule.random(6)


def test_fault_event_rejects_unknown_kind():
    with pytest.raises(ValueError):
        FaultEvent("power_surge", 1.0)


# ----------------------------------------------------- bit-exact replay
def test_perturbed_run_replays_bit_exactly():
    """Same schedule, same seed, fresh engine: every observable state
    effect is identical — the property the differential oracle needs."""
    sched = FaultSchedule.random(41, n_events=3)
    r1 = run_schedule(sched, t_cut=T_CUT)
    r2 = run_schedule(sched, t_cut=T_CUT)
    assert r1.final_state == r2.final_state
    assert r1.registry == r2.registry
    assert r1.last_emit == r2.last_emit
    assert r1.emit_counts == r2.emit_counts
    assert r1.absorbed == r2.absorbed


# --------------------------------------------------------------- oracle
def test_oracle_passes_under_concurrent_faults():
    """A >= 2-kind schedule (the CI smoke shape) leaves final keyed
    state, session registry, and last-emit-per-pane bit-identical to the
    unperturbed golden run."""
    sched = FaultSchedule.random(101, n_events=4)
    assert len(set(e.kind for e in sched.events)) >= 2
    report, golden, perturbed = check_schedule(sched, t_cut=T_CUT)
    assert report.ok, report.violations[:3]
    assert golden.registry            # non-vacuous: sessions survived
    assert golden.last_emit           # ... and fired
    assert perturbed.metrics["fires"] > 0


def test_oracle_self_compare_is_clean():
    golden = run_schedule(FaultSchedule(seed=55), t_cut=T_CUT)
    report = compare(golden, golden)
    assert report.ok and not report.violations
    assert report.deviations.get("duplicate_emits", 0) == 0


# ------------------------------------------------- minimizer + artifact
def test_minimizer_shrinks_corruption_to_two_events(tmp_path):
    """An intentional state corruption hidden inside a wider schedule:
    the oracle flags it and greedy delta-debugging shrinks the schedule
    to <= 2 events that still reproduce the violation, pickled as a
    loadable artifact."""
    base = FaultSchedule(seed=77, chaos_seed=770)
    sched = base.with_events([
        FaultEvent("hint_drop", 0.5, (0.5, 0.4)),
        FaultEvent("migrate", 0.7, (1, 1)),
        FaultEvent("corrupt", 0.8),
    ])
    report, golden, _ = check_schedule(sched, t_cut=T_CUT)
    assert not report.ok
    assert any("__corrupt__" in str(v) for v in report.violations)

    mini = minimize(sched, t_cut=T_CUT, golden=golden)
    assert len(mini.events) <= 2
    assert "corrupt" in mini.kinds()
    mini_report, _, _ = check_schedule(mini, t_cut=T_CUT, golden=golden)
    assert not mini_report.ok         # still reproduces

    path = save_artifact(mini, mini_report, out_dir=str(tmp_path))
    with open(path, "rb") as fh:
        art = pickle.load(fh)
    assert art["schedule"] == mini    # round-trips through pickle
    assert art["violations"]


def test_minimize_returns_passing_schedule_unchanged():
    sched = FaultSchedule.random(101, n_events=2)
    golden = run_schedule(FaultSchedule(seed=sched.seed,
                                        chaos_seed=sched.chaos_seed),
                          t_cut=T_CUT)
    assert minimize(sched, t_cut=T_CUT, golden=golden) == sched


# ------------------------------------------- seed-determinism audit (§15)
def test_generators_are_seed_deterministic():
    """Every workload generator draws from one counter-based numpy
    Generator: same seed => identical tuple stream, different seed =>
    different stream."""
    n = 400
    for mk in (lambda s: NexmarkGen(NexmarkConfig(seed=s)),
               lambda s: YSBGen(YSBConfig(seed=s))):
        a = [mk(9)(i * 1e-3) for i in range(n)]
        b = [mk(9)(i * 1e-3) for i in range(n)]
        c = [mk(10)(i * 1e-3) for i in range(n)]
        assert a == b
        assert a != c


def _sink_stream(eng, duration):
    sink = eng.operators["sink"]
    got = []
    orig = sink.process
    sink.process = lambda sub, tup: (
        got.append((round(tup.ts, 9), tup.key)), orig(sub, tup))[1]
    eng.run(duration=duration)
    return got


def test_same_seed_runs_produce_identical_sink_streams():
    """End to end through prefetching, caching, and I/O timing: the
    whole discrete-event run is a pure function of the seed."""
    def synth():
        return build_synthetic(SyntheticConfig(rate=8000.0, seed=13),
                               parallelism=2)

    def q11():
        cfg = NexmarkConfig(rate=3000, oo_bound=0.2, seed=13,
                            watermark_interval=0.05)
        return build_query("q11", "tac", "prefetch", cfg,
                           cache_entries=512, parallelism=2,
                           source_parallelism=1, io_workers=4,
                           buffer_timeout=0.002, session_gap=0.4)

    for builder, dur in ((synth, 0.4), (q11, 2.0)):
        s1 = _sink_stream(builder(), dur)
        s2 = _sink_stream(builder(), dur)
        assert s1, "no sink output"
        assert s1 == s2
