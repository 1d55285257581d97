# The port's twin of tests/test_sessions.py: `repro.` -> `repro_torch.`
"""Session-window semantics: merge canonicalization, bridging-tuple state
preservation, Aion-style late re-open, moving-deadline hints (DESIGN.md
§15).

The Hypothesis properties pin the assigner's one canonical merge rule
(``SessionWindowAssigner.fold``): the final session registry of a key is
a pure function of the SET of event timestamps — independent of arrival
order — which is exactly what the chaos oracle (streaming/chaos.py)
differentially compares across perturbed runs.  The engine-level tests
then check the same guarantees end to end through the keyed two-step
merge protocol (drain -> absorb), where a pane may be parked on a
backend fetch mid-merge.
"""
import numpy as np
import pytest

from _hypothesis_compat import given, settings, st
from repro_torch.streaming.backend import IN_MEMORY
from repro_torch.streaming.engine import Engine, SinkOp, SourceOp
from repro_torch.streaming.nexmark import NexmarkConfig, build_query
from repro_torch.streaming.sessions import (SessionWindowAssigner,
                                      SessionWindowedOp)

GAP = 0.1


# ------------------------------------------------------- reference model
def _reference(ts_list, gap):
    """Gap-split over the SORTED timestamps: the textbook session
    definition the incremental fold must agree with."""
    out = []
    for ts in sorted(ts_list):
        if out and ts < out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], ts + gap))
        else:
            out.append((ts, ts + gap))
    return out


def _fold_all(assigner, ts_list):
    sessions = []
    for ts in ts_list:
        assigner.fold(sessions, ts)
    return sessions


def _check_order_independence(values, perm_seed):
    """fold(any permutation) == gap-split reference, with canonical ids."""
    assigner = SessionWindowAssigner(GAP)
    ts_list = [v * 0.03 for v in values]
    rng = np.random.Generator(np.random.PCG64(perm_seed))
    shuffled = list(ts_list)
    rng.shuffle(shuffled)
    sessions = _fold_all(assigner, shuffled)
    got = sorted((s["start"], s["end"], s["wid"]) for s in sessions)
    want = [(a, b, assigner.wid_of(a)) for a, b in
            _reference(ts_list, GAP)]
    assert got == want
    # registry invariants: disjoint, gap-separated, every ts covered
    for (_, e0, _), (s1, _, _) in zip(got, got[1:]):
        assert s1 >= e0
    for ts in ts_list:
        assert sum(1 for s, e, _ in got if s <= ts < e) == 1


# ------------------------------------------------- Hypothesis properties
@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 120), min_size=1, max_size=40),
       st.integers(0, 2**32 - 1))
def test_fold_is_order_independent(values, perm_seed):
    _check_order_independence(values, perm_seed)


@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 120), min_size=2, max_size=20),
       st.integers(0, 2**32 - 1))
def test_fold_merge_is_associative(values, perm_seed):
    """Folding the same multiset in two different interleavings (split
    into halves folded in either order) lands on the same registry."""
    assigner = SessionWindowAssigner(GAP)
    ts_list = [v * 0.03 for v in values]
    rng = np.random.Generator(np.random.PCG64(perm_seed))
    half = int(rng.integers(1, len(ts_list)))
    a, b = ts_list[:half], ts_list[half:]
    reg1 = {(s["start"], s["end"], s["wid"])
            for s in _fold_all(assigner, a + b)}
    reg2 = {(s["start"], s["end"], s["wid"])
            for s in _fold_all(assigner, b + a)}
    assert reg1 == reg2


def test_fold_order_independence_fixed_cases():
    """The property logic itself, exercised without Hypothesis so tier-1
    covers it even when the dev extra is absent."""
    for seed, values in [(1, [0, 1, 2]), (2, [0, 40, 20]),
                         (3, [5, 5, 5]), (4, [0, 3, 6, 9, 40, 43, 80]),
                         (5, list(range(0, 120, 4)))]:
        _check_order_independence(values, seed)


# ----------------------------------------------------- assigner unit tests
def test_assigner_canonical_wid_roundtrip():
    a = SessionWindowAssigner(0.5)
    wid = a.wid_of(1.234567)
    assert abs(a.start_of(wid) - 1.234567) < 1e-6
    assert a.end(wid) == pytest.approx(a.start_of(wid) + 0.5)
    with pytest.raises(ValueError):
        SessionWindowAssigner(0.0)


def test_fold_bridging_tuple_absorbs_later_session():
    a = SessionWindowAssigner(0.1)
    sessions = []
    a.fold(sessions, 0.10)                # A: [0.10, 0.20)
    a.fold(sessions, 0.25)                # B: [0.25, 0.35)
    sess, absorbed, extended, created = a.fold(sessions, 0.16)   # bridge
    assert len(sessions) == 1 and not created and extended
    assert [x["wid"] for x in absorbed] == [a.wid_of(0.25)]
    assert sess["wid"] == a.wid_of(0.10)  # earliest ts keeps the id
    assert sess["start"] == 0.10 and sess["end"] == pytest.approx(0.35)


def test_fold_predating_tuple_creates_new_survivor():
    """A tuple EARLIER than every overlapping session owns the canonical
    id: a fresh session absorbs the old pane(s)."""
    a = SessionWindowAssigner(0.1)
    sessions = []
    a.fold(sessions, 0.30)
    sess, absorbed, extended, created = a.fold(sessions, 0.25)
    assert created and extended and len(sessions) == 1
    assert sess["wid"] == a.wid_of(0.25)
    assert [x["wid"] for x in absorbed] == [a.wid_of(0.30)]
    assert sess["end"] == pytest.approx(0.40)


def test_session_op_rejects_fused_plane():
    eng = Engine()
    with pytest.raises(ValueError):
        SessionWindowedOp(
            eng, "s", 1, SessionWindowAssigner(1.0),
            lambda t, a: (a or 0) + 1, lambda *a: None,
            IN_MEMORY, 10_000, fused=object(), state_size=100)


# ------------------------------------------------- engine-level pipelines
class _CollectSink(SinkOp):
    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.got = []

    def process(self, sub, tup):
        self.got.append((tup.key, tup.payload))
        return super().process(sub, tup)


def _session_pipeline(eng, gen, oo_bound, lateness=0.0,
                      late_policy="drop", gap=GAP, rate=2000.0):
    src = eng.add(SourceOp(eng, "src", 1, rate, gen,
                           watermark_interval=0.05, oo_bound=oo_bound))
    win = eng.add(SessionWindowedOp(
        eng, "win", 1, SessionWindowAssigner(gap),
        agg_fn=lambda tup, acc: (acc or 0) + 1,
        emit_fn=lambda key, wid, end, acc: ("count", key, wid, acc),
        merge_fn=lambda a, b: (a or 0) + (b or 0),
        backend_model=IN_MEMORY, cache_capacity=1_000_000,
        allowed_lateness=lateness, late_policy=late_policy,
        policy="tac", mode="sync", state_size=100))
    sink = eng.add(_CollectSink(eng, "sink", 1))
    eng.connect(src, win)
    eng.connect(win, sink, partition=lambda k, n: 0)
    return win, sink


def test_bridging_tuple_never_loses_either_sides_state():
    """Two fired-apart clusters merged by a late bridging tuple: the
    surviving pane's count equals ALL five contributions — the two-step
    drain/absorb protocol preserved the absorbed pane's accumulator."""
    eng = Engine()
    script = [0.10, 0.15, 0.30, 0.35, 0.22]      # bridge arrives LAST
    state = {"n": 0}

    def gen(now):
        i = state["n"]
        state["n"] += 1
        if i < len(script):
            return (0, {}, 100, script[i])
        return (1, {}, 100, now)                 # filler drives the wm

    win, sink = _session_pipeline(eng, gen, oo_bound=0.25)
    eng.run(duration=1.0)
    a = SessionWindowAssigner(GAP)
    fired = {(k, wid): n for k, (_, _, wid, n) in sink.got}
    assert fired[(0, a.wid_of(0.10))] == len(script)
    assert (0, a.wid_of(0.30)) not in fired      # absorbed pane never fired
    assert win.sessions_merged == 1
    assert win.merge_drains == win.merge_absorbs == 1
    assert win.late_dropped == 0


def test_late_tuple_inside_lateness_reopens_session():
    """Aion-style late-side update: a tuple landing in a FIRED session
    within the lateness horizon re-opens it, and the re-fire carries the
    refreshed accumulator."""
    eng = Engine()
    state = {"n": 0, "late_sent": False}

    def gen(now):
        i = state["n"]
        state["n"] += 1
        if i == 0:
            return (0, {}, 100, 0.10)
        if i == 1:
            return (0, {}, 100, 0.15)            # session [0.10, 0.25)
        if now > 0.35 and not state["late_sent"]:
            state["late_sent"] = True
            return (0, {}, 100, 0.20)            # late, inside lateness
        # filler ts runs AHEAD of the wm it drives, so key 1's own
        # session never fires and adds no reopen/drop noise
        return (1, {}, 100, now + 0.15)

    win, sink = _session_pipeline(eng, gen, oo_bound=0.0, lateness=0.3,
                                  late_policy="update")
    eng.run(duration=1.0)
    a = SessionWindowAssigner(GAP)
    wid = a.wid_of(0.10)
    emits = [n for k, (_, _, w, n) in sink.got if k == 0 and w == wid]
    assert emits == [2, 3]                       # fire, then refreshed refire
    assert win.sessions_reopened == 1
    assert win.late_dropped == 0


def test_drop_policy_discards_late_tuple_on_fired_session():
    eng = Engine()
    state = {"n": 0, "late_sent": False}

    def gen(now):
        i = state["n"]
        state["n"] += 1
        if i == 0:
            return (0, {}, 100, 0.10)
        if now > 0.35 and not state["late_sent"]:
            state["late_sent"] = True
            return (0, {}, 100, 0.12)
        return (1, {}, 100, now + 0.15)

    win, sink = _session_pipeline(eng, gen, oo_bound=0.0, lateness=0.0,
                                  late_policy="drop")
    eng.run(duration=1.0)
    a = SessionWindowAssigner(GAP)
    emits = [n for k, (_, _, w, n) in sink.got
             if k == 0 and w == a.wid_of(0.10)]
    assert emits == [1]
    assert win.late_dropped >= 1
    assert win.sessions_reopened == 0


# ------------------------------------------- q11 + moving-deadline hints
def test_q11_session_query_moving_deadline_hints():
    """The NEXMark session query end to end under prefetching: sessions
    merge, the lookahead RE-HINTS moved deadlines (bypassing admission),
    and panes prefetch ahead of their fires."""
    cfg = NexmarkConfig(rate=3000, oo_bound=0.2, seed=7,
                        watermark_interval=0.05)
    eng = build_query("q11", "tac", "prefetch", cfg, cache_entries=512,
                      parallelism=2, source_parallelism=1, io_workers=4,
                      buffer_timeout=0.002, session_gap=0.4)
    m = eng.run(duration=1.5, warmup=0.5)
    assert m["stateful_fires"] > 0
    assert m["stateful_sessions_created"] > 0
    assert m["sess_lookahead_rehints"] > 0       # deadlines MOVED
    assert m["stateful_hints_received"] > 0
    assert m["stateful_prefetch_hits"] > 0
    assert m["n_outputs"] > 0
    # both mirrored registries fold the same rule in lockstep
    st_op = eng.operators["stateful"]
    assert st_op.late_dropped == 0


def test_q11_requires_out_of_orderness():
    cfg = NexmarkConfig(rate=1000, oo_bound=0.0)
    with pytest.raises(ValueError):
        build_query("q11", "tac", "prefetch", cfg)
