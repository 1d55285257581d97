"""Deterministic chaos harness with an exactly-once state-effect oracle
(DESIGN.md §15).

The paper's claim — prefetching hides state-access latency for queries
that run forever — is only credible if correctness survives what long
runs actually see: failures, migrations, and load shifts landing
CONCURRENTLY.  This module turns that into a falsifiable check:

  * ``FaultSchedule`` — a seeded, picklable schedule of ``FaultEvent``s
    (failure@t, migrate_shard@t, load_shift@t, hint-channel drop/delay
    windows, state corruption), composable and overlapping.  Events fire
    on the engine's DISCRETE-EVENT clock, and every random draw (the
    workload's and the chaos plane's) comes from a counter-based
    generator, so a schedule replays bit-exactly: same schedule, same
    run, down to the last cache eviction.
  * ``run_schedule`` — drives the NEXMark q11 session query (the window
    type whose fire deadlines MOVE, stressing re-hints and the TAC's
    renew path) under a schedule and returns the run's observable state
    effects.
  * ``compare`` — the exactly-once oracle: a perturbed run must match
    the unperturbed golden run of the same seed on (1) final keyed
    state, (2) the final session registry, and (3) the LAST emitted
    result of every surviving pane.  The recovery plane is exactly-once
    in STATE but at-least-once in EMISSION (DESIGN.md §7), and fire/
    merge races move intermediate emits between runs — so duplicate
    emissions and transient fires of merged-away panes are recorded as
    DEVIATIONS, not violations.
  * ``minimize`` — greedy delta-debugging: drop one event at a time,
    keep any subset that still violates the oracle, repeat to a fixed
    point.  The minimal reproducer pickles as an artifact.

Oracle soundness (why state effects are perturbation-invariant here):
the chaos workload fixes ``gap + lateness > oo_bound`` and ``lateness
>= oo_bound``.  A tuple is at most ``2*oo_bound`` behind arrival and a
watermark is at least ``oo_bound`` behind it, so ``ts >= wm - oo`` at
every operator — which makes the lateness-horizon drop (needs
``ts + gap + lateness < wm``) and the tuple-after-purge race (needs
``lateness < oo``) both IMPOSSIBLE.  Every tuple folds into the same
canonical session (sessions.py derives ids from the earliest event
time) in every run, so final state, registry, and last-emit-per-pane
are pure functions of the workload seed.
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.streaming.engine import Engine, SourceOp
from repro_torch.streaming.nexmark import NexmarkConfig, build_query
from repro_torch.streaming.recovery import CheckpointCoordinator

KINDS = ("failure", "migrate", "load_shift", "hint_drop", "hint_delay",
         "corrupt")

# chaos workload geometry (the soundness condition above): gap 0.4 s,
# lateness = oo_bound = 0.2 s, update late policy (wired by build_query)
GAP = 0.4
OO_BOUND = 0.2
LATENESS = 0.2
RATE = 3000.0
N_SHARDS = 4
PARALLELISM = 2


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``at`` is engine (discrete-event) time;
    ``params`` is kind-specific and hashable:

      failure:    (mode,)             mode in {"warmed", "cold"}
      migrate:    (shard, dst_sub)
      load_shift: (scale, duration)   rate_scale while active
      hint_drop:  (drop_p, duration)  hint loss probability while active
      hint_delay: (extra, duration)   extra hint flush delay while active
      corrupt:    ()                  deterministic state corruption (the
                                      intentional violation the minimizer
                                      test reproduces)
    """
    kind: str
    at: float
    params: Tuple = ()

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind {self.kind!r}")


@dataclass(frozen=True)
class FaultSchedule:
    """A seeded fault schedule.  ``seed`` drives the workload generator
    (golden = same seed, zero events); ``chaos_seed`` drives the
    hint-channel drop draws.  Frozen + tuple-of-frozen => hashable and
    picklable, so failing schedules ship as artifacts."""
    seed: int
    events: Tuple[FaultEvent, ...] = ()
    chaos_seed: int = 0

    def with_events(self, events) -> "FaultSchedule":
        return FaultSchedule(self.seed, tuple(events), self.chaos_seed)

    def kinds(self) -> Tuple[str, ...]:
        return tuple(sorted({e.kind for e in self.events}))

    @staticmethod
    def random(seed: int, n_events: int = 4, t_lo: float = 0.4,
               t_hi: float = 1.6) -> "FaultSchedule":
        """A reproducible random schedule with >= 2 distinct fault kinds
        (never ``corrupt`` — that one is an intentional violation, only
        injected explicitly).  Windowed faults overlap point faults by
        construction: durations stretch past neighbouring event times.
        """
        rng = np.random.Generator(np.random.PCG64(seed))
        pool = ["failure", "migrate", "load_shift", "hint_drop",
                "hint_delay"]
        n = max(2, n_events)
        kinds = [pool[int(rng.integers(len(pool)))] for _ in range(n)]
        while len(set(kinds)) < 2:
            kinds[-1] = pool[int(rng.integers(len(pool)))]
        times = sorted(float(t)
                       for t in rng.uniform(t_lo, t_hi, size=n))
        events = []
        for kind, at in zip(kinds, times):
            if kind == "failure":
                mode = "warmed" if rng.random() < 0.7 else "cold"
                events.append(FaultEvent(kind, at, (mode,)))
            elif kind == "migrate":
                shard = int(rng.integers(N_SHARDS))
                dst = int(rng.integers(PARALLELISM))
                events.append(FaultEvent(kind, at, (shard, dst)))
            elif kind == "load_shift":
                scale = float(rng.choice([0.4, 2.0, 3.0]))
                dur = float(rng.uniform(0.3, 0.8))
                events.append(FaultEvent(kind, at, (scale, dur)))
            elif kind == "hint_drop":
                p = float(rng.uniform(0.3, 0.9))
                dur = float(rng.uniform(0.3, 0.8))
                events.append(FaultEvent(kind, at, (p, dur)))
            else:                          # hint_delay
                extra = float(rng.uniform(0.002, 0.02))
                dur = float(rng.uniform(0.3, 0.8))
                events.append(FaultEvent(kind, at, (extra, dur)))
        return FaultSchedule(seed, tuple(events), chaos_seed=seed * 31 + 7)


class ChannelChaos:
    """Per-channel fault injector (engine.Channel.chaos hook).  Draws
    come from a seeded generator in simulation-event order, so a given
    schedule produces the identical drop pattern every run."""

    def __init__(self, rng: np.random.Generator):
        self.rng = rng
        self.drop_p = 0.0
        self.extra = 0.0
        self.dropped = 0

    def drop(self, msg) -> bool:
        if self.drop_p > 0.0 and self.rng.random() < self.drop_p:
            self.dropped += 1
            return True
        return False

    def delay(self) -> float:
        return self.extra


@dataclass
class RunResult:
    """Observable state effects of one run, in oracle-comparable form."""
    final_state: Dict[Any, Any]
    registry: Dict[Tuple, Tuple]          # (base, wid) -> (start, end)
    last_emit: Dict[Tuple, Any]           # (base, wid) -> last count
    emit_counts: Dict[Tuple, int]         # (base, wid) -> times emitted
    absorbed: frozenset                   # (base, wid) merged away
    metrics: Dict[str, Any] = field(default_factory=dict)


@dataclass
class OracleReport:
    ok: bool
    violations: List[str]
    deviations: Dict[str, int]

    def __str__(self):
        head = "OK" if self.ok else "VIOLATED"
        lines = [f"oracle {head}; deviations {self.deviations}"]
        lines += [f"  - {v}" for v in self.violations[:8]]
        return "\n".join(lines)


def build_chaos_engine(seed: int, mode: str = "prefetch") -> Engine:
    cfg = NexmarkConfig(rate=RATE, seed=seed, oo_bound=OO_BOUND,
                        watermark_interval=0.05)
    return build_query("q11", "tac", mode, cfg, cache_entries=512,
                       parallelism=PARALLELISM, source_parallelism=1,
                       io_workers=4, n_shards=N_SHARDS,
                       buffer_timeout=0.002, session_gap=GAP,
                       allowed_lateness=LATENESS, replayable=True)


def _install(eng: Engine, coord: CheckpointCoordinator,
             chaos: ChannelChaos, ev: FaultEvent) -> None:
    sim = eng.sim
    if ev.kind == "failure":
        (mode,) = ev.params

        def fire_failure():
            if coord.in_recovery:
                # overlapping failures are out of scope for the recovery
                # plane (recovery.py fails loud): retry shortly after —
                # deterministically, the retry delay is fixed
                sim.after(0.05, fire_failure)
                return
            coord.fail(mode=mode, down_time=0.05, replay_speedup=4.0)

        sim.at(ev.at, fire_failure)
    elif ev.kind == "migrate":
        shard, dst = ev.params
        sim.at(ev.at, eng.migrate_shard, "stateful",
               shard % N_SHARDS, dst % PARALLELISM)
    elif ev.kind == "load_shift":
        scale, dur = ev.params
        srcs = [op for op in eng.operators.values()
                if isinstance(op, SourceOp)]

        def set_scale(s):
            for src in srcs:
                src.rate_scale = s

        sim.at(ev.at, set_scale, float(scale))
        sim.at(ev.at + dur, set_scale, 1.0)
    elif ev.kind == "hint_drop":
        p, dur = ev.params
        sim.at(ev.at, setattr, chaos, "drop_p", float(p))
        sim.at(ev.at + dur, setattr, chaos, "drop_p", 0.0)
    elif ev.kind == "hint_delay":
        extra, dur = ev.params
        sim.at(ev.at, setattr, chaos, "extra", float(extra))
        sim.at(ev.at + dur, setattr, chaos, "extra", 0.0)
    elif ev.kind == "corrupt":
        op = eng.operators["stateful"]
        # deterministic intentional violation: a key no session query
        # would ever write lands in the backend through the normal write
        # path (so delta checkpoints carry it like real state)
        sim.at(ev.at, op.backends[0].write,
               ("__corrupt__", round(ev.at, 6)), 999_999, 64)


def run_schedule(schedule: FaultSchedule, t_cut: float = 2.0,
                 mode: str = "prefetch", observe: bool = False,
                 timeline_interval: float = 0.1) -> RunResult:
    """Run the chaos workload under ``schedule`` until the source's
    LOGICAL clock reaches ``t_cut``, quiesce, then flush all windows
    with a final watermark pair and collect the oracle observables.

    The generator is cut on logical time, so a load shift or recovery
    replay changes when records arrive but never which records exist;
    the final watermark pair (``FINAL`` fires every session, ``FINAL +
    1e-7`` runs the purge sweep once all fires have applied) makes the
    purge set a pure event-time function of the workload.

    With ``observe``, the temporal plane (DESIGN.md §16) runs during the
    LIVE phase — timeline + health detectors on ``timeline_interval`` —
    and freezes before the drain (where throughput legitimately
    collapses to zero and stall/load-shift alerts would be artifacts of
    the harness, not the run).  The alerts land in
    ``RunResult.metrics["alerts"]`` for the alert oracle
    (``alert_oracle``).
    """
    eng = build_chaos_engine(schedule.seed, mode=mode)
    sim = eng.sim
    src: SourceOp = eng.operators["source"]
    op = eng.operators["stateful"]
    sessla = eng.operators["sess_lookahead"]
    sink = eng.operators["sink"]

    inner_gen = src.gen
    src.gen = lambda lt: None if lt >= t_cut else inner_gen(lt)

    emits: List[Tuple[Any, Any]] = []
    orig_process = sink.process
    sink.process = lambda sub, tup: (emits.append((tup.key, tup.payload)),
                                     orig_process(sub, tup))[1]

    coord = CheckpointCoordinator(eng, interval=0.3)
    coord.start()
    chaos = ChannelChaos(
        np.random.Generator(np.random.PCG64(schedule.chaos_seed)))
    for ch in sessla.out_hint:
        ch.chaos = chaos
    for ev in schedule.events:
        _install(eng, coord, chaos, ev)

    if observe:
        eng.enable_timeline(interval=timeline_interval)
        # the observed window is the LIVE phase: past t_cut the logical
        # stream is exhausted by construction and throughput falls to
        # zero — an artifact of the cut, not a health signal, so the
        # plane freezes there (oracle-gated events sit well inside)
        sim.at(t_cut, eng.stop_timeline)

    for o in eng.operators.values():
        if isinstance(o, SourceOp):
            o.start()
    sim.after(eng.marker_interval, eng._inject_marker)

    # phase 1: run until the logical stream is exhausted AND any replay /
    # recovery in flight has settled
    t, step, deadline = 0.0, 0.25, 10.0 * t_cut + 30.0
    while True:
        t += step
        sim.run_until(t)
        log_end = [src.log_base[s] + len(src.log[s])
                   for s in range(src.parallelism)]
        done = (all(lt >= t_cut for lt in src.logical_t)
                and all(src.replay_pos[s] >= log_end[s]
                        for s in range(src.parallelism))
                and not coord.in_recovery)
        if done:
            break
        if t > deadline:
            raise RuntimeError(f"chaos run failed to quiesce by t={t}")
    # phase 2: drain in-flight data, then fire + purge deterministically.
    # The temporal plane freezes here: the drain's zero-throughput tail
    # is a harness artifact, not run health
    eng.stop_timeline()
    t += 0.5
    sim.run_until(t)
    final_wm = t_cut + GAP + 0.05
    for wm in (final_wm, final_wm + 1e-7):
        for s in range(src.parallelism):
            src.wm[s] = wm                # freeze _wm_tick below this
            src.emit_watermark(s, wm)
        last = -1
        while len(emits) != last:         # fires may cascade merge settles
            last = len(emits)
            t += 0.3
            sim.run_until(t)
    src.stopped = True

    # ----- collect observables
    merged: Dict[Any, Any] = {}
    for sub in range(op.parallelism):
        for e in op.caches[sub].flush_dirty():
            op.backends[sub].write(e.key, e.state, op.state_size)
        merged.update(op.backends[sub].data)
    # prefetches materialize default (None) pane state in the backend;
    # whether a hint's fetch beat its pane's purge is timing, not state —
    # normalize the Nones away so only real values face the oracle
    merged = {k: v for k, v in merged.items() if v is not None}

    registry: Dict[Tuple, Tuple] = {}
    for sub in range(op.parallelism):
        for base, lst in op.sess[sub].items():
            for s in lst:
                registry[(base, s["wid"])] = (round(s["start"], 9),
                                              round(s["end"], 9))
    absorbed = frozenset(k for sub in range(op.parallelism)
                         for k in op.absorbed[sub])

    last_emit: Dict[Tuple, Any] = {}
    emit_counts: Dict[Tuple, int] = {}
    for _key, payload in emits:
        if isinstance(payload, tuple) and len(payload) == 4 \
                and payload[0] == "session":
            _, base, wid, count = payload
            last_emit[(base, wid)] = count
            emit_counts[(base, wid)] = emit_counts.get((base, wid), 0) + 1

    metrics = {
        "fires": op.fires, "fires_lost": op.fires_lost,
        "sessions_created": op.sessions_created,
        "sessions_merged": op.sessions_merged,
        "sessions_reopened": op.sessions_reopened,
        "late_dropped": op.late_dropped,
        "hints_dropped_by_chaos": chaos.dropped,
        "failures": coord.failures, "emits": len(emits),
        "rehints": sessla.rehints,
    }
    if observe and eng.health is not None:
        metrics["alerts"] = [a.as_dict() for a in eng.health.alerts]
        metrics["health"] = eng.health.block()
        metrics["timeline"] = eng.timeline.block()
    return RunResult(merged, registry, last_emit, emit_counts, absorbed,
                     metrics)


def compare(golden: RunResult, perturbed: RunResult) -> OracleReport:
    """The exactly-once state-effect oracle (module docstring).  Hard
    violations: final keyed state, final session registry, and the last
    emit of every non-merged pane must match the golden run.  Recorded
    deviations (at-least-once emission + fire/merge races): duplicate
    emissions and transient fires of panes later merged away."""
    v: List[str] = []
    if golden.final_state != perturbed.final_state:
        only_g = {k: golden.final_state[k]
                  for k in set(golden.final_state) - set(perturbed.final_state)}
        only_p = {k: perturbed.final_state[k]
                  for k in set(perturbed.final_state) - set(golden.final_state)}
        diff = {k: (golden.final_state[k], perturbed.final_state[k])
                for k in set(golden.final_state) & set(perturbed.final_state)
                if golden.final_state[k] != perturbed.final_state[k]}
        v.append(f"final keyed state diverged: only_golden={only_g!r} "
                 f"only_perturbed={only_p!r} value_diff={diff!r}")
    if golden.registry != perturbed.registry:
        d = set(golden.registry.items()) ^ set(perturbed.registry.items())
        v.append(f"session registry diverged: {sorted(d)[:6]!r}")
    merged_away = golden.absorbed | perturbed.absorbed
    hard_g = set(golden.last_emit) - merged_away
    hard_p = set(perturbed.last_emit) - merged_away
    if hard_g != hard_p:
        v.append(f"fired-pane set diverged: only_golden="
                 f"{sorted(hard_g - hard_p)[:6]!r} only_perturbed="
                 f"{sorted(hard_p - hard_g)[:6]!r}")
    for pane in hard_g & hard_p:
        if golden.last_emit[pane] != perturbed.last_emit[pane]:
            v.append(f"pane {pane!r} final emit diverged: "
                     f"golden={golden.last_emit[pane]!r} perturbed="
                     f"{perturbed.last_emit[pane]!r}")
    deviations = {
        "duplicate_emits": sum(c - 1 for c in
                               perturbed.emit_counts.values() if c > 1),
        "transient_pane_emits": sum(
            perturbed.emit_counts.get(p, 0)
            for p in set(perturbed.last_emit) & merged_away),
        "hints_dropped": perturbed.metrics.get("hints_dropped_by_chaos", 0),
    }
    return OracleReport(not v, v, deviations)


# ------------------------------------------------------- alert oracle (§16)
# fault kind -> the alert kind its detection must raise (health.py's
# ORACLE_KINDS, re-exported here so the harness is self-contained)
ALERT_FOR = {"failure": "recovery", "migrate": "migration",
             "load_shift": "load_shift"}


def effective_events(schedule: FaultSchedule
                     ) -> List[Tuple[FaultEvent, str]]:
    """The oracle-gated events a run will actually EXPRESS, with the
    alert kind each must raise.  Replays the shard-owner table in event
    order (initial owner = shard % PARALLELISM) because a migrate whose
    destination already owns the shard is a no-op at the engine
    (``StatefulOp.migrate_shard`` returns early) — ground truth must not
    demand an alert for a fault that physically cannot happen.  Same for
    a load shift at scale 1.0.  Assumes migrations execute in schedule
    order (checkpoint-deferral preserves relative order for the
    well-separated schedules the oracle benchmarks use)."""
    owner = [s % PARALLELISM for s in range(N_SHARDS)]
    out: List[Tuple[FaultEvent, str]] = []
    for ev in sorted(schedule.events, key=lambda e: e.at):
        if ev.kind == "failure":
            out.append((ev, ALERT_FOR[ev.kind]))
        elif ev.kind == "migrate":
            shard, dst = ev.params
            shard, dst = shard % N_SHARDS, dst % PARALLELISM
            if owner[shard] != dst:
                owner[shard] = dst
                out.append((ev, ALERT_FOR[ev.kind]))
        elif ev.kind == "load_shift":
            scale, dur = ev.params
            if scale != 1.0:
                out.append((ev, ALERT_FOR[ev.kind]))
    return out


def alert_oracle(schedule: FaultSchedule, perturbed: RunResult,
                 golden: RunResult, delay: float = 0.8) -> Dict[str, Any]:
    """Score the temporal plane against the seeded schedule as ground
    truth (both runs must have been produced with ``observe=True``):

      * recall — every effective failure/migrate/load_shift event must
        raise an alert of its mapped kind within ``delay`` logical
        seconds of the event's onset (windowed faults get their duration
        added: the shift exists for that long);
      * golden soundness — the unperturbed run of the same seed must
        raise ZERO stall alerts (and is reported on all kinds).

    Both are gated in BENCH_obs.json's ``alerts`` block."""
    galerts = golden.metrics.get("alerts", [])
    palerts = perturbed.metrics.get("alerts", [])
    per_event: List[Dict[str, Any]] = []
    matched = 0
    events = effective_events(schedule)
    for ev, want in events:
        horizon = ev.at + delay
        if ev.kind == "load_shift":
            horizon += ev.params[1]
        hit = [a for a in palerts
               if a["kind"] == want and ev.at <= a["t"] <= horizon]
        if hit:
            matched += 1
        per_event.append({"kind": ev.kind, "at": ev.at, "want": want,
                          "matched": bool(hit),
                          "alert_t": hit[0]["t"] if hit else None})
    by_kind: Dict[str, Dict[str, int]] = {}
    for e in per_event:
        b = by_kind.setdefault(e["kind"], {"injected": 0, "matched": 0})
        b["injected"] += 1
        b["matched"] += int(e["matched"])
    return {
        "injected": len(events),
        "matched": matched,
        "recall": matched / len(events) if events else 1.0,
        "per_kind": by_kind,
        "per_event": per_event,
        "golden_alerts": len(galerts),
        "golden_false_stall": sum(1 for a in galerts
                                  if a["kind"] == "stall"),
        "golden_by_kind": _count_kinds(galerts),
        "perturbed_by_kind": _count_kinds(palerts),
        "delay": delay,
    }


def _count_kinds(alerts: List[dict]) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for a in alerts:
        out[a["kind"]] = out.get(a["kind"], 0) + 1
    return out


def check_schedule(schedule: FaultSchedule, t_cut: float = 2.0,
                   golden: Optional[RunResult] = None,
                   mode: str = "prefetch"):
    """Run golden (zero events, same seed) + perturbed and compare.
    Returns (report, golden, perturbed); pass ``golden`` to amortize it
    across schedules sharing a workload seed."""
    if golden is None:
        golden = run_schedule(schedule.with_events(()), t_cut, mode=mode)
    perturbed = run_schedule(schedule, t_cut, mode=mode)
    return compare(golden, perturbed), golden, perturbed


def minimize(schedule: FaultSchedule, t_cut: float = 2.0,
             golden: Optional[RunResult] = None) -> FaultSchedule:
    """Greedy schedule shrinking: repeatedly drop single events while
    the remainder still violates the oracle.  Deterministic (runs are
    replays), so the result is a stable minimal reproducer.  If the full
    schedule does not violate, it is returned unchanged."""
    if golden is None:
        golden = run_schedule(schedule.with_events(()), t_cut)

    def violates(events) -> bool:
        rep = compare(golden,
                      run_schedule(schedule.with_events(events), t_cut))
        return not rep.ok

    events = list(schedule.events)
    if not violates(events):
        return schedule
    shrunk = True
    while shrunk and len(events) > 1:
        shrunk = False
        for i in range(len(events)):
            cand = events[:i] + events[i + 1:]
            if violates(cand):
                events = cand
                shrunk = True
                break
    return schedule.with_events(events)


def save_artifact(schedule: FaultSchedule, report: OracleReport,
                  out_dir: str = "chaos_artifacts") -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"repro_seed{schedule.seed}.pkl")
    with open(path, "wb") as f:
        pickle.dump({"schedule": schedule,
                     "violations": report.violations,
                     "deviations": report.deviations}, f)
    return path
