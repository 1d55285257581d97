"""Unified metrics registry (DESIGN.md §12).

One typed, hierarchically-named sink for every counter, gauge, and latency
histogram in the repo: the streaming engine, the serving plane, the
checkpoint/recovery plane, and the device-side kernel tallies all publish
here, and every ``BENCH_*.json`` / ``tools/obs_report.py`` surface reads
back out of one ``snapshot()``.

Design points:

  * **Typed handles.**  ``Counter`` (monotonic), ``Gauge`` (last value),
    ``Histogram`` (a streaming log-linear quantile sketch — NOT a capped
    sample list, so percentiles never bias toward warmup samples no
    matter how long the run is).
  * **Hierarchical names.**  Dot-separated, e.g.
    ``engine.stateful.shard.0.prefetch_hits``.  The name grammar is
    documented as TEMPLATES in ``METRIC_CATALOG`` (``<op>`` matches one
    concrete segment); ``tools/check_docs.py`` verifies DESIGN.md §12
    cites only catalogued templates, and tests verify every name a run
    actually registers matches some template.
  * **Zero-cost when disabled.**  A disabled registry hands out shared
    no-op singletons, so instrumented hot paths pay one method call on a
    do-nothing object and allocate nothing.
  * **JSONL export.**  ``export_jsonl`` appends one snapshot line; the
    engine drives it on a configurable sim-clock cadence.

Stdlib-only on purpose: ``tools/check_docs.py`` imports the catalog from
here without jax/numpy installed.
"""
from __future__ import annotations

import json
import math
from typing import Any, Dict, Iterable, List, Optional, Tuple


class QuantileSketch:
    """Streaming two-sided log-linear histogram (HDR-style).

    Values are bucketed at ``bins_per_decade`` resolution (64/decade =>
    <2% relative quantile error); negative values get a mirrored bucket
    space (prefetch LEAD TIMES are signed — negative means late).  Count,
    sum, min, and max are tracked exactly; quantiles interpolate the bin
    midpoint (geometric) and clamp to the observed [min, max].
    """

    __slots__ = ("lo", "_k", "pos", "neg", "zero",
                 "count", "total", "vmin", "vmax")

    def __init__(self, lo: float = 1e-9, bins_per_decade: int = 64):
        self.lo = lo
        self._k = bins_per_decade / math.log(10.0)
        self.pos: Dict[int, int] = {}
        self.neg: Dict[int, int] = {}
        self.zero = 0
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def _bin(self, mag: float) -> int:
        if mag <= self.lo:
            return 0
        return int(self._k * math.log(mag / self.lo)) + 1

    def _bin_value(self, idx: int) -> float:
        if idx == 0:
            return self.lo
        return self.lo * math.exp((idx - 0.5) / self._k)

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if v > 0.0:
            b = self._bin(v)
            self.pos[b] = self.pos.get(b, 0) + 1
        elif v < 0.0:
            b = self._bin(-v)
            self.neg[b] = self.neg.get(b, 0) + 1
        else:
            self.zero += 1

    def merge(self, other: "QuantileSketch") -> None:
        for b, n in other.pos.items():
            self.pos[b] = self.pos.get(b, 0) + n
        for b, n in other.neg.items():
            self.neg[b] = self.neg.get(b, 0) + n
        self.zero += other.zero
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """q in [0, 1].  Walks negatives (most negative first), zeros,
        then positives."""
        if self.count == 0:
            return 0.0
        rank = q * (self.count - 1)
        seen = 0
        for b in sorted(self.neg, reverse=True):   # most negative first
            seen += self.neg[b]
            if seen > rank:
                return self._clamp(-self._bin_value(b))
        seen += self.zero
        if seen > rank:
            return self._clamp(0.0)
        for b in sorted(self.pos):
            seen += self.pos[b]
            if seen > rank:
                return self._clamp(self._bin_value(b))
        return self.vmax

    def _clamp(self, v: float) -> float:
        return min(max(v, self.vmin), self.vmax)

    def percentiles(self, qs: Iterable[float] = (50, 90, 99)
                    ) -> Dict[str, float]:
        return {f"p{q:g}".replace(".", "_"): self.quantile(q / 100.0)
                for q in qs}

    def summary(self) -> Dict[str, float]:
        if self.count == 0:
            return {"count": 0}
        out = {"count": self.count, "mean": self.mean,
               "min": self.vmin, "max": self.vmax}
        out.update(self.percentiles((50, 90, 99, 99.9)))
        return out


# --------------------------------------------------------------- handles
class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def set(self, v) -> None:
        """Mirror an externally-maintained cumulative count (the legacy
        operator-local ints synced at snapshot time)."""
        self.value = v


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Histogram:
    __slots__ = ("name", "sketch")

    def __init__(self, name: str, lo: float = 1e-9,
                 bins_per_decade: int = 64):
        self.name = name
        self.sketch = QuantileSketch(lo, bins_per_decade)

    def observe(self, v: float) -> None:
        self.sketch.observe(v)

    @property
    def count(self) -> int:
        return self.sketch.count

    def quantile(self, q: float) -> float:
        return self.sketch.quantile(q)


class _NullCounter:
    __slots__ = ()
    name = ""
    value = 0

    def inc(self, n: int = 1) -> None:
        pass

    def set(self, v) -> None:
        pass


class _NullGauge:
    __slots__ = ()
    name = ""
    value = 0.0

    def set(self, v: float) -> None:
        pass


class _NullHistogram:
    __slots__ = ()
    name = ""
    count = 0

    def observe(self, v: float) -> None:
        pass

    def quantile(self, q: float) -> float:
        return 0.0


NULL_COUNTER = _NullCounter()
NULL_GAUGE = _NullGauge()
NULL_HISTOGRAM = _NullHistogram()


# ---------------------------------------------------------------- registry
class MetricsRegistry:
    """Name -> typed handle store.  Handles are memoized, so hot paths
    hold the handle and never re-look-up by name.  A disabled registry
    returns the shared no-op singletons (zero allocation, zero state)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        # counter values at the previous export_jsonl call, so each
        # exported line can carry its own interval delta
        self._last_export: Dict[str, float] = {}

    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return NULL_COUNTER
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return NULL_GAUGE
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str, lo: float = 1e-9,
                  bins_per_decade: int = 64) -> Histogram:
        if not self.enabled:
            return NULL_HISTOGRAM
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name, lo,
                                                   bins_per_decade)
        return h

    # ------------------------------------------------------------- export
    def names(self) -> List[str]:
        return sorted(list(self._counters) + list(self._gauges)
                      + list(self._histograms))

    def snapshot(self) -> Dict[str, Any]:
        """Flat name -> value map: counters/gauges to their value,
        histograms to a {count, mean, min, max, p50...} summary."""
        out: Dict[str, Any] = {}
        for n, c in self._counters.items():
            out[n] = c.value
        for n, g in self._gauges.items():
            out[n] = g.value
        for n, h in self._histograms.items():
            out[n] = h.sketch.summary()
        return out

    def export_jsonl(self, path: str, t: Optional[float] = None,
                     cumulative: bool = False) -> None:
        """Append one snapshot line.  By default the line carries a
        ``delta`` block — every counter's change since the PREVIOUS
        export on this registry, keyed to the logical timestamp ``t`` —
        alongside the cumulative ``metrics`` map, so downstream tools
        read interval rates directly instead of diffing consecutive
        snapshots by hand.  ``cumulative=True`` restores the legacy
        cumulative-only line shape (and does not advance the delta
        baseline)."""
        line: Dict[str, Any] = {"t": t, "metrics": self.snapshot()}
        if not cumulative:
            delta: Dict[str, float] = {}
            for n, c in self._counters.items():
                delta[n] = c.value - self._last_export.get(n, 0)
                self._last_export[n] = c.value
            line["delta"] = delta
        with open(path, "a") as f:
            f.write(json.dumps(line, sort_keys=True) + "\n")


# ----------------------------------------------------------------- catalog
# Metric-name TEMPLATES: ``<x>`` matches exactly one concrete segment
# (operator name, shard index, stage name, ...).  DESIGN.md §12's metric
# table cites these templates verbatim; tools/check_docs.py fails if it
# cites one that is not here, and tests/test_obs.py fails if a live run
# registers a name no template covers.  Keep the three in lockstep.
METRIC_CATALOG: Dict[str, str] = {
    # engine-wide
    "engine.sink.latency":
        "sink end-to-end latency (s), streaming sketch over ALL samples",
    "engine.sink.count": "tuples delivered to sinks",
    "engine.net.data_bytes": "bytes flushed on data channels",
    "engine.net.hint_bytes": "bytes flushed on hint side channels",
    "engine.cpu.util": "aggregate busy fraction across operator slots",
    # per-operator (any operator)
    "engine.<op>.processed": "messages processed by the operator",
    "engine.<op>.busy_frac": "busy-time fraction of the operator's slots",
    "engine.<op>.queue.depth": "input + ready queue depth at snapshot",
    "engine.<op>.watermark.lag":
        "max source event ts minus operator watermark (s)",
    # per-stateful-operator keyed-state plane
    "engine.<op>.cache.hits": "cache hits (all subtasks)",
    "engine.<op>.cache.misses": "cache misses (all subtasks)",
    "engine.<op>.backend.reads": "backend read ops",
    "engine.<op>.backend.writes": "backend write ops",
    "engine.<op>.access.latency":
        "charged state-access latency (s) seen by the PrefetchingManager",
    # hint telemetry (DESIGN.md §12; the headline plane)
    "engine.<op>.hints.received": "hints delivered to the operator",
    "engine.<op>.hints.late": "hints behind the watermark-lateness horizon",
    "engine.<op>.hints.duplicate": "hints for already-resident keys (renew)",
    "engine.<op>.hints.channel_delay":
        "hint-channel delay (s): emit at the lookahead -> receive",
    "engine.<op>.prefetch.staged": "hint-triggered stagings completed",
    "engine.<op>.prefetch.used": "staged entries later read by a tuple",
    "engine.<op>.prefetch.wasted": "staged entries evicted before any use",
    "engine.<op>.prefetch.late":
        "stagings that completed after a tuple already parked on the key",
    "engine.<op>.prefetch.hits": "tuple accesses served by staged state",
    "engine.<op>.prefetch.demand_fetches":
        "unhinted demand fetches (misses the hint plane failed to cover)",
    "engine.<op>.prefetch.lead":
        "hint lead time (s): first access minus stage-complete; <0 = late",
    "engine.<op>.prefetch.stage_latency": "staging I/O latency (s)",
    # hint suppression plane (§13): HintFilter verdicts graded by the
    # next access to the key at the stateful operator
    "engine.<op>.prefetch.suppressed": "hints dropped by the HintFilter",
    "engine.<op>.prefetch.suppress_resident":
        "suppressions graded correct: next access hit cache in-horizon",
    "engine.<op>.prefetch.suppress_miss":
        "suppressions graded incorrect: next access missed in-horizon",
    "engine.<op>.prefetch.suppress_unused":
        "suppressions never followed by an in-horizon access (hint would "
        "have been wasted)",
    # fused device hot path (§14): per-batch device tallies rolled up
    # host-side after each launch
    "engine.<op>.fused.batches": "fused device batches launched",
    "engine.<op>.fused.lanes": "lanes staged across all fused batches",
    "engine.<op>.fused.fill_ratio":
        "lanes / (batches x batch width) — underfilled batches waste "
        "launch cost (fences and drain stalls fragment them)",
    "engine.<op>.fused.device_hits": "device TAC directory probe hits",
    "engine.<op>.fused.device_misses":
        "device TAC directory probe misses (host adjudicates: admit, "
        "park, or write-back race)",
    "engine.<op>.fused.device_conflicts":
        "device misses adjudicated while the plane was FULL (admission "
        "must evict — the streaming analogue of serving probe conflicts)",
    # TAC eviction-reason breakdown, split by admission path
    "engine.<op>.evict.<reason>.<adm>":
        "evictions by reason (capacity|deadline|stale) and admission "
        "(prefetched|demand)",
    # sharded plane (§9)
    "engine.<op>.shard.<shard>.hints_routed": "hints routed to the shard",
    "engine.<op>.shard.<shard>.prefetch_hits": "prefetch hits on the shard",
    "engine.<op>.shard.<shard>.pending":
        "messages parked behind the shard's in-flight migration",
    "engine.<op>.shards.misroutes": "ownership-guard forwards",
    "engine.<op>.shards.migrations": "completed shard migrations",
    # checkpoint / recovery plane (§7)
    "checkpoint.snapshots_taken": "operator-subtask snapshots taken",
    "checkpoint.align_stall_total": "summed barrier alignment stall (s)",
    "checkpoint.align_stall_max": "max barrier alignment stall (s)",
    "checkpoint.align_buffered": "messages buffered during alignment",
    "checkpoint.completed": "epochs completed",
    "checkpoint.bytes": "snapshot bytes persisted",
    "recovery.count": "recoveries performed",
    "recovery.warmup_hints": "hint-WAL + manifest entries replayed at warmup",
    "recovery.restore_s": "modelled restore + warmup wall time (s)",
    # temporal plane (§16): logical-clock timeline + health detectors
    "timeline.intervals": "interval snapshots cut on the logical clock",
    "timeline.evicted":
        "intervals dropped off the bounded ring (reports over a window "
        "older than this are truncated, not silently shorter)",
    "timeline.interval_s": "configured timeline interval (sim seconds)",
    "health.alerts.raised": "health alerts raised (all detectors)",
    "health.alerts.cleared": "raised alerts whose detector returned to ok",
    "health.alerts.active": "detectors currently in the firing state",
    "health.alerts.<kind>":
        "alerts raised per kind: wm_lag|stall|precision|late_wall|"
        "migration|recovery|load_shift",
    # per-tuple critical-path tracing (sampled spans)
    "trace.sampled": "tuples sampled for span tracing",
    "trace.finished":
        "sampled spans finalized (sink delivery or absorbed into state)",
    "trace.probe.hit": "sampled tuples whose state probe hit",
    "trace.probe.miss": "sampled tuples whose state probe missed",
    "trace.stage.<stage>":
        "per-stage critical-path time (s): upstream|park_wait|sync_fetch|"
        "downstream",
    # serving plane (§6)
    "serving.ttft": "time to first token (s)",
    "serving.tpot": "time per output token (s)",
    "serving.requests": "requests enqueued",
    "serving.tokens": "tokens emitted",
    "serving.arena.probe.hits": "device TAC probe hits (tac_probe kernel)",
    "serving.arena.probe.misses": "device TAC probe misses",
    "serving.arena.probe.conflicts":
        "device TAC probe misses landing in a FULL bucket (admission would "
        "evict)",
}


def matches_catalog(name: str, catalog: Optional[Dict[str, str]] = None
                    ) -> bool:
    """True when ``name`` is covered by some catalog template
    (``<x>`` segments match any one concrete segment)."""
    catalog = METRIC_CATALOG if catalog is None else catalog
    parts = name.split(".")
    for tmpl in catalog:
        tparts = tmpl.split(".")
        if len(tparts) != len(parts):
            continue
        if all(tp.startswith("<") or tp == p
               for tp, p in zip(tparts, parts)):
            return True
    return False
