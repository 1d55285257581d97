"""Logical-clock time series over the metrics registry (DESIGN.md §16).

The registry (``registry.py``) is cumulative: every counter is a running
total and every histogram an uncapped streaming sketch, which is exactly
right for end-of-run aggregates and exactly wrong for watching a
transient unfold.  This module adds the temporal axis:

  * ``Timeline`` — on a fixed interval of the engine's DISCRETE-EVENT
    clock (never wall time: runs replay bit-exactly, so the series do
    too), snapshot every registered instrument and keep the per-interval
    view in a bounded ring buffer: counter DELTAS (what happened in the
    interval), gauge SAMPLES (the state at the cut), and histogram
    INTERVAL SKETCHES (a full ``QuantileSketch`` of just the interval's
    observations, so p99-over-10s is a ``merge`` of 100 intervals, not a
    guess from cumulative percentiles).
  * ``interval_sketch`` — the subtraction that makes interval quantiles
    exact: two cumulative sketch states differ only in bin counts, so
    the delta sketch is the bin-wise difference and stays mergeable.

Per-operator and per-shard resolution comes for free: the engine's
``_sync_registry`` mirrors every ``engine.<op>.*`` / ``<op>.shard.<i>.*``
counter before each tick, so the timeline inherits the full catalogued
namespace without any plane-specific wiring.

Stdlib-only, like the registry: ``tools/obs_report.py --timeline`` and
the docs job import this without the jax toolchain.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

from repro_torch.obs.registry import MetricsRegistry, QuantileSketch


def _sketch_state(sk: QuantileSketch) -> tuple:
    """Cheap frozen copy of a cumulative sketch's bin state."""
    return (dict(sk.pos), dict(sk.neg), sk.zero, sk.count, sk.total,
            sk.vmin, sk.vmax)


def interval_sketch(prev: Optional[tuple], sk: QuantileSketch
                    ) -> QuantileSketch:
    """Delta of two cumulative sketch states of the SAME instrument,
    as a standalone mergeable ``QuantileSketch``.

    Cumulative sketches only ever gain observations, so the interval's
    histogram is the bin-wise count difference.  Exact min/max of just
    the interval are not recoverable from bins; the delta clamps to the
    extreme bin midpoints it actually holds (within the sketch's
    relative-error bound), falling back to the cumulative extremes when
    an extreme bin gained counts.
    """
    out = QuantileSketch(sk.lo)
    out._k = sk._k
    ppos, pneg, pzero, pcount, ptotal, pvmin, pvmax = \
        prev if prev is not None else ({}, {}, 0, 0, 0.0,
                                       float("inf"), float("-inf"))
    for b, n in sk.pos.items():
        d = n - ppos.get(b, 0)
        if d > 0:
            out.pos[b] = d
    for b, n in sk.neg.items():
        d = n - pneg.get(b, 0)
        if d > 0:
            out.neg[b] = d
    out.zero = sk.zero - pzero
    out.count = sk.count - pcount
    out.total = sk.total - ptotal
    if out.count <= 0:
        return out
    lo_candidates: List[float] = []
    hi_candidates: List[float] = []
    if out.neg:
        lo_candidates.append(-out._bin_value(max(out.neg)))
        hi_candidates.append(-out._bin_value(min(out.neg)))
    if out.zero:
        lo_candidates.append(0.0)
        hi_candidates.append(0.0)
    if out.pos:
        lo_candidates.append(out._bin_value(min(out.pos)))
        hi_candidates.append(out._bin_value(max(out.pos)))
    out.vmin = min(lo_candidates)
    out.vmax = max(hi_candidates)
    # a new cumulative extreme must have landed in this interval — carry
    # the exact value instead of the bin midpoint
    if sk.vmin < pvmin:
        out.vmin = sk.vmin
    if sk.vmax > pvmax:
        out.vmax = sk.vmax
    return out


class Interval:
    """One timeline cut: everything that happened in ``(t0, t1]``."""

    __slots__ = ("t0", "t1", "deltas", "gauges", "sketches")

    def __init__(self, t0: float, t1: float, deltas: Dict[str, float],
                 gauges: Dict[str, float],
                 sketches: Dict[str, QuantileSketch]):
        self.t0 = t0
        self.t1 = t1
        self.deltas = deltas            # counter name -> interval delta
        self.gauges = gauges            # gauge name -> sample at t1
        self.sketches = sketches        # histogram name -> interval sketch

    def as_record(self) -> Dict[str, Any]:
        """JSON-serializable view (``export.timeline_jsonl``)."""
        q = {}
        for name, sk in self.sketches.items():
            if sk.count:
                q[name] = {"count": sk.count, "mean": sk.mean,
                           "p50": sk.quantile(0.50),
                           "p99": sk.quantile(0.99)}
        return {"t0": self.t0, "t1": self.t1, "deltas": self.deltas,
                "gauges": self.gauges, "quantiles": q}

    def __repr__(self):
        return (f"Interval({self.t0:.3f}..{self.t1:.3f}, "
                f"{len(self.deltas)} deltas)")


class Timeline:
    """Bounded ring of per-interval registry snapshots on the logical
    clock.  The driver (``Engine._timeline_tick``) calls ``tick`` every
    ``interval`` sim seconds after mirroring the operator counters; the
    ring holds the most recent ``capacity`` intervals and evicts the
    oldest beyond that (``evicted`` counts what fell off, so a report
    over a truncated window says so instead of silently covering less).
    """

    def __init__(self, registry: MetricsRegistry, interval: float = 0.1,
                 capacity: int = 600):
        if interval <= 0:
            raise ValueError(f"interval must be > 0, got {interval}")
        if capacity < 2:
            raise ValueError(f"capacity must be >= 2, got {capacity}")
        self.registry = registry
        self.interval = float(interval)
        self.capacity = int(capacity)
        self.ring: deque = deque(maxlen=self.capacity)
        self.intervals_taken = 0
        self.evicted = 0
        self._last_t: Optional[float] = None
        self._prev_counters: Dict[str, float] = {}
        self._prev_hists: Dict[str, tuple] = {}
        # timeline's own instruments live in the same registry/catalog
        self._c_intervals = registry.counter("timeline.intervals")
        self._c_evicted = registry.counter("timeline.evicted")
        registry.gauge("timeline.interval_s").set(self.interval)

    # ------------------------------------------------------------- ticking
    def tick(self, t: float) -> Interval:
        """Cut an interval ending at logical time ``t``."""
        t0 = self._last_t if self._last_t is not None \
            else t - self.interval
        deltas: Dict[str, float] = {}
        for name, c in self.registry._counters.items():
            if name.startswith("timeline."):
                continue                # the meta-counters would self-count
            prev = self._prev_counters.get(name, 0)
            if c.value != prev or name in self._prev_counters:
                deltas[name] = c.value - prev
            self._prev_counters[name] = c.value
        gauges = {name: g.value
                  for name, g in self.registry._gauges.items()
                  if not name.startswith("timeline.")}
        sketches: Dict[str, QuantileSketch] = {}
        for name, h in self.registry._histograms.items():
            sk = interval_sketch(self._prev_hists.get(name), h.sketch)
            self._prev_hists[name] = _sketch_state(h.sketch)
            if sk.count:
                sketches[name] = sk
        iv = Interval(t0, t, deltas, gauges, sketches)
        if len(self.ring) == self.capacity:
            self.evicted += 1
        self.ring.append(iv)
        self.intervals_taken += 1
        self._last_t = t
        self._c_intervals.set(self.intervals_taken)
        self._c_evicted.set(self.evicted)
        return iv

    # ------------------------------------------------------------ querying
    def select(self, since: Optional[float] = None,
               until: Optional[float] = None) -> List[Interval]:
        """Retained intervals whose END time lies in [since, until]."""
        lo = float("-inf") if since is None else since
        hi = float("inf") if until is None else until
        return [iv for iv in self.ring if lo <= iv.t1 <= hi]

    def series(self, name: str, since: Optional[float] = None,
               until: Optional[float] = None
               ) -> List[Tuple[float, float]]:
        """(t1, value) points for a counter delta or gauge sample."""
        out = []
        for iv in self.select(since, until):
            if name in iv.deltas:
                out.append((iv.t1, iv.deltas[name]))
            elif name in iv.gauges:
                out.append((iv.t1, iv.gauges[name]))
        return out

    def merged_sketch(self, name: str, since: Optional[float] = None,
                      until: Optional[float] = None) -> QuantileSketch:
        """Quantiles over a window = merge of its interval sketches."""
        out = QuantileSketch()
        for iv in self.select(since, until):
            sk = iv.sketches.get(name)
            if sk is not None:
                if not out.count:
                    out.lo, out._k = sk.lo, sk._k
                out.merge(sk)
        return out

    def ratio_series(self, num: str, den: Iterable[str],
                     min_den: float = 1.0,
                     since: Optional[float] = None,
                     until: Optional[float] = None
                     ) -> List[Tuple[float, float]]:
        """Per-interval ``num / sum(den)`` (e.g. interval precision =
        Δused / (Δstaged + Δlate)); intervals whose denominator is below
        ``min_den`` are skipped rather than reported as noise."""
        den = list(den)
        out = []
        for iv in self.select(since, until):
            d = sum(iv.deltas.get(n, 0) for n in den)
            if d < min_den:
                continue
            out.append((iv.t1, iv.deltas.get(num, 0) / d))
        return out

    # ------------------------------------------------------------- summary
    def block(self) -> Dict[str, Any]:
        """Rollup for ``Engine.metrics`` / BENCH_obs.json."""
        return {"intervals": self.intervals_taken,
                "retained": len(self.ring),
                "evicted": self.evicted,
                "interval_s": self.interval,
                "capacity": self.capacity,
                "t_last": self._last_t}
