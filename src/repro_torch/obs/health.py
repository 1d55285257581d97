"""Health detectors over the timeline, with hysteresis (DESIGN.md §16).

A raw threshold on a noisy series flaps: one interval above, one below,
an alert storm that trains operators to ignore the channel.  Every
detector here is a two-threshold, two-count state machine instead:

    ok      --[value past FIRE threshold for fire_after consecutive
               intervals]-->                                    firing
    firing  --[value past CLEAR threshold for clear_after consecutive
               intervals]-->                                    ok

with ``fire`` strictly tighter than ``clear`` (a gap the noise must
cross twice), so a series oscillating around either single threshold
raises at most one alert — the property ``tests/test_timeline.py``
checks with hypothesis.  Intervals whose supporting volume is below
``min_volume`` (e.g. a precision ratio over 3 stagings) don't advance
either count: low-traffic intervals carry no evidence.

``HealthMonitor`` wires the default detector set over the catalogued
series (watermark-lag growth, queue-depth stall, prefetch-precision
collapse, late-staging-wall onset, migration/recovery spikes, load
shifts) and emits typed ``Alert`` events on the same logical clock the
timeline cuts on.  The chaos harness (streaming/chaos.py) turns seeded
fault schedules into ground truth for these alerts — the alert oracle
gated in BENCH_obs.json.
"""
from __future__ import annotations

import statistics
from typing import Any, Callable, Dict, List, Optional

from repro_torch.obs.timeseries import Interval, Timeline


class Alert:
    """One typed health event on the logical clock.  ``raised`` alerts
    get ``cleared_t`` stamped when their detector returns to ok."""

    __slots__ = ("kind", "op", "t", "value", "threshold", "message",
                 "cleared_t")

    def __init__(self, kind: str, op: Optional[str], t: float,
                 value: float, threshold: float, message: str):
        self.kind = kind
        self.op = op
        self.t = t
        self.value = value
        self.threshold = threshold
        self.message = message
        self.cleared_t: Optional[float] = None

    def as_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "op": self.op, "t": self.t,
                "value": self.value, "threshold": self.threshold,
                "message": self.message, "cleared_t": self.cleared_t}

    def __repr__(self):
        state = "" if self.cleared_t is None \
            else f" cleared@{self.cleared_t:.3f}"
        return (f"Alert({self.kind}@{self.t:.3f} op={self.op} "
                f"value={self.value:.4g}{state})")


class Detector:
    """Hysteresis threshold detector over one scalar series.

    ``direction="above"`` fires when the value exceeds ``fire`` and
    clears below ``clear`` (``fire > clear``); ``direction="below"``
    fires under ``fire`` and clears above ``clear`` (``fire < clear``).
    ``update`` returns a new ``Alert`` exactly on the ok->firing edge.
    """

    def __init__(self, kind: str, fire: float, clear: float,
                 direction: str = "above", fire_after: int = 2,
                 clear_after: int = 2, op: Optional[str] = None):
        if direction not in ("above", "below"):
            raise ValueError(f"direction {direction!r}")
        if direction == "above" and not fire > clear:
            raise ValueError("hysteresis needs fire > clear")
        if direction == "below" and not fire < clear:
            raise ValueError("hysteresis needs fire < clear")
        if fire_after < 1 or clear_after < 1:
            raise ValueError("fire_after/clear_after must be >= 1")
        self.kind = kind
        self.op = op
        self.fire = fire
        self.clear = clear
        self.direction = direction
        self.fire_after = fire_after
        self.clear_after = clear_after
        self.firing = False
        self._hot = 0                   # consecutive fire-side intervals
        self._cool = 0                  # consecutive clear-side intervals
        self.active: Optional[Alert] = None

    def _past_fire(self, v: float) -> bool:
        return v > self.fire if self.direction == "above" else v < self.fire

    def _past_clear(self, v: float) -> bool:
        return v < self.clear if self.direction == "above" \
            else v > self.clear

    def update(self, t: float, value: Optional[float]) -> Optional[Alert]:
        """Advance one interval; ``value=None`` (no evidence) freezes
        both counts."""
        if value is None:
            return None
        if not self.firing:
            self._hot = self._hot + 1 if self._past_fire(value) else 0
            if self._hot >= self.fire_after:
                self.firing = True
                self._hot = 0
                self._cool = 0
                cmp = ">" if self.direction == "above" else "<"
                self.active = Alert(
                    self.kind, self.op, t, value, self.fire,
                    f"{self.kind}: {value:.4g} {cmp} {self.fire:.4g} "
                    f"for {self.fire_after} intervals")
                return self.active
        else:
            self._cool = self._cool + 1 if self._past_clear(value) else 0
            if self._cool >= self.clear_after:
                self.firing = False
                self._cool = 0
                if self.active is not None:
                    self.active.cleared_t = t
                    self.active = None
        return None


class SpikeDetector:
    """Edge detector for rare-event counters (migrations, recoveries):
    any positive interval delta raises one alert per burst; the burst
    closes after ``clear_after`` quiet intervals, so N migrations inside
    one window raise one alert, not N."""

    def __init__(self, kind: str, op: Optional[str] = None,
                 clear_after: int = 2):
        self.kind = kind
        self.op = op
        self.clear_after = clear_after
        self.firing = False
        self._quiet = 0
        self.active: Optional[Alert] = None

    def update(self, t: float, delta: Optional[float]) -> Optional[Alert]:
        if delta is None:
            delta = 0.0
        if delta > 0:
            self._quiet = 0
            if not self.firing:
                self.firing = True
                self.active = Alert(
                    self.kind, self.op, t, delta, 0.0,
                    f"{self.kind}: +{delta:g} in interval")
                return self.active
        elif self.firing:
            self._quiet += 1
            if self._quiet >= self.clear_after:
                self.firing = False
                if self.active is not None:
                    self.active.cleared_t = t
                    self.active = None
        return None


class LoadShiftDetector:
    """Throughput-shift detector: the interval's delivered count
    against the median of the trailing ``window`` intervals.  Fires when
    the ratio leaves [1/band, band] for ``fire_after`` consecutive
    intervals; clears inside the narrower band.  The baseline FREEZES
    while firing (otherwise the shifted rate becomes the new normal and
    the alert clears on its own)."""

    def __init__(self, kind: str = "load_shift", band: float = 1.6,
                 clear_band: float = 1.25, window: int = 8,
                 fire_after: int = 2, clear_after: int = 2,
                 min_volume: float = 20.0, op: Optional[str] = None):
        if not band > clear_band > 1.0:
            raise ValueError("need band > clear_band > 1.0")
        self.kind = kind
        self.op = op
        self.band = band
        self.clear_band = clear_band
        self.window = window
        self.fire_after = fire_after
        self.clear_after = clear_after
        self.min_volume = min_volume
        self.history: List[float] = []
        self.firing = False
        self._hot = 0
        self._cool = 0
        self.active: Optional[Alert] = None

    def update(self, t: float, count: Optional[float]) -> Optional[Alert]:
        if count is None:
            return None
        if len(self.history) < max(2, self.window // 2):
            self.history.append(count)
            return None
        base = statistics.median(self.history)
        if base < self.min_volume:
            # too quiet to define "normal" — keep learning, never fire
            self.history.append(count)
            del self.history[:-self.window]
            return None
        ratio = count / base
        shifted = ratio > self.band or ratio < 1.0 / self.band
        inside = 1.0 / self.clear_band < ratio < self.clear_band
        out = None
        if not self.firing:
            self._hot = self._hot + 1 if shifted else 0
            if self._hot >= self.fire_after:
                self.firing = True
                self._hot = self._cool = 0
                self.active = Alert(
                    self.kind, self.op, t, ratio, self.band,
                    f"load shift: x{ratio:.2f} of trailing median "
                    f"{base:.0f}/interval")
                out = self.active
            else:
                self.history.append(count)
                del self.history[:-self.window]
        else:
            self._cool = self._cool + 1 if inside else 0
            if self._cool >= self.clear_after:
                self.firing = False
                self._cool = 0
                if self.active is not None:
                    self.active.cleared_t = t
                    self.active = None
                self.history.append(count)
                del self.history[:-self.window]
        return out


# detector kinds the chaos alert oracle maps injected faults onto
# (streaming/chaos.py): failure -> recovery, migrate -> migration,
# load_shift -> load_shift
ORACLE_KINDS = {"failure": "recovery", "migrate": "migration",
                "load_shift": "load_shift"}


class HealthMonitor:
    """The default detector set over a ``Timeline``, per stateful
    operator where the signal is operator-scoped.  ``observe(interval)``
    advances every detector one step and returns (and retains) the
    alerts raised on that cut.  Thresholds are constructor arguments so
    tests and the chaos bench can tighten or relax them; the defaults
    are calibrated to stay silent on the golden chaos run
    (DESIGN.md §16's soundness condition)."""

    def __init__(self, timeline: Timeline, ops: List[str],
                 registry=None,
                 wm_lag_fire: float = 1.0, wm_lag_clear: float = 0.5,
                 queue_fire: float = 256.0, queue_clear: float = 64.0,
                 precision_fire: float = 0.30,
                 precision_clear: float = 0.45,
                 late_wall_fire: float = 0.35,
                 late_wall_clear: float = 0.20,
                 min_volume: float = 12.0,
                 load_band: float = 1.6, fire_after: int = 2):
        self.timeline = timeline
        self.ops = list(ops)
        self.registry = registry if registry is not None \
            else timeline.registry
        self.min_volume = min_volume
        self.alerts: List[Alert] = []
        self.detectors: List[Any] = []
        self._extract: Dict[int, Callable[[Interval], Optional[float]]] = {}

        def add(det, fn):
            self.detectors.append(det)
            self._extract[id(det)] = fn

        def gauge_of(name):
            return lambda iv, n=name: iv.gauges.get(n)

        def delta_of(name):
            return lambda iv, n=name: iv.deltas.get(n, 0.0)

        for op in self.ops:
            pre = f"engine.{op}"
            add(Detector("wm_lag", wm_lag_fire, wm_lag_clear,
                         fire_after=fire_after, op=op),
                gauge_of(f"{pre}.watermark.lag"))
            add(Detector("stall", queue_fire, queue_clear,
                         fire_after=fire_after, op=op),
                gauge_of(f"{pre}.queue.depth"))
            add(Detector("precision", precision_fire, precision_clear,
                         direction="below", fire_after=fire_after, op=op),
                self._ratio(f"{pre}.prefetch.used",
                            (f"{pre}.prefetch.staged",
                             f"{pre}.prefetch.late")))
            add(Detector("late_wall", late_wall_fire, late_wall_clear,
                         fire_after=fire_after, op=op),
                self._ratio(f"{pre}.prefetch.late",
                            (f"{pre}.prefetch.staged",
                             f"{pre}.prefetch.late")))
            add(SpikeDetector("migration", op=op),
                delta_of(f"{pre}.shards.migrations"))
            # load shift watches the operator's PROCESSED delta, not the
            # sink count: windowed sinks emit in fire bursts whose
            # per-interval rate whipsaws on a perfectly healthy run,
            # while the input side tracks the source rate smoothly
            add(LoadShiftDetector(band=load_band, fire_after=fire_after,
                                  min_volume=max(min_volume, 50.0),
                                  op=op),
                delta_of(f"{pre}.processed"))
        add(SpikeDetector("recovery"), delta_of("recovery.count"))
        # health-plane instruments (catalogued: health.*)
        self._c_raised = self.registry.counter("health.alerts.raised")
        self._c_cleared = self.registry.counter("health.alerts.cleared")
        self._g_active = self.registry.gauge("health.alerts.active")

    def _ratio(self, num: str, den: tuple
               ) -> Callable[[Interval], Optional[float]]:
        def fn(iv: Interval) -> Optional[float]:
            d = sum(iv.deltas.get(n, 0.0) for n in den)
            if d < self.min_volume:
                return None             # no evidence this interval
            return iv.deltas.get(num, 0.0) / d
        return fn

    def observe(self, iv: Interval) -> List[Alert]:
        new: List[Alert] = []
        for det in self.detectors:
            a = det.update(iv.t1, self._extract[id(det)](iv))
            if a is not None:
                new.append(a)
        self.alerts.extend(new)
        if new:
            self._c_raised.set(len(self.alerts))
        for a in new:
            self.registry.counter(f"health.alerts.{a.kind}").inc()
        cleared = sum(1 for a in self.alerts if a.cleared_t is not None)
        self._c_cleared.set(cleared)
        self._g_active.set(sum(1 for d in self.detectors if d.firing))
        return new

    # ------------------------------------------------------------- summary
    def by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for a in self.alerts:
            out[a.kind] = out.get(a.kind, 0) + 1
        return out

    def block(self) -> Dict[str, Any]:
        return {"raised": len(self.alerts),
                "cleared": sum(1 for a in self.alerts
                               if a.cleared_t is not None),
                "active": sum(1 for d in self.detectors if d.firing),
                "by_kind": self.by_kind()}
