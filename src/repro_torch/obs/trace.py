"""Per-tuple critical-path tracing on the sim clock (DESIGN.md §12).

Every Nth source tuple gets a ``TupleTrace`` attached (``Tuple_.trace``);
operators stamp the few marks that matter — stateful arrival, park /
resume, charged synchronous fetch time, apply/emit — and the sink
finalizes the span into per-stage histograms of the shared
``MetricsRegistry`` plus a bounded ring of raw span records for
``tools/obs_report.py``.

Stage model (a tuple's end-to-end latency decomposes into):

  * ``upstream``   — source emit -> stateful-operator arrival (parse
    operators, network flush/hops, input-queue wait);
  * ``park_wait``  — async-miss park -> resume (the state-staging time
    left on the tuple's own critical path; zero on a cache hit);
  * ``sync_fetch`` — backend latency CHARGED synchronously on this
    tuple (sync-mode fetch, parked-then-evicted refetch).  NOTE: in the
    discrete-event engine a sync charge delays the operator's NEXT
    message, not this tuple's own emission, so this stage measures
    blocking cost on the pipeline rather than a slice of this tuple's
    sink latency — stages therefore need not sum exactly to the total;
  * ``downstream`` — apply/emit -> sink (output network + sink queue).

Tracing is OFF by default (``sample_every=0``): sources check one flag
per tuple and every operator mark is behind a ``trace is not None``
test, so the disabled cost is a no-op attribute read.  The overhead gate
(``benchmarks/obs.py`` + ``tools/bench_gate.py``) holds tracing-enabled
wall-clock throughput within 5% of disabled.
"""
from __future__ import annotations

from collections import deque
from typing import Any, Deque, Dict, List, Optional

from repro_torch.obs.registry import MetricsRegistry, QuantileSketch

STAGES = ("upstream", "park_wait", "sync_fetch", "downstream")


class TupleTrace:
    """Span marks for one sampled tuple.  Slots only — these are created
    on the source hot path when sampling is on."""

    __slots__ = ("t0", "op", "t_state", "t_park", "t_resume", "t_apply",
                 "fetch_s", "hit", "done")

    def __init__(self, t0: float):
        self.t0 = t0
        self.op: Optional[str] = None
        self.t_state: Optional[float] = None
        self.t_park: Optional[float] = None
        self.t_resume: Optional[float] = None
        self.t_apply: Optional[float] = None
        self.fetch_s = 0.0
        self.hit: Optional[bool] = None
        self.done = False

    # marks (called from the engine; each behind a `trace is not None`)
    def mark_state(self, op: str, t: float) -> None:
        if self.t_state is None:
            self.op = op
            self.t_state = t

    def mark_park(self, t: float) -> None:
        if self.t_park is None:
            self.t_park = t

    def mark_resume(self, t: float) -> None:
        self.t_resume = t

    def mark_apply(self, t: float) -> None:
        self.t_apply = t

    def stages(self, t_sink: float) -> Dict[str, float]:
        out = dict.fromkeys(STAGES, 0.0)
        t_state = self.t_state if self.t_state is not None else t_sink
        out["upstream"] = max(0.0, t_state - self.t0)
        if self.t_park is not None:
            out["park_wait"] = max(
                0.0, (self.t_resume if self.t_resume is not None
                      else t_sink) - self.t_park)
        out["sync_fetch"] = self.fetch_s
        t_leave = self.t_apply if self.t_apply is not None else t_state
        out["downstream"] = max(0.0, t_sink - t_leave)
        return out


class Tracer:
    """Sampling controller + span aggregation into the registry."""

    def __init__(self, registry: MetricsRegistry,
                 keep_spans: int = 4096):
        self.registry = registry
        self.sample_every = 0            # 0 = disabled
        self._n = 0
        self.spans: Deque[Dict[str, Any]] = deque(maxlen=keep_spans)
        self._stage_hist = {s: registry.histogram(f"trace.stage.{s}")
                            for s in STAGES}
        self._sampled = registry.counter("trace.sampled")
        self._finished = registry.counter("trace.finished")
        self._hit = registry.counter("trace.probe.hit")
        self._miss = registry.counter("trace.probe.miss")

    @property
    def active(self) -> bool:
        return self.sample_every > 0

    def enable(self, sample_every: int = 64) -> None:
        self.sample_every = max(0, int(sample_every))

    def maybe_start(self, t0: float) -> Optional[TupleTrace]:
        """One branch per source tuple; allocates only on sampled ones.
        Safe to call disabled (callers on the hot path pre-check
        ``sample_every`` to skip even the counter increment)."""
        if not self.sample_every:
            return None
        self._n += 1
        if self._n % self.sample_every:
            return None
        self._sampled.inc()
        return TupleTrace(t0)

    def finish(self, trace: TupleTrace, t_sink: float) -> None:
        """Sink-side finalization.  A trace shared by several emitted
        tuples (pane expansion, multi-output operators) finalizes once."""
        if trace.done:
            return
        trace.done = True
        self._finished.inc()
        if trace.hit is True:
            self._hit.inc()
        elif trace.hit is False:
            self._miss.inc()
        stages = trace.stages(t_sink)
        for s, v in stages.items():
            self._stage_hist[s].observe(v)
        rec = {"t0": trace.t0, "t_sink": t_sink, "op": trace.op,
               "total": t_sink - trace.t0, "hit": trace.hit}
        rec.update(stages)
        self.spans.append(rec)

    # ------------------------------------------------------------- report
    def summary(self) -> Dict[str, Any]:
        """Per-stage breakdown + the dominant critical-path stage (by
        total time across sampled spans)."""
        out: Dict[str, Any] = {"sampled": self._sampled.value,
                               "finished": self._finished.value,
                               "probe_hits": self._hit.value,
                               "probe_misses": self._miss.value}
        totals = {}
        for s in STAGES:
            sk = self._stage_hist[s].sketch
            totals[s] = sk.total
            out[s] = {"mean": sk.mean, "p50": sk.quantile(0.50),
                      "p99": sk.quantile(0.99), "total": sk.total,
                      "count": sk.count}
        grand = sum(totals.values())
        for s in STAGES:
            out[s]["share"] = totals[s] / grand if grand > 0 else 0.0
        out["dominant_stage"] = max(totals, key=totals.get) if grand > 0 \
            else None
        return out

    def reset(self) -> None:
        """Warmup boundary: drop spans sampled before measurement starts
        and restart the per-stage histograms (counters keep counting —
        they are cumulative like the engine's)."""
        self.spans.clear()
        for h in self._stage_hist.values():
            if hasattr(h, "sketch"):
                h.sketch = QuantileSketch()


def attach(tuples: List[Any], trace: Optional[TupleTrace]) -> None:
    """Propagate a sampled trace onto derived tuples (map outputs, pane
    expansions, operator emissions) — no-op when the input was not
    sampled."""
    if trace is not None:
        for o in tuples:
            if getattr(o, "trace", None) is None:
                o.trace = trace
