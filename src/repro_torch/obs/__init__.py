"""Unified observability plane (DESIGN.md §12, §16): metrics registry
with streaming quantile sketches, per-tuple critical-path tracing,
prefetch-quality (hint timeliness/accuracy) telemetry, logical-clock
time series with health detectors, and Perfetto/Chrome-trace export."""
from repro_torch.obs.export import (chrome_trace, read_timeline_jsonl,
                              timeline_jsonl)
from repro_torch.obs.health import (Alert, Detector, HealthMonitor,
                              LoadShiftDetector, ORACLE_KINDS,
                              SpikeDetector)
from repro_torch.obs.quality import PrefetchRecorder
from repro_torch.obs.registry import (
    METRIC_CATALOG,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NULL_COUNTER,
    NULL_GAUGE,
    NULL_HISTOGRAM,
    QuantileSketch,
    matches_catalog,
)
from repro_torch.obs.timeseries import Interval, Timeline, interval_sketch
from repro_torch.obs.trace import STAGES, Tracer, TupleTrace, attach

__all__ = [
    "Alert",
    "Detector",
    "HealthMonitor",
    "Interval",
    "LoadShiftDetector",
    "METRIC_CATALOG",
    "ORACLE_KINDS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NULL_COUNTER",
    "NULL_GAUGE",
    "NULL_HISTOGRAM",
    "PrefetchRecorder",
    "QuantileSketch",
    "SpikeDetector",
    "Timeline",
    "chrome_trace",
    "interval_sketch",
    "matches_catalog",
    "read_timeline_jsonl",
    "timeline_jsonl",
    "STAGES",
    "Tracer",
    "TupleTrace",
    "attach",
]
