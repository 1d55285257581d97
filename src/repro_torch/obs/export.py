"""Trace + time-series export (DESIGN.md §16).

Two consumers, two formats:

  * ``chrome_trace`` — a Chrome-trace/Perfetto JSON object
    (``chrome://tracing`` / ui.perfetto.dev both load it) fusing every
    temporal artifact one run produces: sampled per-tuple spans (§12)
    as nested slices on per-operator tracks, engine events (epoch
    barriers, migrations, failures/recoveries, window fires) as slices
    and instants on a control track, health alerts as slices spanning
    raise->clear, and timeline series as counter tracks.  All times are
    the sim's logical clock scaled to microseconds (the trace viewer's
    native unit).
  * ``timeline_jsonl`` — one line per timeline interval (the
    ``Interval.as_record`` shape) plus one line per alert, the input
    ``tools/obs_report.py --timeline`` renders and ``--since/--until``
    filter.

Stdlib-only, like the rest of the obs plane.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional

from repro_torch.obs.health import Alert
from repro_torch.obs.timeseries import Timeline

# fixed virtual pids: one per track family, so the viewer groups them
PID_SPANS = 1
PID_CONTROL = 2
PID_COUNTERS = 3

# timeline series promoted to counter tracks (gauge name -> track name);
# <op> expands per operator seen in the intervals
COUNTER_TRACKS = (
    ("engine.<op>.queue.depth", "queue depth"),
    ("engine.<op>.watermark.lag", "watermark lag (s)"),
    ("engine.<op>.fused.fill_ratio", "fused fill ratio"),
)


def _us(t: float) -> int:
    return int(round(t * 1e6))


def _meta(pid: int, name: str, tid: Optional[int] = None,
          tname: Optional[str] = None) -> List[dict]:
    out = [{"ph": "M", "pid": pid, "name": "process_name",
            "args": {"name": name}}]
    if tid is not None:
        out.append({"ph": "M", "pid": pid, "tid": tid,
                    "name": "thread_name", "args": {"name": tname}})
    return out


def _span_events(spans: Iterable[Dict[str, Any]]) -> List[dict]:
    """Sampled tuple spans -> nested slices: the whole tuple as the
    outer slice, its stages laid out inside it.  ``sync_fetch`` measures
    pipeline blocking, not a slice of this tuple's latency (trace.py),
    so it renders as an instant annotation rather than a sub-slice."""
    evs: List[dict] = []
    tids: Dict[str, int] = {}
    for rec in spans:
        op = rec.get("op") or "?"
        tid = tids.setdefault(op, len(tids) + 1)
        t0, t_sink = rec["t0"], rec["t_sink"]
        if t_sink < t0:
            continue
        hit = rec.get("hit")
        evs.append({"ph": "X", "pid": PID_SPANS, "tid": tid,
                    "name": "tuple", "cat": "span",
                    "ts": _us(t0), "dur": max(1, _us(t_sink - t0)),
                    "args": {"hit": hit,
                             "sync_fetch_s": rec.get("sync_fetch", 0.0)}})
        cur = t0
        for stage in ("upstream", "park_wait", "downstream"):
            d = rec.get(stage, 0.0)
            if d <= 0.0:
                continue
            if stage == "downstream":
                start = max(cur, t_sink - d)
            else:
                start = cur
            evs.append({"ph": "X", "pid": PID_SPANS, "tid": tid,
                        "name": stage, "cat": "stage",
                        "ts": _us(start), "dur": max(1, _us(d))})
            cur = start + d
        sf = rec.get("sync_fetch", 0.0)
        if sf > 0.0:
            evs.append({"ph": "i", "pid": PID_SPANS, "tid": tid,
                        "name": f"sync_fetch {sf*1e3:.2f}ms",
                        "cat": "stage", "ts": _us(t_sink), "s": "t"})
    meta = _meta(PID_SPANS, "tuple spans")
    for op, tid in tids.items():
        meta += [{"ph": "M", "pid": PID_SPANS, "tid": tid,
                  "name": "thread_name", "args": {"name": op}}]
    return meta + evs


# engine event kinds that OPEN a slice and the kind that closes it
_PAIRED = {"epoch_trigger": ("epoch_complete", "epoch", 1),
           "migrate_begin": ("migrate_end", "migration", 2),
           "failure": ("recovered", "recovery", 3)}
_TID_FIRES = 4
_TID_ALERTS = 5


def _control_events(events: Iterable[tuple]) -> List[dict]:
    """Engine event log -> control-track slices/instants.  Events are
    ``(kind, t, fields)``; paired kinds (epoch trigger/complete,
    migrate begin/end, failure/recovered) become duration slices matched
    by their correlation field, window fires become instants."""
    evs: List[dict] = []
    open_by_key: Dict[tuple, tuple] = {}
    for kind, t, fields in events:
        if kind in _PAIRED:
            close_kind, name, tid = _PAIRED[kind]
            key = (close_kind, fields.get("id"))
            open_by_key[key] = (t, name, tid, dict(fields))
        elif any(kind == ck for ck, _, _ in _PAIRED.values()):
            key = (kind, fields.get("id"))
            opened = open_by_key.pop(key, None)
            if opened is None:
                continue                 # close without open (pre-export)
            t0, name, tid, args = opened
            args.update(fields)
            evs.append({"ph": "X", "pid": PID_CONTROL, "tid": tid,
                        "name": name, "cat": "control", "ts": _us(t0),
                        "dur": max(1, _us(t - t0)), "args": args})
        elif kind == "fire":
            evs.append({"ph": "i", "pid": PID_CONTROL, "tid": _TID_FIRES,
                        "name": "fire", "cat": "control", "ts": _us(t),
                        "s": "t", "args": dict(fields)})
    # unterminated opens (an epoch in flight at export) render to run end
    for (_, _id), (t0, name, tid, args) in open_by_key.items():
        evs.append({"ph": "i", "pid": PID_CONTROL, "tid": tid,
                    "name": f"{name} (open)", "cat": "control",
                    "ts": _us(t0), "s": "t", "args": args})
    meta = _meta(PID_CONTROL, "control plane")
    for name, tid in (("epochs", 1), ("migrations", 2),
                      ("recoveries", 3), ("fires", _TID_FIRES),
                      ("alerts", _TID_ALERTS)):
        meta.append({"ph": "M", "pid": PID_CONTROL, "tid": tid,
                     "name": "thread_name", "args": {"name": name}})
    return meta + evs


def _alert_events(alerts: Iterable[Alert], t_end: float) -> List[dict]:
    evs: List[dict] = []
    for a in alerts:
        t1 = a.cleared_t if a.cleared_t is not None else t_end
        evs.append({"ph": "X", "pid": PID_CONTROL, "tid": _TID_ALERTS,
                    "name": f"ALERT {a.kind}", "cat": "health",
                    "ts": _us(a.t), "dur": max(1, _us(t1 - a.t)),
                    "args": a.as_dict()})
    return evs


def _counter_events(timeline: Timeline) -> List[dict]:
    evs: List[dict] = list(_meta(PID_COUNTERS, "timeline"))
    ops = set()
    for iv in timeline.ring:
        for g in iv.gauges:
            if g.startswith("engine.") and g.endswith(".queue.depth"):
                ops.add(g.split(".")[1])
    for iv in timeline.ring:
        for tmpl, track in COUNTER_TRACKS:
            for op in sorted(ops):
                name = tmpl.replace("<op>", op)
                if name in iv.gauges:
                    evs.append({"ph": "C", "pid": PID_COUNTERS, "tid": 0,
                                "name": f"{op} {track}",
                                "ts": _us(iv.t1),
                                "args": {"value": iv.gauges[name]}})
        d = iv.deltas.get("engine.sink.count")
        if d is not None:
            span = max(1e-9, iv.t1 - iv.t0)
            evs.append({"ph": "C", "pid": PID_COUNTERS, "tid": 0,
                        "name": "sink throughput (tup/s)",
                        "ts": _us(iv.t1), "args": {"value": d / span}})
    return evs


def chrome_trace(engine, path: Optional[str] = None) -> Dict[str, Any]:
    """Build (and optionally write) the Chrome-trace JSON for a run:
    tracer spans + engine events + health alerts + timeline counters.
    Safe on partially-enabled runs — absent planes contribute nothing.
    """
    events: List[dict] = []
    tracer = getattr(engine, "tracer", None)
    if tracer is not None and tracer.spans:
        events += _span_events(tracer.spans)
    events += _control_events(getattr(engine, "events", ()))
    t_end = engine.sim.t
    health = getattr(engine, "health", None)
    if health is not None and health.alerts:
        events += _alert_events(health.alerts, t_end)
    timeline = getattr(engine, "timeline", None)
    if timeline is not None and timeline.ring:
        events += _counter_events(timeline)
    doc = {"traceEvents": events, "displayTimeUnit": "ms",
           "otherData": {"clock": "sim-logical",
                         "t_end_s": t_end,
                         "source": "repro_torch.obs.export.chrome_trace"}}
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f)
    return doc


def timeline_jsonl(timeline: Timeline, path: str,
                   alerts: Optional[Iterable[Alert]] = None,
                   append: bool = False) -> int:
    """Write the retained intervals (+ alerts) as JSONL; returns the
    line count.  Interval lines are ``Interval.as_record`` dicts, alert
    lines are ``{"alert": {...}}`` — both carry logical timestamps, so
    downstream filters never diff snapshots by hand."""
    n = 0
    with open(path, "a" if append else "w") as f:
        for iv in timeline.ring:
            f.write(json.dumps(iv.as_record(), sort_keys=True) + "\n")
            n += 1
        for a in (alerts or ()):
            f.write(json.dumps({"alert": a.as_dict()},
                               sort_keys=True) + "\n")
            n += 1
    return n


def read_timeline_jsonl(path: str):
    """Parse a ``timeline_jsonl`` file back into (interval records,
    alert records), preserving order."""
    intervals: List[dict] = []
    alerts: List[dict] = []
    with open(path) as f:
        for raw in f:
            raw = raw.strip()
            if not raw:
                continue
            rec = json.loads(raw)
            if "alert" in rec:
                alerts.append(rec["alert"])
            else:
                intervals.append(rec)
    return intervals, alerts
