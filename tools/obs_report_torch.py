#!/usr/bin/env python3
# Copy of tools/obs_report.py on repro_torch; differs only in `device`:
# --device (default cuda) goes to the --fused run's fused plane.
"""Render the observability plane's view of a run (DESIGN.md §12, §16).

Three modes:

  * default — build the q5 smoke pipeline (same config as the windowing
    benchmark's smoke tier), run it with per-tuple tracing enabled, and
    print the critical-path latency breakdown: a per-stage table (count,
    mean, p50, p99, total, share) with the DOMINANT stage flagged, the
    hint-quality block (staged/used/wasted/late, precision, recall,
    signed lead-time percentiles), and the eviction-reason split;
  * ``--timeline`` — run the same pipeline with the temporal plane
    enabled (DESIGN.md §16) and print the per-interval view: precision,
    recall, watermark lag, and hit-rate series on the logical clock with
    sparklines, plus every health alert the detectors raised.
    ``--since``/``--until`` restrict the printed window (logical time);
  * ``--snapshot FILE.jsonl`` — read a registry export produced by
    ``Engine.enable_export`` and print the last snapshot's metrics
    (optionally filtered by ``--grep SUBSTRING``).  Exports carry a
    per-line ``delta`` block since PR 10; the report sums it for the
    interval-rate column and falls back to diffing first/last lines on
    legacy cumulative-only files.

    PYTHONPATH=src python tools/obs_report_torch.py
    PYTHONPATH=src python tools/obs_report_torch.py --timeline --since 1.0
    PYTHONPATH=src python tools/obs_report_torch.py --snapshot run.jsonl --grep prefetch

On the PyTorch port, ``--device`` (default ``cuda``) places the ``--fused``
run's keyed state, whose batches run the fused kernels there; ``--device
cpu`` prints what ``tools/obs_report.py`` prints.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def fmt_s(v: float) -> str:
    """Seconds -> aligned ms string (lead times may be negative)."""
    return f"{v * 1e3:9.3f}ms"


def print_stage_table(trace: dict) -> None:
    from repro_torch.obs import STAGES
    dom = trace.get("dominant_stage")
    print(f"\ncritical-path stages ({trace.get('finished', 0)} sampled "
          f"spans; probe hit/miss "
          f"{trace.get('probe_hits', 0)}/{trace.get('probe_misses', 0)}):")
    hdr = (f"  {'stage':<12s} {'count':>7s} {'mean':>11s} {'p50':>11s} "
           f"{'p99':>11s} {'total':>10s} {'share':>6s}")
    print(hdr)
    print("  " + "-" * (len(hdr) - 2))
    for s in STAGES:
        st = trace.get(s)
        if not st:
            continue
        flag = "  <- dominant" if s == dom else ""
        print(f"  {s:<12s} {st['count']:>7d} {fmt_s(st['mean'])} "
              f"{fmt_s(st['p50'])} {fmt_s(st['p99'])} "
              f"{st['total']:>9.3f}s {st['share']:>6.1%}{flag}")
    if dom:
        print(f"  dominant stage: {dom} "
              f"({trace[dom]['share']:.0%} of sampled critical-path time)")


def print_quality(hq: dict, evictions: dict) -> None:
    print("\nhint quality:")
    for k in ("staged", "used", "wasted", "late", "late_watermark",
              "duplicate", "resident_unused"):
        if k in hq:
            print(f"  {k:<16s} {hq[k]:>8d}")
    print(f"  {'precision':<16s} {hq.get('precision', 0.0):>8.3f}   "
          f"(used / staged+late)")
    print(f"  {'recall':<16s} {hq.get('recall', 0.0):>8.3f}   "
          f"(prefetch hits / all fetches)")
    if "lead_p50" in hq:
        print(f"  lead time p50 {fmt_s(hq['lead_p50'])}  "
              f"p99 {fmt_s(hq['lead_p99'])}  "
              f"min {fmt_s(hq['lead_min'])}  max {fmt_s(hq['lead_max'])}"
              f"   (negative = staged too late)")
    if evictions:
        print("\nevictions (reason.admission):")
        for k in sorted(evictions):
            print(f"  {k:<24s} {evictions[k]:>8d}")


def print_fused(fb: dict) -> None:
    """Fused hot-path rollup (DESIGN.md §14): batch-fill is the one to
    watch — underfilled batches waste launch cost (fences and drain
    stalls fragment them)."""
    if not fb:
        return
    print("\nfused hot path:")
    print(f"  {'batches':<16s} {fb.get('batches', 0):>8d}")
    print(f"  {'lanes':<16s} {fb.get('lanes', 0):>8d}")
    print(f"  {'batch-fill':<16s} {fb.get('fill_ratio', 0.0):>8.3f}   "
          f"(lanes / batches x width)")
    print(f"  {'device hits':<16s} {fb.get('device_hits', 0):>8d}")
    print(f"  {'device misses':<16s} {fb.get('device_misses', 0):>8d}")
    print(f"  {'conflicts':<16s} {fb.get('device_conflicts', 0):>8d}   "
          f"(misses beyond free device slots at adjudication)")


SPARK = "▁▂▃▄▅▆▇█"


def sparkline(vals, lo=None, hi=None) -> str:
    """Unicode block sparkline; bounds default to the series extremes."""
    if not vals:
        return "(no data)"
    lo = min(vals) if lo is None else lo
    hi = max(vals) if hi is None else hi
    span = hi - lo
    if span <= 0:
        return SPARK[0] * len(vals)
    return "".join(
        SPARK[min(len(SPARK) - 1, int((v - lo) / span * len(SPARK)))]
        for v in vals)


def _build_smoke(args):
    from repro_torch.streaming.backend import LOCAL_NVME
    from repro_torch.streaming.nexmark import NexmarkConfig, build_query

    cfg = NexmarkConfig(rate=5_000.0, active_window=1.0, oo_bound=0.3,
                        seed=args.seed)
    kw = dict(cache_entries=256, backend=LOCAL_NVME, parallelism=2,
              source_parallelism=1, io_workers=4, buffer_timeout=0.002,
              hint_ts="deadline", fused=args.fused,
              device=args.device)
    if args.query == "q20":
        return build_query("q20", "tac", "prefetch", cfg, **kw)
    return build_query("q5", "tac", "prefetch", cfg, window_size=1.0,
                       window_slide=0.5, **kw)


def run_report(args) -> int:
    eng = _build_smoke(args)
    eng.enable_tracing(sample_every=args.sample_every)
    if args.export:
        eng.enable_export(args.export, interval=0.5)
    m = eng.run(duration=args.duration, warmup=args.warmup)

    print(f"{args.query} smoke (deadline hints, {args.duration:.0f}s sim, "
          f"1-in-{args.sample_every} tracing):")
    print(f"  outputs {m['n_outputs']}  p50 {fmt_s(m['p50']).strip()}  "
          f"p99 {fmt_s(m['p99']).strip()}  "
          f"hit rate {m.get('stateful_hit_rate', 0.0):.2f}")
    print_stage_table(m.get("trace", {}))
    print_quality(m.get("stateful_hint_quality", {}),
                  m.get("stateful_evictions", {}))
    print_fused(m.get("stateful_fused", {}))
    if args.export:
        print(f"\nregistry snapshots appended to {args.export}")
    return 0


def timeline_report(args) -> int:
    """Per-interval view of the smoke run on the logical clock
    (DESIGN.md §16): precision / recall / watermark-lag / hit-rate
    series with sparklines, plus the detectors' alerts."""
    eng = _build_smoke(args)
    eng.enable_timeline(interval=args.interval)
    m = eng.run(duration=args.duration, warmup=args.warmup)
    tl = eng.timeline
    since, until = args.since, args.until
    ivs = tl.select(since, until)
    b = tl.block()
    print(f"{args.query} smoke timeline ({args.duration:.0f}s sim, "
          f"interval {tl.interval:g}s): {b['intervals']} intervals cut, "
          f"{len(ivs)} in window, {b['evicted']} evicted "
          f"(ring capacity {b['capacity']})")
    print(f"  outputs {m['n_outputs']}  "
          f"hit rate {m.get('stateful_hit_rate', 0.0):.2f}")
    for op in (eng.health.ops if eng.health else []):
        pre = f"engine.{op}"
        prec = tl.ratio_series(f"{pre}.prefetch.used",
                               (f"{pre}.prefetch.staged",
                                f"{pre}.prefetch.late"),
                               min_den=1.0, since=since, until=until)
        rec = tl.ratio_series(f"{pre}.prefetch.hits",
                              (f"{pre}.prefetch.hits",
                               f"{pre}.prefetch.demand_fetches"),
                              min_den=1.0, since=since, until=until)
        hit = tl.ratio_series(f"{pre}.cache.hits",
                              (f"{pre}.cache.hits",
                               f"{pre}.cache.misses"),
                              min_den=1.0, since=since, until=until)
        lag = tl.series(f"{pre}.watermark.lag", since=since, until=until)
        fill = tl.series(f"{pre}.fused.fill_ratio", since=since,
                         until=until)
        print(f"\n  operator {op!r} per-interval series "
              f"([{'start' if since is None else f'{since:g}s'} .. "
              f"{'end' if until is None else f'{until:g}s'}]):")

        def row(label, s, lo=None, hi=None, unit=""):
            if not s:
                print(f"    {label:<14s} (no data in window)")
                return
            vals = [v for _, v in s]
            print(f"    {label:<14s} {sparkline(vals, lo, hi)}  "
                  f"last={vals[-1]:.3f}{unit}  "
                  f"min={min(vals):.3f}  max={max(vals):.3f}")

        row("precision", prec, 0.0, 1.0)
        row("recall", rec, 0.0, 1.0)
        row("hit-rate", hit, 0.0, 1.0)
        row("wm lag", lag, unit="s")
        if args.fused:
            row("fused fill", fill, 0.0, 1.0)
    alerts = [a for a in (eng.health.alerts if eng.health else [])
              if (since is None or a.t >= since)
              and (until is None or a.t <= until)]
    if alerts:
        print(f"\n  alerts ({len(alerts)}):")
        for a in alerts:
            cl = "active" if a.cleared_t is None \
                else f"cleared@{a.cleared_t:.2f}s"
            print(f"    [{a.t:6.2f}s] {a.kind:<10s} op={a.op} "
                  f"value={a.value:.4g} ({cl}) — {a.message}")
    else:
        print("\n  alerts: none (healthy run)")
    if args.export:
        from repro_torch.obs import timeline_jsonl
        n = timeline_jsonl(tl, args.export,
                           alerts=eng.health.alerts if eng.health else None)
        print(f"\n  {n} timeline records appended to {args.export}")
    return 0


def snapshot_report(path: str, grep: str) -> int:
    lines = []
    with open(path) as f:
        for raw in f:
            raw = raw.strip()
            if raw:
                lines.append(json.loads(raw))
    if not lines:
        print(f"{path}: no snapshots")
        return 1
    first, last = lines[0]["metrics"], lines[-1]["metrics"]
    # post-PR-10 exports carry an explicit per-line ``delta`` block;
    # summing it across lines gives the counter's total change over the
    # export window without diffing cumulative snapshots by hand
    have_delta = all("delta" in ln for ln in lines)
    summed: dict = {}
    if have_delta:
        for ln in lines:
            for n, d in ln["delta"].items():
                summed[n] = summed.get(n, 0) + d
    print(f"{path}: {len(lines)} snapshots, "
          f"t={lines[0]['t']}..{lines[-1]['t']}"
          f"{' (interval deltas)' if have_delta else ' (legacy cumulative)'}")
    for name in sorted(last):
        if grep and grep not in name:
            continue
        v = last[name]
        if isinstance(v, dict):        # histogram summary
            print(f"  {name:<44s} count={v.get('count', 0):>7} "
                  f"mean={v.get('mean', 0.0):.6g} "
                  f"p99={v.get('p99', 0.0):.6g}")
        else:
            if have_delta and name in summed:
                d = summed[name]
            elif isinstance(v, (int, float)) \
                    and isinstance(first.get(name), (int, float)):
                d = v - first.get(name, 0)
            else:
                d = None
            delta = f" (+{d:g})" if d else ""
            print(f"  {name:<44s} {v:g}{delta}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--snapshot", metavar="FILE.jsonl",
                    help="report on a registry JSONL export instead of "
                         "running the q5 smoke pipeline")
    ap.add_argument("--grep", default="",
                    help="with --snapshot: only metrics containing this")
    ap.add_argument("--timeline", action="store_true",
                    help="run the smoke pipeline with the temporal plane "
                         "enabled and print per-interval series + alerts")
    ap.add_argument("--since", type=float, default=None,
                    help="with --timeline: drop intervals ending before "
                         "this logical time (s)")
    ap.add_argument("--until", type=float, default=None,
                    help="with --timeline: drop intervals ending after "
                         "this logical time (s)")
    ap.add_argument("--interval", type=float, default=0.1,
                    help="with --timeline: interval width on the "
                         "logical clock (s)")
    ap.add_argument("--query", choices=("q5", "q20"), default="q5",
                    help="smoke pipeline to run (q5 sliding windows or "
                         "q20 stateful filter-join)")
    ap.add_argument("--duration", type=float, default=3.0)
    ap.add_argument("--warmup", type=float, default=1.5)
    ap.add_argument("--sample-every", type=int, default=16)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--fused", action="store_true",
                    help="run the q5 smoke pipeline on the fused device "
                         "hot path and report its batch-fill ratio")
    ap.add_argument("--device", default="cuda",
                    help="where the --fused run's keyed state lives "
                         "(cuda or cpu)")
    ap.add_argument("--export", metavar="FILE.jsonl",
                    help="also append registry snapshots during the run "
                         "(with --timeline: the timeline JSONL instead)")
    args = ap.parse_args()
    if args.snapshot:
        return snapshot_report(args.snapshot, args.grep)
    if args.timeline:
        return timeline_report(args)
    return run_report(args)


if __name__ == "__main__":
    sys.exit(main())
