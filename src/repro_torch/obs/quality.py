"""Prefetch-quality telemetry: per-hint outcomes and lead times
(DESIGN.md §12 — the headline of the observability plane).

The paper's claim is that prefetching must be *timely* and *accurate*;
this module measures both directly instead of inferring them from p99.
Every hint that reaches a stateful operator ends in exactly one outcome:

  * ``duplicate`` — the key was already resident (the hint only renewed
    its timestamp); counted by the PrefetchingManager.
  * ``late`` (watermark) — the hint's access time fell behind the
    lateness horizon; no fetch was scheduled (``hints_late``).
  * ``late`` (staging) — a fetch was scheduled but a tuple parked on the
    key before staging completed: the prefetch was issued, just not in
    time.  Lead time is recorded NEGATIVE (first need minus
    stage-complete).
  * ``used`` — staged ahead of need and later read by a tuple.  Lead
    time is positive: first access minus stage-complete.
  * ``wasted`` — staged, never read, evicted (the TAC's
    ``prefetch_unused_evicted`` path, now with lead/registry accounting).
  * still-resident — staged, not yet read, still cached at snapshot time
    (derived: ``staged - used - wasted``).
  * ``suppressed`` — the lookahead's HintFilter (DESIGN.md §13) dropped
    the hint at the source; it never reached the channel.  Resolved
    retroactively by the NEXT access to the key at the stateful operator:
    a hit within the horizon = ``suppress_resident`` (correct — the key
    was cached, the hint would have been a duplicate), a miss within the
    horizon = ``suppress_miss`` (incorrect — the suppression cost a
    demand fetch), no access within ``suppress_horizon`` =
    ``suppress_unused`` (correct — the hint would have been wasted
    anyway).  Invariant: ``suppressed == suppress_resident +
    suppress_miss + suppress_unused + suppress_pending``.

From these, ``quality_block`` derives the two headline ratios every
benchmark now reports next to p99:

  * **precision** = used / (staged + late-staging) — what fraction of
    staging I/O moved bytes a tuple actually read;
  * **recall**    = prefetch_hits / (prefetch_hits + demand_fetches) —
    what fraction of would-be misses the hint plane covered in time.

One recorder serves all subtasks of a stateful operator (counters
aggregate, like the shared adaptation statistics of the
PrefetchingManager).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

from repro_torch.obs.registry import MetricsRegistry


class PrefetchRecorder:
    """Bridges the TAC (staged/used/wasted) and the engine I/O layer
    (late stagings, staging latency, hint-channel delay) into the
    registry.  ``now_fn`` supplies the processing-time clock (the sim
    clock on the streaming engine) — lead times are processing-time
    quantities even when the cache orders by event time."""

    def __init__(self, registry: MetricsRegistry, prefix: str,
                 now_fn: Callable[[], float],
                 suppress_horizon: float = 1.0):
        self.now = now_fn
        self.staged = registry.counter(f"{prefix}.prefetch.staged")
        self.used = registry.counter(f"{prefix}.prefetch.used")
        self.wasted = registry.counter(f"{prefix}.prefetch.wasted")
        self.late = registry.counter(f"{prefix}.prefetch.late")
        self.lead = registry.histogram(f"{prefix}.prefetch.lead")
        self.stage_latency = registry.histogram(
            f"{prefix}.prefetch.stage_latency")
        self.channel_delay = registry.histogram(
            f"{prefix}.hints.channel_delay")
        # suppression plane (DESIGN.md §13): HintFilter verdicts graded
        # against what the stateful operator actually did next
        self.suppressed = registry.counter(f"{prefix}.prefetch.suppressed")
        self.suppress_resident = registry.counter(
            f"{prefix}.prefetch.suppress_resident")
        self.suppress_miss = registry.counter(
            f"{prefix}.prefetch.suppress_miss")
        self.suppress_unused = registry.counter(
            f"{prefix}.prefetch.suppress_unused")
        self.suppress_horizon = suppress_horizon
        # key -> [first suppression time, suppression count]; the access
        # path checks truthiness of this dict before paying a lookup
        self.pending_suppressed: Dict[Any, list] = {}
        self._since_expire = 0

    # ---- TAC-side hooks (core/tac.py calls these when a recorder is set)
    def on_staged(self) -> None:
        """A hint-triggered fetch completed and its entry was admitted
        with no tuple waiting: timely staging."""
        self.staged.inc()

    def on_used(self, stage_t: float) -> None:
        """First read of a staged-and-unused entry: positive lead =
        first-access time minus stage-complete time."""
        self.used.inc()
        self.lead.observe(self.now() - stage_t)

    def on_wasted(self) -> None:
        """A staged entry was evicted without ever being read."""
        self.wasted.inc()

    # ---- engine-side hooks (StatefulOp I/O completion path)
    def on_late(self, first_need_t: float) -> None:
        """Staging completed with a tuple already parked on the key:
        negative lead = first-need time minus stage-complete time."""
        self.late.inc()
        self.lead.observe(first_need_t - self.now())

    def on_stage_latency(self, lat: float) -> None:
        self.stage_latency.observe(lat)

    def on_channel_delay(self, delay: float) -> None:
        self.channel_delay.observe(delay)

    # ---- suppression hooks (lookahead HintFilter + StatefulOp access path)
    def on_suppressed(self, key: Any) -> None:
        """The lookahead suppressed a hint for ``key``.  Repeated
        suppressions of one key fold into a single pending entry (they
        all share the outcome of the next access)."""
        self.suppressed.inc()
        now = self.now()
        ent = self.pending_suppressed.get(key)
        if ent is None:
            self.pending_suppressed[key] = [now, 1]
        else:
            ent[1] += 1
        self._since_expire += 1
        if self._since_expire >= 1024:
            self._since_expire = 0
            self._expire(now)

    def on_access(self, key: Any, hit: bool) -> None:
        """The stateful operator accessed ``key``: grade any pending
        suppression.  A hit means the key really was resident (correct
        suppression); a miss means the suppressed hint would have
        prefetched it (incorrect).  An access arriving beyond the
        horizon is unrelated to the suppression — graded unused."""
        ent = self.pending_suppressed.pop(key, None)
        if ent is None:
            return
        first_t, n = ent
        if self.now() - first_t > self.suppress_horizon:
            self.suppress_unused.inc(n)
        elif hit:
            self.suppress_resident.inc(n)
        else:
            self.suppress_miss.inc(n)

    def _expire(self, now: float) -> None:
        """Grade pending suppressions older than the horizon as unused
        (the key was never accessed again — the hint would have been a
        wasted staging)."""
        horizon = self.suppress_horizon
        stale = [k for k, (t, _n) in self.pending_suppressed.items()
                 if now - t > horizon]
        for k in stale:
            self.suppress_unused.inc(self.pending_suppressed.pop(k)[1])

    def flush_pending(self) -> None:
        """End-of-run: grade everything still pending as unused so the
        invariant closes (benchmarks call this before the final
        snapshot; mid-run snapshots report ``suppress_pending``)."""
        for k in list(self.pending_suppressed):
            self.suppress_unused.inc(self.pending_suppressed.pop(k)[1])

    # ------------------------------------------------------------ rollup
    def quality_block(self, prefetch_hits: int, demand_fetches: int,
                      duplicates: int, late_wm: int) -> Dict[str, Any]:
        """The per-operator hint-quality block surfaced by
        ``Engine.metrics`` and every ``BENCH_*.json``."""
        staged = self.staged.value
        used = self.used.value
        wasted = self.wasted.value
        late = self.late.value
        issued = staged + late
        suppressed = self.suppressed.value
        resolved = (self.suppress_resident.value + self.suppress_miss.value
                    + self.suppress_unused.value)
        sk = self.lead.sketch
        out = {
            "staged": staged,
            "used": used,
            "wasted": wasted,
            "late": late,
            "late_watermark": late_wm,
            "duplicate": duplicates,
            "resident_unused": max(0, staged - used - wasted),
            "suppressed": suppressed,
            "suppress_resident": self.suppress_resident.value,
            "suppress_miss": self.suppress_miss.value,
            "suppress_unused": self.suppress_unused.value,
            "suppress_pending": suppressed - resolved,
            "precision": used / issued if issued else 0.0,
            "recall": prefetch_hits / (prefetch_hits + demand_fetches)
            if (prefetch_hits + demand_fetches) else 0.0,
        }
        if sk.count:
            out.update({"lead_p50": sk.quantile(0.50),
                        "lead_p99": sk.quantile(0.99),
                        "lead_min": sk.vmin, "lead_max": sk.vmax,
                        "lead_mean": sk.mean})
        return out
