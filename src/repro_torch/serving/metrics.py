"""Serving-side metrics: TTFT/TPOT percentiles and staging accounting.

TTFT is measured from ENQUEUE (the moment the session key becomes known to
the lookahead/ingest stage) to the first emitted token, so it includes queue
wait plus any state-staging latency left on the critical path; TPOT is the
gap between consecutive tokens of one request.  Staging overlap is tracked
by the TieredStore (hidden vs critical-path latency) and folded into
``summary``.

Samples feed the unified metrics registry (DESIGN.md §12): attach one via
``bind_registry`` and every TTFT/TPOT observation also lands in the
``serving.ttft`` / ``serving.tpot`` streaming sketches, alongside the
``serving.requests`` / ``serving.tokens`` counters.  The raw sample lists
stay — short serving runs want exact percentiles and tests assert on them.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs import NULL_COUNTER, NULL_HISTOGRAM


def percentiles(samples: List[float], qs=(50, 90, 99)) -> Dict[str, float]:
    if not samples:
        return {f"p{q}": 0.0 for q in qs}
    arr = np.asarray(samples, np.float64)
    return {f"p{q}": float(np.percentile(arr, q)) for q in qs}


class ServingMetrics:
    def __init__(self, registry=None):
        self.enqueue_t: Dict[int, float] = {}
        self.last_token_t: Dict[int, float] = {}
        self.ttft: List[float] = []
        self.tpot: List[float] = []
        self.done_t: List[float] = []
        self.t_start: Optional[float] = None
        self.t_end: float = 0.0
        self.n_requests = 0
        self.n_tokens = 0
        self._h_ttft = self._h_tpot = NULL_HISTOGRAM
        self._c_req = self._c_tok = NULL_COUNTER
        if registry is not None:
            self.bind_registry(registry)

    def bind_registry(self, registry) -> None:
        """Publish into a MetricsRegistry (DESIGN.md §12) on top of the
        local sample lists."""
        self._h_ttft = registry.histogram("serving.ttft")
        self._h_tpot = registry.histogram("serving.tpot")
        self._c_req = registry.counter("serving.requests")
        self._c_tok = registry.counter("serving.tokens")

    def record_enqueue(self, rid: int, now: float) -> None:
        self.enqueue_t[rid] = now
        self.n_requests += 1
        self._c_req.inc()
        if self.t_start is None:
            self.t_start = now

    def record_token(self, rid: int, now: float) -> None:
        self.n_tokens += 1
        self._c_tok.inc()
        self.t_end = max(self.t_end, now)
        prev = self.last_token_t.get(rid)
        if prev is None:                        # first token of the request
            self.ttft.append(now - self.enqueue_t[rid])
            self._h_ttft.observe(now - self.enqueue_t[rid])
        else:
            self.tpot.append(now - prev)
            self._h_tpot.observe(now - prev)
        self.last_token_t[rid] = now

    def record_done(self, rid: int, now: float) -> None:
        self.done_t.append(now)
        self.t_end = max(self.t_end, now)

    def summary(self, arena=None, store=None) -> Dict[str, float]:
        out: Dict[str, float] = {"n_requests": self.n_requests,
                                 "n_tokens": self.n_tokens}
        for name, v in percentiles(self.ttft).items():
            out[f"ttft_{name}"] = v
        out["ttft_mean"] = float(np.mean(self.ttft)) if self.ttft else 0.0
        for name, v in percentiles(self.tpot).items():
            out[f"tpot_{name}"] = v
        span = (self.t_end - self.t_start) if self.t_start is not None \
            else 0.0
        out["duration"] = span
        out["throughput_tok_s"] = self.n_tokens / span if span > 0 else 0.0
        if arena is not None:
            out.update(arena.stats())
        if store is not None:
            out.update(store.stats())
        return out
