# Copy of repro/streaming/nexmark.py; differs only in build_query's `device` argument (default "cuda"), passed to the fused stateful op.
"""NEXMark-style workload (paper §VI): Person 2% / Auction 6% / Bid 92%,
hot-auction probability 50%, hot-bidder 75%, auctions/bidders active for a
rolling window, the hottest auction/bidder rotating every second.

Queries (Fig 5): Q13 enrichment join, Q18 top-1 bid per (auction,bidder),
Q19 top-10 bids per auction, Q20 auction-bid incremental join with a
category filter.  All runs are scaled in state size, not in behaviour.

For the sharded-plane benchmark (DESIGN.md §9, benchmarks/sharding.py) the
classic NEXMark Q3 and Q4 are added in simplified stateful form: Q3 joins
sellers' person profiles with their auctions (keyed by seller, emitting
only "local" sellers), Q4 tracks the max bid and category per auction
(keyed by auction).  Both exercise a different key population than the
bid-dominated Q13/Q18-Q20 — person/seller keys churn far more slowly.

The event-time windowed queries q5/q7 (DESIGN.md §10) and the
stream-stream join queries (§11, benchmarks/joins.py) ride the same
generator: q8 joins newly registered persons with the auctions they open
in the same TUMBLING window (co-grouped panes, fired on watermark), and
q20 — when ``cfg.oo_bound > 0`` enables event time — becomes a true
auction⋈bid INTERVAL join with dual per-key buffers, retention-deadline
expiry, and two-sided hints.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np

from repro_torch.streaming.backend import (DISAGGREGATED, LOCAL_NVME, BackendModel,
                                     StateBackend)
from repro_torch.streaming.engine import (Engine, MapOp, SinkOp, SourceOp,
                                    StatefulOp, hash_partition)
from repro_torch.streaming.events import Tuple_

BID, AUCTION, PERSON = "bid", "auction", "person"
SIZES = {BID: 200, AUCTION: 500, PERSON: 200}


@dataclass
class NexmarkConfig:
    rate: float = 50_000.0            # events/s
    active_window: float = 60.0       # auctions/bidders stay active (scaled
    #                                   stand-in for the paper's 2 h)
    hot_auction_prob: float = 0.5
    hot_bidder_prob: float = 0.75
    auctions_per_s: float = None      # derived from rate (6%)
    seed: int = 7
    # bounded out-of-orderness (event-time queries, DESIGN.md §10): event
    # timestamps trail arrival by U(0, oo_bound); a late_prob fraction
    # trails by up to 2x the bound — genuinely LATE under a watermark of
    # (max event ts - oo_bound), exercising the drop/update paths
    oo_bound: float = 0.0
    late_prob: float = 0.02
    watermark_interval: float = 0.05
    # auction-id distribution over the active range (hint-quality
    # ablations, DESIGN.md §13): "nexmark" = the paper's hot-auction
    # process above; "uniform" = no skew; "zipf" = Zipf(~1) rank over the
    # active range (zipf_s > 1 sharpens the skew); "shift" = zipf whose
    # rank->id mapping ROTATES every shift_interval seconds — the
    # adversarial case where yesterday's hot set goes cold at once
    key_dist: str = "nexmark"
    zipf_s: float = 1.0
    shift_interval: float = 5.0

    def __post_init__(self):
        if self.auctions_per_s is None:
            self.auctions_per_s = 0.06 * self.rate
        if self.key_dist not in ("nexmark", "uniform", "zipf", "shift"):
            raise ValueError(f"key_dist {self.key_dist!r}")


class NexmarkGen:
    """Single generator for all event types (paper methodology §VI-c).

    Bid wars: a fraction of bids repeats a recent (auction, bidder) pair —
    the paper notes Q18 "has overall more keys that are frequent at any
    point in time"."""

    def __init__(self, cfg: NexmarkConfig):
        self.cfg = cfg
        # one counter-based numpy Generator per workload: every draw is a
        # pure function of (seed, draw index), so a run replays bit-exactly
        # from its seed — the determinism contract the chaos oracle's
        # golden-vs-perturbed comparison rests on (DESIGN.md §15)
        self.rng = np.random.Generator(np.random.PCG64(cfg.seed))
        self.n = 0
        self.recent_pairs = []
        # bid wars belong to the default workload; the synthetic
        # distributions keep a small repeat fraction so the dedup paths
        # stay exercised without masking the distribution's own shape
        self.repeat_pair_prob = 0.4 if cfg.key_dist == "nexmark" else 0.1

    def active_range(self, now: float, per_s: float) -> Tuple[int, int]:
        hi = max(1, int(now * per_s))
        lo = max(0, int((now - self.cfg.active_window) * per_s))
        return lo, hi

    def _auction_id(self, now: float) -> int:
        lo, hi = self.active_range(now, self.cfg.auctions_per_s)
        dist = self.cfg.key_dist
        if dist == "nexmark":
            if self.rng.random() < self.cfg.hot_auction_prob:
                # most popular auction changes once per second (paper §VI-d)
                return min(hi - 1, int(int(now) * self.cfg.auctions_per_s))
            return int(self.rng.integers(lo, max(lo, hi - 1) + 1))
        if dist == "uniform":
            return int(self.rng.integers(lo, max(lo, hi - 1) + 1))
        # zipf / shift: rank ~ Zipf(1) over the active range via the
        # log-uniform trick (rank = n**u - 1 puts prob ~1/(rank+1) mass
        # on each rank); zipf_s > 1 sharpens the head
        n = max(1, hi - lo)
        u = self.rng.random() ** self.cfg.zipf_s
        rank = min(n - 1, int(n ** u) - 1)
        if dist == "shift":
            # rotate the rank->id mapping each epoch: rank 0 (the hottest
            # id) jumps to a fresh region of the keyspace, so the learned
            # hot set goes cold INSTANTLY at the epoch boundary
            epoch = int(now / self.cfg.shift_interval)
            step = max(1, n // 7)
            rank = (rank + epoch * step) % n
        return lo + rank

    def _bidder_id(self, now: float) -> int:
        per_s = max(0.02 * self.cfg.rate, 1.0)
        lo, hi = self.active_range(now, per_s)
        if self.rng.random() < self.cfg.hot_bidder_prob:
            return min(hi - 1, int(int(now) * per_s))
        return int(self.rng.integers(lo, max(lo, hi - 1) + 1))

    def _event_ts(self, now: float) -> float:
        """Bounded-out-of-orderness event time (only when cfg.oo_bound>0):
        most events trail arrival by U(0, bound), a small fraction by up
        to 2x the bound (late under the watermark)."""
        b = self.cfg.oo_bound
        if self.rng.random() < self.cfg.late_prob:
            delay = b * (1.0 + self.rng.random())
        else:
            delay = b * self.rng.random()
        return max(0.0, now - delay)

    def __call__(self, now: float):
        rec = self._gen(now)
        if rec is not None and self.cfg.oo_bound > 0:
            rec = rec + (self._event_ts(now),)
        return rec

    def _gen(self, now: float):
        self.n += 1
        r = self.rng.random()
        if r < 0.92:
            if self.recent_pairs and self.rng.random() < self.repeat_pair_prob:
                a, b = self.recent_pairs[
                    int(self.rng.integers(len(self.recent_pairs)))]
            else:
                a = self._auction_id(now)
                b = self._bidder_id(now)
                self.recent_pairs.append((a, b))
                if len(self.recent_pairs) > 4096:
                    del self.recent_pairs[:2048]
            price = int(self.rng.integers(1, 10_001))
            return (a, {"type": BID, "auction": a, "bidder": b,
                        "price": price}, SIZES[BID])
        if r < 0.98:
            lo, hi = self.active_range(now, self.cfg.auctions_per_s)
            aid = hi                          # a new auction opens
            cat = 10 if self.rng.random() < 0.25 \
                else int(self.rng.integers(10))
            plo, phi = self.active_range(now, max(0.02 * self.cfg.rate, 1.0))
            seller = int(self.rng.integers(plo, max(plo, phi - 1) + 1))
            return (aid, {"type": AUCTION, "auction": aid, "category": cat,
                          "seller": seller}, SIZES[AUCTION])
        lo, hi = self.active_range(now, max(0.02 * self.cfg.rate, 1.0))
        return (hi, {"type": PERSON, "person": hi,
                     "state": int(self.rng.integers(50))}, SIZES[PERSON])


# --------------------------------------------------------------------- plans
def _mk_engine(marker_interval=0.1) -> Engine:
    return Engine(marker_interval)


def _parser(tup: Tuple_) -> Tuple_:
    return tup                          # JSON parse modelled by service time


def build_query(query: str, policy: str, mode: str, cfg: NexmarkConfig,
                cache_entries: int = 4096,
                backend: BackendModel = LOCAL_NVME,
                parallelism: int = 3, source_parallelism: int = 2,
                io_workers: int = 4,
                cms_conf: Optional[dict] = None,
                n_shards: Optional[int] = None,
                buffer_timeout: Optional[float] = None,
                hint_ts: str = "deadline",
                window_size: Optional[float] = None,
                window_slide: Optional[float] = None,
                allowed_lateness: Optional[float] = None,
                join_hints: str = "two",
                join_horizon: Optional[float] = None,
                replayable: bool = False,
                hint_filter: Optional[dict] = None,
                compress_hints: bool = False,
                fused: bool = False,
                fused_batch: int = 64,
                session_gap: Optional[float] = None,
                device: str = "cuda") -> Engine:
    """policy: lru|clock|tac; mode: sync|async|prefetch.

    With ``n_shards`` the stateful operator runs the sharded state plane
    (DESIGN.md §9): data and hint channels route by shard ownership and
    ``Engine.migrate_shard`` can rebalance mid-run.  ``buffer_timeout``
    overrides the data channels' flush timeout (Flink's low-latency gear,
    e.g. 2 ms, keeps the latency floor from masking state-access effects
    in latency-focused benchmarks).

    The event-time windowed queries q5 (hot items, sliding) and q7
    (highest bid, tumbling) additionally take ``hint_ts`` ("deadline" =
    window-fire deadline hints + burst prefetch, "arrival" = per-tuple
    event-ts hints, the ablation), window geometry overrides, and
    ``allowed_lateness`` (DESIGN.md §10).

    The stream-stream JOIN queries (DESIGN.md §11) — q8 (tumbling-window
    person⋈auction) and q20 with ``cfg.oo_bound > 0`` (event-time
    auction⋈bid interval join; without watermarks q20 keeps its original
    processing-time incremental-join form, the paper-figure baseline) —
    additionally take ``join_hints`` ("two" = both sides emit cross-side
    hints, "one" = probe side only, the ablation) and, for the interval
    join, ``join_horizon`` (how long an auction accepts bids; defaults
    to ``cfg.active_window``).

    q11 (per-bidder activity sessions, DESIGN.md §15) counts bids per
    SESSION window: ``session_gap`` sets the inactivity gap (default
    0.5 s), panes merge on bridging bids, and deadline hints MOVE as
    sessions extend.  ``allowed_lateness`` defaults to ``cfg.oo_bound``
    with the ``update`` late policy (Aion-style re-open).

    ``replayable=True`` puts a durable log in front of the source
    (DESIGN.md §7): the generator runs on a logical clock and records are
    replayable from a checkpointed offset — required for the failure/
    recovery scenarios (``streaming/recovery.py``).

    ``hint_filter`` is a HintFilter config dict applied to every
    lookahead (DESIGN.md §13; e.g. ``{"mode": "selective",
    "speculative": True}``); ``compress_hints`` accounts hint-channel
    bytes under the delta codec.

    ``fused=True`` runs the stateful operator's hot path as one jitted
    device program per batch (DESIGN.md §14).  Only queries whose
    aggregation is declarative — q5 (windowed count = sum of ones) and
    q7 (windowed max bid) — compile; ``fused_batch`` sets the device
    batch width B."""
    if fused and query not in ("q5", "q7"):
        raise ValueError(f"query {query!r} has no fused spec "
                         "(fused mode covers q5/q7, DESIGN.md §14)")
    if query in ("q5", "q7"):
        return _build_windowed_query(
            query, policy, mode, cfg, cache_entries, backend, parallelism,
            source_parallelism, io_workers, cms_conf, n_shards,
            buffer_timeout, hint_ts, window_size, window_slide,
            allowed_lateness, replayable, hint_filter, compress_hints,
            fused, fused_batch, device)
    if query == "q11":
        return _build_session_query(
            query, policy, mode, cfg, cache_entries, backend, parallelism,
            source_parallelism, io_workers, cms_conf, n_shards,
            buffer_timeout, hint_ts, session_gap, allowed_lateness,
            replayable, hint_filter, compress_hints)
    if query == "q8" or (query == "q20" and cfg.oo_bound > 0):
        return _build_join_query(
            query, policy, mode, cfg, cache_entries, backend, parallelism,
            source_parallelism, io_workers, cms_conf, n_shards,
            buffer_timeout, hint_ts, window_size, allowed_lateness,
            join_hints, join_horizon, replayable, hint_filter,
            compress_hints)
    eng = _mk_engine()
    gen = NexmarkGen(cfg)

    if query == "q3":
        # classic NEXMark Q3 (simplified): person profiles keyed by person
        # id; each auction probes its SELLER's profile and joins when the
        # seller is "local" (state < 10, ~20% selectivity)
        want = {AUCTION, PERSON}
        key_field = "seller"                  # auctions rekey to the seller
        state_size = 300

        def apply_fn(tup, state):
            state = dict(state or {})
            p = tup.payload
            if p["type"] == PERSON:
                state["profile"] = p
                return state, []
            prof = state.get("profile")
            if prof is not None and prof["state"] < 10:
                return state, [Tuple_(tup.ts, tup.key, (p, prof), 300,
                                      tup.ingest_t)]
            return state, []
        read_only = False
        default_state = lambda k: {}
    elif query == "q4":
        # classic NEXMark Q4 (simplified): per-auction running max bid +
        # category (the per-category average is a cheap downstream fold;
        # the keyed-state pressure is all here)
        want = {BID, AUCTION}
        key_field = "auction"
        state_size = 240

        def apply_fn(tup, state):
            state = dict(state or {})
            p = tup.payload
            if p["type"] == AUCTION:
                state["category"] = p["category"]
                return state, []
            if p["price"] > state.get("max", 0):
                state["max"] = p["price"]
                cat = state.get("category", 0)
                return state, [Tuple_(tup.ts, tup.key,
                                      (cat, state["max"]), 200,
                                      tup.ingest_t)]
            return state, []
        read_only = False
        default_state = lambda k: {}
    elif query == "q13":
        want = {BID}
        key_field = "auction"
        state_size = 500

        def apply_fn(tup, state):
            out = Tuple_(tup.ts, tup.key, (tup.payload, state), 300,
                         tup.ingest_t)
            return state, [out]
        read_only = True
        default_state = lambda k: {"meta": k}
    elif query == "q18":
        want = {BID}
        key_field = ("auction", "bidder")
        state_size = 200

        def apply_fn(tup, state):
            state = tup.payload           # keep latest bid by time
            return state, [Tuple_(tup.ts, tup.key, state, 200, tup.ingest_t)]
        read_only = False
        default_state = lambda k: None
    elif query == "q19":
        want = {BID}
        key_field = "auction"
        state_size = 2000                 # ~top-10 bids

        def apply_fn(tup, state):
            top = list(state or [])
            top.append(tup.payload["price"])
            top = sorted(top, reverse=True)[:10]
            return top, [Tuple_(tup.ts, tup.key, tuple(top), 240,
                                tup.ingest_t)]
        read_only = False
        default_state = lambda k: []
    elif query == "q20":
        want = {BID, AUCTION}
        key_field = "auction"
        state_size = 700                  # auction record + last bids

        def apply_fn(tup, state):
            # incremental two-sided join: bids are buffered per auction id
            # (for auctions arriving later) AND probe the auction side
            state = dict(state or {})
            if tup.payload["type"] == AUCTION:
                if tup.payload["category"] == 10:
                    state["auction"] = tup.payload
                return state, []
            bids = state.get("bids") or []
            state["bids"] = (bids + [tup.payload["price"]])[-16:]
            if "auction" in state:
                out = Tuple_(tup.ts, tup.key,
                             (tup.payload, state["auction"]), 400,
                             tup.ingest_t)
                return state, [out]
            return state, []
        read_only = False
        default_state = lambda k: {}
    else:
        raise KeyError(query)

    def type_filter(tup: Tuple_):
        if tup.payload["type"] not in want:
            return None
        return tup

    def gen_filtered(now):
        rec = gen(now)
        return rec

    def key_of(tup: Tuple_):
        p = tup.payload
        if p["type"] not in want:
            return None
        if query == "q20" and p["type"] == AUCTION:
            return None                   # auctions are filtered/small side
        if query == "q3" and p["type"] == PERSON:
            return p["person"]            # profile side keys by person id
        if isinstance(key_field, tuple):
            return (p[key_field[0]], p[key_field[1]])
        return p[key_field]

    def rekey(tup: Tuple_):
        k = key_of(tup)
        if k is not None:
            tup.key = k
        return tup

    src = eng.add(SourceOp(eng, "source", source_parallelism, cfg.rate,
                           gen_filtered, replayable=replayable))
    parse = eng.add(MapOp(eng, "parser", parallelism, fn=type_filter,
                          service_time=15e-6, key_of=key_of,
                          cms_conf=cms_conf, filter_conf=hint_filter))
    norm = eng.add(MapOp(eng, "normalize", parallelism, fn=rekey,
                         service_time=10e-6, key_of=key_of,
                         cms_conf=cms_conf, filter_conf=hint_filter))
    plane = None
    if n_shards is not None:
        from repro_torch.streaming.shards import ShardPlane
        plane = ShardPlane(n_shards, parallelism)
    stateful = eng.add(StatefulOp(
        eng, "stateful", parallelism, apply_fn, backend, cache_entries
        * state_size, policy=policy, mode=mode, io_workers=io_workers,
        state_size=state_size, read_only=read_only,
        default_state=default_state, dense_backend=(query == "q13"),
        shards=plane))
    sink = eng.add(SinkOp(eng, "sink", 1))

    from repro_torch.streaming.engine import BUFFER_TIMEOUT
    to = BUFFER_TIMEOUT if buffer_timeout is None else buffer_timeout
    # source -> parse is a STATELESS edge: rebalance round-robin (Flink's
    # default for non-keyed exchanges).  Hash-partitioning here would pin
    # the hot auction's ~50% of events to one parse subtask and cap the
    # whole pipeline at that subtask's service rate
    rr = itertools.count()
    eng.connect(src, parse, partition=lambda k, n: next(rr) % n, timeout=to)
    eng.connect(parse, norm, timeout=to)
    eng.connect(norm, stateful,
                partition=plane.route_data if plane else hash_partition,
                timeout=to)
    eng.connect(stateful, sink, partition=lambda k, n: 0, timeout=to)
    if mode == "prefetch":
        eng.register_prefetching(stateful, [parse, norm],
                                 compress_hints=compress_hints)
    return eng


def _build_windowed_query(query, policy, mode, cfg, cache_entries, backend,
                          parallelism, source_parallelism, io_workers,
                          cms_conf, n_shards, buffer_timeout, hint_ts,
                          window_size, window_slide, allowed_lateness,
                          replayable=False, hint_filter=None,
                          compress_hints=False, fused=False,
                          fused_batch=64, device="cuda"):
    """Event-time windowed NEXMark queries (DESIGN.md §10).

    q5 (hot items, simplified): bid count per auction per SLIDING window,
    late tuples re-aggregate and re-emit (late-side update); the global
    argmax is a cheap downstream fold.  q7 (highest bid, simplified): max
    bid per auction per TUMBLING window, late tuples dropped.  Both key
    panes by ``WindowKey(auction, wid)`` and fire on watermark advance.
    """
    import itertools as _it

    from repro_torch.streaming.windows import (WindowAssigner, WindowedLookaheadOp,
                                         WindowedStatefulOp)

    if cfg.oo_bound <= 0:
        raise ValueError("windowed queries need cfg.oo_bound > 0 "
                         "(event-time watermarks)")

    if query == "q5":
        size = 2.0 if window_size is None else window_size
        slide = size / 2 if window_slide is None else window_slide
        lateness = (slide if allowed_lateness is None
                    else allowed_lateness)
        late_policy = "update"
        state_size = 96                   # a counter + pane metadata

        def agg_fn(tup, acc):
            return (acc or 0) + 1

        def emit_fn(key, wid, end, acc):
            return ("count", key, acc) if acc else None
    else:                                 # q7
        size = 2.0 if window_size is None else window_size
        slide = size if window_slide is None else window_slide
        lateness = 0.0 if allowed_lateness is None else allowed_lateness
        late_policy = "drop" if lateness == 0 else "update"
        state_size = 96

        def agg_fn(tup, acc):
            price = tup.payload["price"]
            return price if acc is None or price > acc else acc

        def emit_fn(key, wid, end, acc):
            return ("maxbid", key, acc) if acc is not None else None

    fused_kw = {}
    if fused:
        # declarative device forms of the aggregations above (§14): the
        # pane accumulator is an int in both queries, exact in f32 for
        # counts < 2^24 and prices <= 10_000
        from repro_torch.streaming.fused import FusedSpec
        if query == "q5":
            spec = FusedSpec(
                kind="sum", width=1,
                weight_of=lambda tup: 1.0,
                encode=lambda s: None if s is None else [float(s)],
                decode=lambda v: int(round(float(v[0]))))
        else:                             # q7: running max bid
            spec = FusedSpec(
                kind="max", width=1,
                weight_of=lambda tup: float(tup.payload["price"]),
                encode=lambda s: None if s is None else [float(s)],
                decode=lambda v: int(round(float(v[0]))))
        fused_kw = dict(fused=spec, fused_batch=fused_batch,
                        device=device)

    assigner = WindowAssigner(size, slide)
    eng = _mk_engine()
    gen = NexmarkGen(cfg)

    def bid_filter(tup: Tuple_):
        return tup if tup.payload["type"] == BID else None

    def key_of(tup: Tuple_):
        p = tup.payload
        return p["auction"] if p["type"] == BID else None

    def rekey(tup: Tuple_):
        tup.key = tup.payload["auction"]
        return tup

    src = eng.add(SourceOp(eng, "source", source_parallelism, cfg.rate,
                           gen, watermark_interval=cfg.watermark_interval,
                           oo_bound=cfg.oo_bound, replayable=replayable))
    parse = eng.add(MapOp(eng, "parser", parallelism, fn=bid_filter,
                          service_time=15e-6))
    winla = eng.add(WindowedLookaheadOp(
        eng, "win_lookahead", parallelism, assigner, key_of, fn=rekey,
        hint_ts_mode=hint_ts, burst_ahead=2 * cfg.watermark_interval,
        allowed_lateness=lateness, service_time=10e-6, cms_conf=cms_conf,
        filter_conf=hint_filter))
    plane = None
    if n_shards is not None:
        from repro_torch.streaming.shards import ShardPlane
        plane = ShardPlane(n_shards, parallelism)
    stateful = eng.add(WindowedStatefulOp(
        eng, "stateful", parallelism, assigner, agg_fn, emit_fn, backend,
        cache_entries * state_size, allowed_lateness=lateness,
        late_policy=late_policy, policy=policy, mode=mode,
        io_workers=io_workers, state_size=state_size,
        # arrival-ts hints are accurate in KEY, only mistimed: disable the
        # per-origin mismatch discard so the ablation stays on (§10); the
        # deadline-aware eviction order belongs to deadline hints only —
        # arrival timestamps are recency, and ranking them as deadlines
        # would evict the hottest keys first
        miss_threshold=1.01, deadline_aware=(hint_ts == "deadline"),
        shards=plane, **fused_kw))
    sink = eng.add(SinkOp(eng, "sink", 1))

    from repro_torch.streaming.engine import BUFFER_TIMEOUT
    to = BUFFER_TIMEOUT if buffer_timeout is None else buffer_timeout
    rr = _it.count()
    eng.connect(src, parse, partition=lambda k, n: next(rr) % n, timeout=to)
    rr2 = _it.count()
    eng.connect(parse, winla, partition=lambda k, n: next(rr2) % n,
                timeout=to)
    eng.connect(winla, stateful,
                partition=plane.route_data if plane else hash_partition,
                timeout=to)
    eng.connect(stateful, sink, partition=lambda k, n: 0, timeout=to)
    if mode == "prefetch":
        eng.register_prefetching(stateful, [winla],
                                 compress_hints=compress_hints)
    return eng


def _build_session_query(query, policy, mode, cfg, cache_entries, backend,
                         parallelism, source_parallelism, io_workers,
                         cms_conf, n_shards, buffer_timeout, hint_ts,
                         session_gap, allowed_lateness, replayable=False,
                         hint_filter=None, compress_hints=False):
    """NEXMark q11 (simplified): per-BIDDER activity sessions — bid count
    per session, a session closing after ``session_gap`` of inactivity
    (DESIGN.md §15).

    The only window type whose fire deadline is data-driven: every bid
    extends its session's end and a bridging bid MERGES two sessions, so
    the lookahead re-hints moving deadlines and the TAC renews resident
    panes in place.  The parser rekeys bids to the bidder BEFORE the
    keyed exchange into the lookahead, so the lookahead and the stateful
    operator partition by the same key and see each bidder's bids in one
    FIFO order — the lockstep their mirrored session registries need.
    """
    import itertools as _it

    from repro_torch.streaming.sessions import (SessionLookaheadOp,
                                          SessionWindowAssigner,
                                          SessionWindowedOp)

    if cfg.oo_bound <= 0:
        raise ValueError("session query needs cfg.oo_bound > 0 "
                         "(event-time watermarks drive session firing)")
    gap = 0.5 if session_gap is None else float(session_gap)
    lateness = cfg.oo_bound if allowed_lateness is None \
        else float(allowed_lateness)
    late_policy = "update" if lateness > 0 else "drop"
    state_size = 96                       # a counter + pane metadata

    assigner = SessionWindowAssigner(gap)
    eng = _mk_engine()
    gen = NexmarkGen(cfg)

    def bid_rekey(tup: Tuple_):
        p = tup.payload
        if p["type"] != BID:
            return None
        tup.key = p["bidder"]
        return tup

    def key_of(tup: Tuple_):
        p = tup.payload
        return p["bidder"] if p["type"] == BID else None

    def agg_fn(tup, acc):
        return (acc or 0) + 1

    def merge_fn(a, b):
        return (a or 0) + (b or 0)

    def emit_fn(key, wid, end, acc):
        # the session id (canonical: derived from the session's earliest
        # bid) rides along so downstream — and the chaos oracle — can
        # identify WHICH session a count belongs to
        return ("session", key, wid, acc) if acc else None

    src = eng.add(SourceOp(eng, "source", source_parallelism, cfg.rate,
                           gen, watermark_interval=cfg.watermark_interval,
                           oo_bound=cfg.oo_bound, replayable=replayable))
    parse = eng.add(MapOp(eng, "parser", parallelism, fn=bid_rekey,
                          service_time=15e-6))
    sessla = eng.add(SessionLookaheadOp(
        eng, "sess_lookahead", parallelism, assigner, key_of,
        hint_ts_mode=hint_ts, burst_ahead=2 * cfg.watermark_interval,
        allowed_lateness=lateness, service_time=10e-6, cms_conf=cms_conf,
        filter_conf=hint_filter))
    plane = None
    if n_shards is not None:
        from repro_torch.streaming.shards import ShardPlane
        plane = ShardPlane(n_shards, parallelism)
    stateful = eng.add(SessionWindowedOp(
        eng, "stateful", parallelism, assigner, agg_fn, emit_fn, backend,
        cache_entries * state_size, merge_fn=merge_fn,
        allowed_lateness=lateness, late_policy=late_policy, policy=policy,
        mode=mode, io_workers=io_workers, state_size=state_size,
        miss_threshold=1.01, deadline_aware=(hint_ts == "deadline"),
        shards=plane))
    sink = eng.add(SinkOp(eng, "sink", 1))

    from repro_torch.streaming.engine import BUFFER_TIMEOUT
    to = BUFFER_TIMEOUT if buffer_timeout is None else buffer_timeout
    rr = _it.count()
    eng.connect(src, parse, partition=lambda k, n: next(rr) % n, timeout=to)
    # parse -> lookahead is KEYED (unlike the fixed-window plans): the
    # session registry is per key, so the lookahead must see each
    # bidder's full, ordered bid stream
    eng.connect(parse, sessla, timeout=to)
    eng.connect(sessla, stateful,
                partition=plane.route_data if plane else hash_partition,
                timeout=to)
    eng.connect(stateful, sink, partition=lambda k, n: 0, timeout=to)
    if mode == "prefetch":
        eng.register_prefetching(stateful, [sessla],
                                 compress_hints=compress_hints)
    return eng


def _build_join_query(query, policy, mode, cfg, cache_entries, backend,
                      parallelism, source_parallelism, io_workers,
                      cms_conf, n_shards, buffer_timeout, hint_ts,
                      window_size, allowed_lateness, join_hints,
                      join_horizon, replayable=False, hint_filter=None,
                      compress_hints=False):
    """Stream-stream join queries with two-sided keyed prefetching
    (DESIGN.md §11).

    q8 (simplified classic NEXMark): persons who registered AND opened an
    auction in the same TUMBLING window — a co-grouped windowed join
    keyed by person/seller id (``WindowedJoinOp``), firing on watermark.
    Left side = person registrations, right side = that seller's
    auctions; hints carry the pane's window-fire deadline.

    q20 (event-time form): each bid enriched with its auction record
    when the auction is in category 10 — an INTERVAL join keyed by
    auction id (``IntervalJoinOp``) with bounds ``[0, join_horizon]``
    (a bid matches an auction opened up to ``join_horizon`` earlier).
    Auction entries retain until their interval end, bids only across
    the out-of-orderness slack, and expired keys purge on watermark
    advance.  Hints carry RETENTION deadlines: an auction hint protects
    the key's dual buffers for the auction's whole matchable life.

    ``join_hints``: "two" = both sides emit cross-side hints, "one" =
    probe side only (auctions for q8, bids for q20 — the one-sided
    ablation the joins benchmark measures against).
    """
    import itertools as _it

    from repro_torch.streaming.joins import (LEFT, RIGHT, IntervalJoinOp,
                                       JoinLookaheadOp, WindowedJoinOp)
    from repro_torch.streaming.windows import WindowAssigner

    if cfg.oo_bound <= 0:
        raise ValueError("join queries need cfg.oo_bound > 0 "
                         "(event-time watermarks drive retention/firing)")
    if join_hints not in ("one", "two"):
        raise ValueError(f"join_hints {join_hints!r}")

    eng = _mk_engine()
    gen = NexmarkGen(cfg)
    lateness = 0.0 if allowed_lateness is None else float(allowed_lateness)

    if query == "q8":
        want = {PERSON, AUCTION}
        size = 2.0 if window_size is None else window_size
        assigner = WindowAssigner(size)
        state_size = 160                  # person record + auction id list

        def side_of(p):
            return LEFT if p["type"] == PERSON else RIGHT

        def key_of(tup: Tuple_):
            p = tup.payload
            if p["type"] == PERSON:
                return p["person"]
            if p["type"] == AUCTION:
                return p["seller"]
            return None

        def join_fn(key, persons, auctions):
            # person registered and opened >= 1 auction in this window
            return ("active_seller", key, len(auctions))
        # the probe side (one-sided ablation) is the auction stream: it
        # dominates the keyed traffic and names the seller directly
        hint_sides = (LEFT, RIGHT) if join_hints == "two" else (RIGHT,)
    elif query == "q20":
        want = {AUCTION, BID}
        horizon = cfg.active_window if join_horizon is None \
            else float(join_horizon)
        bounds = (0.0, horizon)           # bid.ts - auction.ts in [0, hor]
        state_size = 700                  # auction record + live bid tail

        def side_of(p):
            return LEFT if p["type"] == AUCTION else RIGHT

        def key_of(tup: Tuple_):
            p = tup.payload
            return p["auction"] if p["type"] in want else None

        def join_fn(key, auction, bid):
            # the category filter must also guard the PROBE path: an
            # out-of-order non-cat-10 auction arriving after its bids
            # would otherwise enrich the buffered bids keep_fn kept
            return (bid, auction) if auction["category"] == 10 else None

        def keep_fn(side, p):
            # the category filter runs before the buffer on the build
            # side (Flink's q20 plan); bids buffer within retention so a
            # late/out-of-order auction still finds its early bids
            return side == RIGHT or p["category"] == 10
        hint_sides = (LEFT, RIGHT) if join_hints == "two" else (RIGHT,)
    else:
        raise KeyError(query)

    def type_filter(tup: Tuple_):
        return tup if tup.payload["type"] in want else None

    def rekey(tup: Tuple_):
        k = key_of(tup)
        if k is not None:
            tup.key = k
        return tup

    src = eng.add(SourceOp(eng, "source", source_parallelism, cfg.rate,
                           gen, watermark_interval=cfg.watermark_interval,
                           oo_bound=cfg.oo_bound, replayable=replayable))
    parse = eng.add(MapOp(eng, "parser", parallelism, fn=type_filter,
                          service_time=15e-6))
    la_kw = dict(fn=rekey, hint_sides=hint_sides, hint_ts_mode=hint_ts,
                 allowed_lateness=lateness, service_time=10e-6,
                 cms_conf=cms_conf, filter_conf=hint_filter)
    if query == "q8":
        lookahead = eng.add(JoinLookaheadOp(
            eng, "join_lookahead", parallelism, side_of, key_of,
            assigner=assigner, burst_ahead=2 * cfg.watermark_interval,
            **la_kw))
    else:
        # build-side hints protect across the out-of-orderness slack in
        # which the first probe arrives (JoinLookaheadOp docstring)
        lookahead = eng.add(JoinLookaheadOp(
            eng, "join_lookahead", parallelism, side_of, key_of,
            bounds=bounds, probe_ahead=cfg.oo_bound, **la_kw))
    plane = None
    if n_shards is not None:
        from repro_torch.streaming.shards import ShardPlane
        plane = ShardPlane(n_shards, parallelism)
    # the single lookahead must stay active to be a fair ablation, so
    # the per-origin mismatch discard is off (miss_threshold > 1, as the
    # windowed queries do, §10); q8 panes carry fire deadlines and use
    # deadline-aware eviction, while interval retention deadlines are
    # LAST-access bounds — min-ts protection is the right reading there
    # (Belady applies only when the deadline IS the next access, §11)
    if query == "q8":
        join = eng.add(WindowedJoinOp(
            eng, "join", parallelism, assigner, side_of, join_fn, backend,
            cache_entries * state_size, allowed_lateness=lateness,
            late_policy="drop" if lateness == 0 else "update",
            policy=policy, mode=mode, io_workers=io_workers,
            state_size=state_size, miss_threshold=1.01,
            deadline_aware=(hint_ts == "deadline"), shards=plane))
    else:
        join = eng.add(IntervalJoinOp(
            eng, "join", parallelism, side_of, join_fn, bounds, backend,
            cache_entries * state_size, allowed_lateness=lateness,
            keep_fn=keep_fn, out_size=400, policy=policy, mode=mode,
            io_workers=io_workers, state_size=state_size,
            miss_threshold=1.01, shards=plane))
    sink = eng.add(SinkOp(eng, "sink", 1))

    from repro_torch.streaming.engine import BUFFER_TIMEOUT
    to = BUFFER_TIMEOUT if buffer_timeout is None else buffer_timeout
    rr = _it.count()
    eng.connect(src, parse, partition=lambda k, n: next(rr) % n, timeout=to)
    rr2 = _it.count()
    eng.connect(parse, lookahead, partition=lambda k, n: next(rr2) % n,
                timeout=to)
    eng.connect(lookahead, join,
                partition=plane.route_data if plane else hash_partition,
                timeout=to)
    eng.connect(join, sink, partition=lambda k, n: 0, timeout=to)
    if mode == "prefetch":
        eng.register_prefetching(join, [lookahead],
                                 compress_hints=compress_hints)
    return eng
