# Copy of repro/streaming/ysb.py; differs only in build_ysb's `device` argument (default "cuda"), passed to the fused stateful op.
"""Yahoo Streaming Benchmark (paper §VI): ad-analytics enrichment against a
DISAGGREGATED key-value store (the paper uses remote Redis).  Events are
114 B; ad ids follow Zipf(alpha=1); the join key is ad_id -> campaign."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.streaming.backend import DISAGGREGATED
from repro_torch.streaming.engine import (Engine, MapOp, SinkOp, SourceOp,
                                    StatefulOp)
from repro_torch.streaming.events import Tuple_


@dataclass
class YSBConfig:
    rate: float = 50_000.0
    n_ads: int = 100_000
    zipf_alpha: float = 1.0
    seed: int = 11


class YSBGen:
    def __init__(self, cfg: YSBConfig):
        self.cfg = cfg
        # counter-based generator: replays bit-exactly from the seed
        # (chaos-oracle determinism contract, DESIGN.md §15)
        self.rng = np.random.Generator(np.random.PCG64(cfg.seed))
        # Zipf(alpha=1) over n_ads via inverse-CDF table
        ranks = np.arange(1, cfg.n_ads + 1, dtype=np.float64)
        w = 1.0 / ranks ** cfg.zipf_alpha
        self.cdf = np.cumsum(w) / w.sum()

    def __call__(self, now: float):
        u = self.rng.random()
        ad = int(np.searchsorted(self.cdf, u))
        etype = self.rng.random()
        return (ad, {"ad": ad, "etype": "view" if etype < 0.33 else "other"},
                114)


def build_ysb(policy: str, mode: str, cfg: YSBConfig,
              cache_entries: int = 4096, parallelism: int = 3,
              source_parallelism: int = 2, io_workers: int = 8,
              cms_conf=None, replayable: bool = False,
              fused: bool = False, fused_batch: int = 64,
              device: str = "cuda") -> Engine:
    """``replayable=True`` runs the source against a durable log so the
    failure/recovery scenarios (DESIGN.md §7) can rewind and replay it.

    ``fused=True`` runs the enrichment join's hot path on the device
    plane (DESIGN.md §14): the campaign record is a 1-wide read-only row
    and each batch probes + gathers + emits in one jitted program."""
    eng = Engine()
    gen = YSBGen(cfg)
    state_size = 64                        # campaign metadata

    def key_of(tup: Tuple_):
        return tup.payload["ad"]

    def vfilter(tup: Tuple_):
        return tup if tup.payload["etype"] == "view" else None

    def project(tup: Tuple_):
        return tup

    def apply_fn(tup, state):
        return state, [Tuple_(tup.ts, tup.key, (tup.payload, state), 130,
                              tup.ingest_t)]

    fused_kw = {}
    if fused:
        from repro_torch.streaming.fused import FusedSpec
        spec = FusedSpec(
            kind="read", width=1,
            encode=lambda s: [float(s["campaign"])],
            decode=lambda v: {"campaign": int(round(float(v[0])))},
            emit_of=lambda tup, state: [
                Tuple_(tup.ts, tup.key, (tup.payload, state), 130,
                       tup.ingest_t)])
        fused_kw = dict(fused=spec, fused_batch=fused_batch,
                        device=device)

    src = eng.add(SourceOp(eng, "source", source_parallelism, cfg.rate, gen,
                           replayable=replayable))
    parse = eng.add(MapOp(eng, "parser", parallelism, fn=vfilter,
                          service_time=20e-6, key_of=key_of,
                          cms_conf=cms_conf))
    proj = eng.add(MapOp(eng, "project", parallelism, fn=project,
                         service_time=8e-6, key_of=key_of,
                         cms_conf=cms_conf))
    join = eng.add(StatefulOp(
        eng, "stateful", parallelism, apply_fn, DISAGGREGATED,
        cache_entries * state_size, policy=policy, mode=mode,
        io_workers=io_workers, state_size=state_size, read_only=True,
        default_state=lambda k: {"campaign": k % 1000},
        dense_backend=True, **fused_kw))
    sink = eng.add(SinkOp(eng, "sink", 1))
    eng.connect(src, parse)
    eng.connect(parse, proj)
    eng.connect(proj, join)
    eng.connect(join, sink, partition=lambda k, n: 0)
    if mode == "prefetch":
        eng.register_prefetching(join, [parse, proj])
    return eng
