"""Synthetic query for the dynamic-lookahead experiment (paper Fig 10).

source -> udf0 -> udf1 -> udf2 -> static join (controllable access latency).
All three UDFs are candidate lookaheads.  At ``t_mismatch`` udf1 starts
remapping the state-access key (hints from udf0 become wrong -> mismatch
switch); at ``t_latency_drop`` the backend gets faster (timing switch to the
latest candidate with sufficient slack).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.streaming.backend import BackendModel, StateBackend
from repro_torch.streaming.engine import (Engine, MapOp, SinkOp, SourceOp,
                                    StatefulOp)
from repro_torch.streaming.events import Tuple_

SLOW = BackendModel("remote-slow", 3e-3, 1.0e9, parallelism=32)
FAST = BackendModel("remote-fast", 0.4e-3, 1.2e9, parallelism=32)


@dataclass
class SyntheticConfig:
    rate: float = 15_000.0
    n_keys: int = 20_000
    t_mismatch: float = 10.0
    t_latency_drop: float = 20.0
    seed: int = 3
    # bounded out-of-orderness (DESIGN.md §10): event ts trails arrival by
    # U(0, oo_bound); with watermark_interval > 0 the source also emits
    # Watermark(max ts - oo_bound) so downstream event-time operators
    # (windows.py) can run on the synthetic plan
    oo_bound: float = 0.0
    watermark_interval: float = 0.0


def build_synthetic(cfg: SyntheticConfig, policy: str = "tac",
                    mode: str = "prefetch", cache_entries: int = 4096,
                    parallelism: int = 2, gamma: float = 0.3e-3,
                    lookaheads=("udf0", "udf1", "udf2")) -> Engine:
    eng = Engine()
    # counter-based generator: the workload replays bit-exactly from its
    # seed (the chaos oracle's determinism contract, DESIGN.md §15)
    rng = np.random.Generator(np.random.PCG64(cfg.seed))

    def gen(now: float):
        k = int(rng.integers(cfg.n_keys))
        if cfg.oo_bound > 0:
            return (k, {"k": k}, 150,
                    max(0.0, now - cfg.oo_bound * rng.random()))
        return (k, {"k": k}, 150)

    def key_of(tup: Tuple_):
        return tup.key

    remap = {"active": False}

    def udf1_fn(tup: Tuple_):
        if remap["active"]:
            tup.key = tup.key + 10_000_000      # new key space downstream
        return tup

    def apply_fn(tup, state):
        return state, [Tuple_(tup.ts, tup.key, state, 170, tup.ingest_t)]

    src = eng.add(SourceOp(eng, "source", 1, cfg.rate, gen,
                           watermark_interval=cfg.watermark_interval,
                           oo_bound=cfg.oo_bound))
    udf0 = eng.add(MapOp(eng, "udf0", parallelism, fn=None,
                         service_time=12e-6, key_of=key_of))
    udf1 = eng.add(MapOp(eng, "udf1", parallelism, fn=udf1_fn,
                         service_time=12e-6, key_of=key_of))
    udf2 = eng.add(MapOp(eng, "udf2", parallelism, fn=None,
                         service_time=12e-6, key_of=key_of))
    join = eng.add(StatefulOp(
        eng, "stateful", parallelism, apply_fn, SLOW,
        cache_entries * 150, policy=policy, mode=mode, io_workers=24,
        state_size=150, read_only=True,
        default_state=lambda k: {"row": k}, gamma=gamma))
    sink = eng.add(SinkOp(eng, "sink", 1))
    eng.connect(src, udf0)
    eng.connect(udf0, udf1)
    eng.connect(udf1, udf2)
    eng.connect(udf2, join)
    eng.connect(join, sink, partition=lambda k, n: 0)
    if mode == "prefetch":
        by_name = {"udf0": udf0, "udf1": udf1, "udf2": udf2}
        eng.register_prefetching(join, [by_name[n] for n in lookaheads])

    def start_mismatch():
        remap["active"] = True

    def drop_latency():
        for be in join.backends:
            be.model = FAST

    eng.sim.at(cfg.t_mismatch, start_mismatch)
    eng.sim.at(cfg.t_latency_drop, drop_latency)
    return eng
