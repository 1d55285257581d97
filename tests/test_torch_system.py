"""The paper's headline on the port, the twin of
tests/test_system.py::test_end_to_end_keyed_prefetching_beats_sync_caching:
on q13, Keyed Prefetching with TAC beats sync caching on p99.9 without
losing throughput, and the port's runs equal the reference's."""
import importlib
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))
from _torch_port import one_thread  # noqa: E402,F401


def headline(pkg):
    nx = importlib.import_module(f"{pkg}.streaming.nexmark")
    cfg = nx.NexmarkConfig(rate=22_000, active_window=40.0)
    res = {}
    for name, policy, mode in [("sync", "lru", "sync"),
                               ("kp", "tac", "prefetch")]:
        eng = nx.build_query("q13", policy, mode, cfg, cache_entries=512,
                             parallelism=2, source_parallelism=1,
                             io_workers=2)
        res[name] = eng.run(duration=3.0, warmup=1.5)
    return res


def test_end_to_end_keyed_prefetching_beats_sync_caching():
    res = headline("repro_torch")
    assert res["kp"]["p999"] < res["sync"]["p999"]
    assert res["kp"]["throughput"] >= 0.98 * res["sync"]["throughput"]
    assert res["kp"]["stateful_hit_rate"] > 0.9
    assert res == headline("repro")
