"""Every query of the README's coverage table builds and runs on the port,
in the paper's mode (TAC, Keyed Prefetching), and its run equals the
reference's on the same seed: outputs, latency percentiles (simulated
time), hit rate and every other metric of the run."""
import importlib
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))
from _torch_port import one_thread  # noqa: E402,F401

# (query, oo_bound): the windowed, join and session queries need event
# time; q20 runs both its processing-time form and its event-time join
QUERIES = [("q3", 0.0), ("q4", 0.0), ("q5", 0.3), ("q7", 0.3), ("q8", 0.3),
           ("q11", 0.3), ("q13", 0.0), ("q18", 0.0), ("q19", 0.0),
           ("q20", 0.0), ("q20", 0.3), ("ysb", 0.0)]


def run_query(pkg, query, oo_bound):
    if query == "ysb":
        ysb = importlib.import_module(f"{pkg}.streaming.ysb")
        eng = ysb.build_ysb("tac", "prefetch",
                            ysb.YSBConfig(rate=2000, seed=11),
                            cache_entries=256, parallelism=2,
                            source_parallelism=1, io_workers=4)
    else:
        nx = importlib.import_module(f"{pkg}.streaming.nexmark")
        cfg = nx.NexmarkConfig(rate=2000, active_window=1.0,
                               oo_bound=oo_bound, seed=7)
        eng = nx.build_query(query, "tac", "prefetch", cfg,
                             cache_entries=256, parallelism=2,
                             source_parallelism=1, io_workers=4)
    return eng.run(duration=2.0, warmup=0.5)


@pytest.mark.parametrize("query,oo_bound", QUERIES,
                         ids=[f"{q}-oo{o}" for q, o in QUERIES])
def test_query_matches_reference(query, oo_bound):
    port = run_query("repro_torch", query, oo_bound)
    ref = run_query("repro", query, oo_bound)
    assert port["n_outputs"] > 0
    hit_rates = [k for k in port if k.endswith("_hit_rate")]
    assert hit_rates
    for k in ("n_outputs", "p50", "p99", "p999", *hit_rates):
        assert port[k] == ref[k], k
    assert port == ref
