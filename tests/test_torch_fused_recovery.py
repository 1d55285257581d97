"""The fused device plane under Keyed Prefetching, through checkpoints, a
crash and a restore, on the CPU: the port against the reference.

* the chaos-schedule parity of tests/test_fused.py (checkpoints, a warmed
  failure, a load shift): the port's fused operator lands on the port's
  interpreted state, on the golden unperturbed state, and on the
  reference's fused state, key for key;
* q5 and q7 fused in ``prefetch`` and ``sync`` mode with a ``cold`` and a
  ``warmed`` failure (benchmarks/recovery.py's run_one at a small size):
  equal metrics and recovery blocks, no tensor in any snapshot record, and
  the planes a crash replaced freed.
"""
import gc
import importlib
import os
import sys
import weakref

import pytest

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
from _torch_port import one_thread  # noqa: E402,F401
from chip_smoke import chaos_count, foreign_types  # noqa: E402
from test_fused import run_chaos_count  # noqa: E402


def test_chaos_schedule_parity_port_fused_vs_interpreted_vs_reference():
    port_fused, f1 = chaos_count(fused=True, device="cpu")
    port_interp, f2 = chaos_count(fused=False)
    golden, _ = chaos_count(fused=False, events=False)
    ref_fused, f3 = run_chaos_count(fused=True)
    assert f1 >= 1 and f2 >= 1 and f3 >= 1
    assert golden and sum(golden.values()) > 0
    assert port_interp == golden
    assert port_fused == golden
    assert port_fused == ref_fused


def run_recovery(pkg, query, mode, scenario):
    """q5/q7 on the fused plane, checkpoints every 0.4 s over a replayable
    source, one failure 1.1 s after warm-up, replay x2."""
    nx = importlib.import_module(f"{pkg}.streaming.nexmark")
    rec = importlib.import_module(f"{pkg}.streaming.recovery")
    kw = dict(device="cpu") if pkg == "repro_torch" else {}
    cfg = nx.NexmarkConfig(rate=2000, active_window=1.0, oo_bound=0.3,
                           seed=7)
    eng = nx.build_query(query, "tac", mode, cfg, cache_entries=256,
                         parallelism=2, source_parallelism=1, io_workers=4,
                         buffer_timeout=0.002, replayable=True, fused=True,
                         fused_batch=64, **kw)
    coord = rec.CheckpointCoordinator(
        eng, interval=0.4, store=rec.SnapshotStore(keep=1 << 30))
    coord.start()
    rec.inject_failure_at(eng, at=1.6, mode=scenario, replay_speedup=2.0)
    m = eng.run(duration=2.5, warmup=0.5)
    return m, coord, eng


@pytest.mark.parametrize("query", ["q5", "q7"])
@pytest.mark.parametrize("mode", ["prefetch", "sync"])
@pytest.mark.parametrize("scenario", ["cold", "warmed"])
def test_fused_recovery_matches_reference(query, mode, scenario):
    from repro_torch.streaming.fused import FusedPlane
    planes = []
    init = FusedPlane.__init__

    def tracked(self, *a, **kw):
        planes.append(weakref.ref(self))
        init(self, *a, **kw)

    FusedPlane.__init__ = tracked
    try:
        port, coord, eng = run_recovery("repro_torch", query, mode,
                                        scenario)
    finally:
        FusedPlane.__init__ = init
    ref, _, _ = run_recovery("repro", query, mode, scenario)
    assert port == ref
    rec = port["recovery"]
    assert rec["failures"] == 1
    assert (rec["warmup_hints"] > 0) == (scenario == "warmed")
    assert port["stateful_fused"]["batches"] > 0
    assert port["checkpoint"]["epochs_completed"] >= 3
    assert coord.store.records
    assert not foreign_types([coord.store.records,
                              coord.store.materialized])
    # the crash replaced both subtasks' planes, and the old ones are gone
    gc.collect()
    live = [p() for p in planes if p() is not None]
    assert len(planes) == 4
    assert sorted(map(id, live)) == \
        sorted(map(id, eng.operators["stateful"].caches))


def test_snapshot_walk_finds_a_tensor_anywhere():
    import numpy as np
    import torch
    from repro_torch.streaming.events import Tuple_, WindowKey
    clean = {("stateful", 0): {"delta": {WindowKey(3, 0.5): 4},
                               "inflight": [Tuple_(1.0, 3, None, 64, 0.0)],
                               "deleted": {1, 2}, "manifest": [(3, 0.5)]}}
    assert foreign_types([clean]) == set()
    hidden = Tuple_(1.0, 3, torch.ones(2), 64, 0.0)
    assert foreign_types([{"x": [(1, hidden)]}]) == {"torch.Tensor"}
    assert foreign_types({"ts": np.float32(1.0)}) == {"numpy.float32"}
