# Copy of examples/quickstart.py on repro_torch; differs only in `device`:
# --device (default cuda) goes to the --fused run's StatefulOp.
"""Quickstart: the paper's Fig-1 fraud-detection pipeline.

A stream of card transactions goes through attribute extraction and
normalization before a risk-assessment operator that reads per-card state
from a (modelled) NVMe-backed key-value store.  Keyed Prefetching extracts
the card id at the attribute-extraction operator (the lookahead), sends
hints on a side channel, and the Timestamp-Aware Cache stages the card state
before the transaction arrives.

Run:  PYTHONPATH=src python examples/quickstart_torch.py

The fault-tolerance plane (DESIGN.md §7) is runnable from here too:

    PYTHONPATH=src python examples/quickstart_torch.py --fail-at 3.0 --recover warmed

takes barrier-aligned checkpoints, kills the job mid-run, and recovers
from the last completed epoch — ``warmed`` replays the logged hint
stream to pre-stage the hot cards before the data replay, ``cold`` shows
the on-demand post-restore latency spike it avoids.

On the PyTorch port, ``--device`` (default ``cuda``) places the
``--fused`` run's keyed state; its batches run the fused kernels there.
The three host runs and the ``--fail-at`` tour never touch the device,
and ``--device cpu`` prints what ``examples/quickstart.py`` prints.
"""
import argparse
import os
import random
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.streaming.backend import LOCAL_NVME
from repro_torch.streaming.engine import (Engine, MapOp, SinkOp, SourceOp,
                                    StatefulOp)
from repro_torch.streaming.events import Tuple_


def build(policy: str, mode: str, replayable: bool = False,
          fused: bool = False, device: str = "cuda") -> Engine:
    eng = Engine()
    rng = random.Random(1)
    n_cards = 200_000

    def gen(now):
        # 30% of traffic from a rotating set of hot cards
        if rng.random() < 0.3:
            card = int(now) * 50 + rng.randint(0, 49)
        else:
            card = rng.randint(0, n_cards - 1)
        return (card, {"card": card, "amount": rng.random() * 500}, 180)

    def key_of(tup):
        return tup.payload["card"]

    def risk(tup, state):
        hist = dict(state or {"n": 0, "total": 0.0})
        hist["n"] += 1
        hist["total"] += tup.payload["amount"]
        score = tup.payload["amount"] / (1 + hist["total"] / hist["n"])
        return hist, [Tuple_(tup.ts, tup.key, {"score": score}, 64,
                             tup.ingest_t)]

    fused_kw = {}
    if fused:
        # declarative device form of risk() (DESIGN.md §14): state is
        # the [count, total] pair, each transaction adds [1, amount],
        # and the score emit reads the composed post-update value
        from repro_torch.streaming.fused import FusedSpec

        def score_of(tup, hist):
            amount = tup.payload["amount"]
            score = amount / (1 + hist["total"] / hist["n"])
            return [Tuple_(tup.ts, tup.key, {"score": score}, 64,
                           tup.ingest_t)]

        fused_kw = dict(fused=FusedSpec(
            kind="sum", width=2,
            weight_of=lambda tup: [1.0, tup.payload["amount"]],
            encode=lambda s: None if s is None
            else [float(s["n"]), float(s["total"])],
            decode=lambda v: {"n": int(round(float(v[0]))),
                              "total": float(v[1])},
            emit_of=score_of))

    src = eng.add(SourceOp(eng, "source", 1, 20_000, gen,
                           replayable=replayable))
    extract = eng.add(MapOp(eng, "extract", 2, service_time=12e-6,
                            key_of=key_of))
    normalize = eng.add(MapOp(eng, "normalize", 2, service_time=8e-6,
                              key_of=key_of))
    assess = eng.add(StatefulOp(eng, "stateful", 2, risk, LOCAL_NVME,
                                cache_capacity=512 * 300, policy=policy,
                                mode=mode, io_workers=3, state_size=300,
                                default_state=lambda k: {"n": 0,
                                                         "total": 0.0},
                                device=device, **fused_kw))
    sink = eng.add(SinkOp(eng, "sink", 1))
    eng.connect(src, extract)
    eng.connect(extract, normalize)
    eng.connect(normalize, assess)
    eng.connect(assess, sink, partition=lambda k, n: 0)
    if mode == "prefetch":
        eng.register_prefetching(assess, [extract, normalize])
    return eng


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--fail-at", type=float, default=None,
                    help="inject a whole-job failure this many seconds "
                         "AFTER warmup (same clock as benchmarks/run.py "
                         "--fail-at); enables checkpointing + replayable "
                         "source")
    ap.add_argument("--recover", choices=("warmed", "cold"),
                    default="warmed",
                    help="recovery mode after --fail-at: 'warmed' replays "
                         "the hint log before the data path resumes")
    ap.add_argument("--checkpoint-interval", type=float, default=0.5)
    ap.add_argument("--fused", action="store_true",
                    help="add a fused device-path run (DESIGN.md §14): "
                         "the risk operator's probe/update/emit loop "
                         "runs as one kernel launch per batch")
    ap.add_argument("--device", default="cuda",
                    help="where the --fused run's keyed state lives "
                         "(cuda or cpu)")
    args = ap.parse_args()

    if args.fail_at is not None:
        from repro_torch.streaming.recovery import (CheckpointCoordinator,
                                              inject_failure_at)
        warmup = 1.0
        t_fail = warmup + args.fail_at
        print(f"fraud-detection quickstart with a failure "
              f"{args.fail_at}s after warmup ({args.recover} recovery)")
        eng = build("tac", "prefetch", replayable=True)
        coord = CheckpointCoordinator(eng,
                                      interval=args.checkpoint_interval)
        coord.start()
        inject_failure_at(eng, at=t_fail, mode=args.recover)
        m = eng.run(duration=max(6.0, args.fail_at + 3.0), warmup=warmup)
        ck, rec = m.get("checkpoint", {}), m.get("recovery", {})
        print(f"  p50={m['p50']*1e3:7.2f}ms p999={m['p999']*1e3:8.2f}ms "
              f"cache-hit={m.get('stateful_hit_rate', 0):.3f}")
        print(f"  epochs completed={ck.get('epochs_completed')} "
              f"align-stall max={ck.get('align_stall_max', 0)*1e3:.2f}ms")
        print(f"  recovered from epoch {rec.get('last_epoch')} in "
              f"{rec.get('last_downtime', 0)*1e3:.1f}ms "
              f"(restore {rec.get('last_restore_bytes', 0)} B, "
              f"{rec.get('warmup_hints', 0)} warmup hints, "
              f"{rec.get('replayed', 0)} tuples replayed)")
        return

    print("fraud-detection quickstart (6s simulated stream, 20k tx/s)")
    runs = [("cache-only (sync)", "lru", "sync", False),
            ("async I/O", "lru", "async", False),
            ("keyed prefetching", "tac", "prefetch", False)]
    if args.fused:
        runs.append(("fused device path", "tac", "prefetch", True))
    for label, policy, mode, fused in runs:
        m = build(policy, mode, fused=fused,
                  device=args.device).run(duration=5.0, warmup=2.0)
        fill = m.get("stateful_fused", {}).get("fill_ratio")
        extra = f" batch-fill={fill:.2f}" if fill is not None else ""
        print(f"  {label:22s} p50={m['p50']*1e3:7.2f}ms "
              f"p999={m['p999']*1e3:8.2f}ms "
              f"cache-hit={m.get('stateful_hit_rate', 0):.3f}{extra}")


if __name__ == "__main__":
    main()
