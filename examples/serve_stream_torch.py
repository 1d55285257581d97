"""Streaming tour of the paged session-state serving subsystem, on the
PyTorch port: ``examples/serve_stream.py``'s tour on ``repro_torch.serving``
with the arena's pools as torch tensors on ``--device``.

Drives the serving subsystem directly with a synthetic decode step (no
model), so the arena / tiered-store / scheduler interplay is visible in
isolation: requests arrive, the ingest stage hints the store, pages stream
toward the arena, and only page-resident requests are scheduled.  The
arrivals, seeds and printed lines are the JAX tour's.

    PYTHONPATH=src python examples/serve_stream_torch.py --mode prefetch
    PYTHONPATH=src python examples/serve_stream_torch.py --device cpu
"""
from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.serving import (ContinuousBatchingScheduler,  # noqa: E402
                                 PagedStateArena, Request, SimClock,
                                 TieredStore)

PAGE, D, PAGES_PER_SESSION = 16, 8, 3


def page_keys(sid: int) -> np.ndarray:
    return np.asarray([sid * 64 + p + 1 for p in range(PAGES_PER_SESSION)],
                      np.int32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="prefetch",
                    choices=["sync", "async", "prefetch"])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--sessions", type=int, default=8)
    ap.add_argument("--rate", type=float, default=300.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    arena = PagedStateArena(n_buckets=8, ways=4,
                            pools={"state": ((PAGE, D), torch.float32)},
                            device=args.device)
    store = TieredStore(page_bytes=PAGE * D * 4, workers=4)
    rng = np.random.RandomState(0)
    for sid in range(args.sessions):
        for p, key in enumerate(page_keys(sid)):
            store.seed(int(key),
                       {"state": rng.randn(PAGE, D).astype(np.float32)})

    clock = SimClock()
    sched = ContinuousBatchingScheduler(arena, store, mode=args.mode,
                                        max_batch=2, clock=clock)
    arrivals = np.cumsum(rng.exponential(1.0 / args.rate, args.requests))
    reqs = [Request(rid=i, session=int(rng.randint(args.sessions)),
                    page_keys=None, n_tokens=3) for i in range(args.requests)]
    for r in reqs:
        r.page_keys = page_keys(r.session)

    i = 0
    while i < args.requests or sched.pending:
        while i < args.requests and arrivals[i] <= clock.now():
            sched.submit(reqs[i])
            print(f"{clock.now()*1e3:8.2f}ms  enqueue r{reqs[i].rid} "
                  f"(session {reqs[i].session})")
            i += 1
        batch = sched.schedule()
        if not batch:
            if sched.wait_for_progress():
                continue
            if i < args.requests:
                clock.sleep(max(1e-6, arrivals[i] - clock.now()))
                continue
            break
        for req in batch:
            clock.advance(0.8e-3)               # synthetic decode step
            sched.complete_token(req, dirty_keys=req.page_keys[:1])
            tag = "FIRST" if req.tokens_done == 1 else f"tok{req.tokens_done}"
            print(f"{clock.now()*1e3:8.2f}ms  decode  r{req.rid} {tag}"
                  + ("  [done]" if req.state == "done" else ""))

    s = sched.stats()
    print(f"\n[{args.mode}] ttft p50={s['ttft_p50']*1e3:.2f}ms "
          f"p99={s['ttft_p99']*1e3:.2f}ms  arena hit={s['arena_hit_rate']:.2f}"
          f"  staging overlap={s['staging_overlap']:.2f}  "
          f"writebacks={s['store_writebacks']}")
    return s


if __name__ == "__main__":
    main()
