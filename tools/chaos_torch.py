#!/usr/bin/env python
# Copy of tools/chaos.py on repro_torch; differs only in the package.
"""Chaos/soak driver for the exactly-once state-effect oracle
(streaming/chaos.py, DESIGN.md §15).

Each schedule perturbs the NEXMark q11 session query with >= 2
concurrent fault kinds (failure, shard migration, load shift, hint-
channel drop/delay) and differentially compares final keyed state,
session registry, and per-pane final emits against an unperturbed
golden run of the same workload seed.  Failing schedules are shrunk to
a minimal reproducer and pickled under ``--out-dir``.

  --smoke          3 fixed-seed schedules (the CI gate)
  --soak N         N schedules from a rotating base seed (nightly)
  --seed B         base seed for --soak (e.g. the CI run number)

Exit status 1 iff any schedule violates the oracle.
"""
from __future__ import annotations

import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.streaming.chaos import (FaultSchedule, check_schedule,  # noqa: E402
                                   minimize, save_artifact)

SMOKE_SEEDS = (101, 202, 303)


def run_one(sched: FaultSchedule, t_cut: float, out_dir: str,
            golden_cache: dict) -> bool:
    golden = golden_cache.get(sched.seed)
    report, golden, perturbed = check_schedule(sched, t_cut, golden=golden)
    golden_cache[sched.seed] = golden
    status = "ok" if report.ok else "VIOLATED"
    print(f"seed {sched.seed} kinds={'/'.join(sched.kinds())}: {status} "
          f"deviations={report.deviations} "
          f"(fires={perturbed.metrics['fires']} "
          f"merged={perturbed.metrics['sessions_merged']} "
          f"failures={perturbed.metrics['failures']})")
    if report.ok:
        return True
    for v in report.violations[:5]:
        print(f"  violation: {v}")
    mini = minimize(sched, t_cut, golden=golden)
    path = save_artifact(mini, report, out_dir=out_dir)
    print(f"  minimized to {len(mini.events)} event(s): {mini.events}")
    print(f"  reproducer pickled: {path}")
    return False


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--smoke", action="store_true",
                   help="3 fixed-seed schedules (CI gate)")
    g.add_argument("--soak", type=int, metavar="N",
                   help="N rotating-seed schedules (nightly)")
    ap.add_argument("--seed", type=int, default=0,
                    help="base seed for --soak schedules")
    ap.add_argument("--t-cut", type=float, default=2.0,
                    help="logical stream length per run (seconds)")
    ap.add_argument("--events", type=int, default=4,
                    help="fault events per schedule")
    ap.add_argument("--out-dir", default="chaos_artifacts",
                    help="directory for minimized reproducer pickles")
    args = ap.parse_args()

    if args.smoke:
        seeds = SMOKE_SEEDS
    else:
        seeds = tuple(1000 + args.seed * 17 + i for i in range(args.soak))

    golden_cache: dict = {}
    failures = 0
    for seed in seeds:
        sched = FaultSchedule.random(seed, n_events=args.events)
        if not run_one(sched, args.t_cut, args.out_dir, golden_cache):
            failures += 1
    total = len(seeds)
    print(f"\n{total - failures}/{total} schedules passed the "
          f"exactly-once oracle")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
