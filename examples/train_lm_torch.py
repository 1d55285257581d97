"""End-to-end training driver with fault tolerance on the PyTorch port:
``examples/train_lm.py`` on ``repro_torch``.  Trains a reduced
gemma-family model on the deterministic token pipeline, injects a node
failure mid-run, and recovers from the latest checkpoint.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 120]
          [--device cuda|cpu]
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.launch.train import build_training
from repro_torch.runtime.supervisor import (SupervisorConfig, TrainSupervisor,
                                            inject_failure_at)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    state, step_fn, model, cfg = build_training(
        args.arch, smoke=True, batch=8, seq=64, n_micro=2, compress=False,
        device=args.device)
    with tempfile.TemporaryDirectory() as d:
        ckpt = CheckpointManager(d, keep=2)
        sup = TrainSupervisor(SupervisorConfig(checkpoint_every=20), ckpt)
        fail_at = args.steps // 2
        print(f"training {args.arch} (reduced) on {args.device} for "
              f"{args.steps} steps, failure injected at step {fail_at}")
        rep = sup.run(state, step_fn, args.steps,
                      failure_injector=inject_failure_at({fail_at}))
        print(f"steps run (incl. replayed): {rep.steps_run}, "
              f"restarts: {rep.restarts}")
        print(f"loss: {rep.losses[0]:.3f} -> {rep.losses[-1]:.3f}")
        assert rep.restarts == 1 and rep.losses[-1] < rep.losses[0]
        print("recovered and converged ✓")
    return rep


if __name__ == "__main__":
    main()
