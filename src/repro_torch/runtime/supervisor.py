# Copy of repro/runtime/supervisor.py; differs only in dropping its unused
# `import jax` (tests/test_torch_isolation.py holds it so).
"""Fault-tolerance supervisor: checkpoint/restart, straggler mitigation,
and elastic re-meshing.

The training loop runs under the supervisor; failures (real exceptions or
injected ones for tests) roll back to the latest checkpoint and replay the
deterministic data pipeline from the recorded step.  Step-time outliers
beyond ``straggler_factor`` x the running median are logged and counted —
on a real fleet this triggers hot-spare swap-in; here it drives the
mitigation bookkeeping that tests assert on.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager


@dataclass
class SupervisorConfig:
    checkpoint_every: int = 20
    straggler_factor: float = 3.0
    max_restarts: int = 3


@dataclass
class SupervisorReport:
    steps_run: int = 0
    restarts: int = 0
    stragglers: int = 0
    losses: List[float] = field(default_factory=list)
    step_times: List[float] = field(default_factory=list)


class TrainSupervisor:
    def __init__(self, cfg: SupervisorConfig, ckpt: CheckpointManager):
        self.cfg = cfg
        self.ckpt = ckpt

    def run(self, state: Any, step_fn: Callable[[Any, int], Any],
            n_steps: int, start_step: int = 0,
            failure_injector: Optional[Callable[[int], None]] = None,
            delay_injector: Optional[Callable[[int], float]] = None
            ) -> SupervisorReport:
        """state: (params, opt_state); step_fn(state, step) ->
        (state, metrics)."""
        rep = SupervisorReport()
        step = start_step
        restarts = 0
        while step < n_steps:
            try:
                t0 = time.time()
                if failure_injector:
                    failure_injector(step)
                if delay_injector:
                    extra = delay_injector(step)
                    if extra:
                        time.sleep(extra)
                state, metrics = step_fn(state, step)
                dt = time.time() - t0
                rep.step_times.append(dt)
                med = float(np.median(rep.step_times[-32:]))
                if len(rep.step_times) > 4 and dt > self.cfg.straggler_factor * med:
                    rep.stragglers += 1
                if "loss" in metrics:
                    rep.losses.append(float(metrics["loss"]))
                rep.steps_run += 1
                step += 1
                if step % self.cfg.checkpoint_every == 0:
                    self.ckpt.save(step, state, extra={"data_step": step})
            except _InjectedFailure:
                restarts += 1
                rep.restarts += 1
                if restarts > self.cfg.max_restarts:
                    raise RuntimeError("too many restarts")
                self.ckpt.wait()
                latest = self.ckpt.latest_step()
                if latest is None:
                    step = start_step       # cold restart
                    continue
                step, state, extra = self.ckpt.restore(state)
                step = extra.get("data_step", step)
        self.ckpt.wait()
        return rep


class _InjectedFailure(Exception):
    """Simulated node failure."""


def inject_failure_at(fail_steps) -> Callable[[int], None]:
    fired = set()

    def injector(step: int) -> None:
        if step in fail_steps and step not in fired:
            fired.add(step)
            raise _InjectedFailure(f"injected failure at step {step}")

    return injector
