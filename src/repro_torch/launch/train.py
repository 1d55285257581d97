"""Training launcher, in PyTorch: the port of ``repro/launch/train.py``:
data pipeline -> model -> AdamW, with checkpointing, fault-tolerant
supervision and optional gradient compression, on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --steps 20

By default the ``--smoke`` reduced config trains (loss decreases) on the
card (``--device cuda``); ``--full`` takes the published config.
Checkpoints go through ``checkpoint/manager.py`` in the reference's
layout, so a training state written by either package restores in the
other.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, batch_at
from repro_torch.launch.steps import make_train_step
from repro_torch.models.lm import build_model, stack_layers
from repro_torch.optim import adamw
from repro_torch.runtime.compression import make_compressor
from repro_torch.runtime.supervisor import (SupervisorConfig, TrainSupervisor,
                                            inject_failure_at)


def build_training(arch: str, smoke: bool, batch: int, seq: int,
                   n_micro: int = 1, compress: bool = False,
                   lr: float = 1e-3, seed: int = 0, device="cuda",
                   warmup: int = 10, **overrides):
    """(state, step_fn, model, cfg) as the reference builds them: state is
    (params, opt_state), params in the reference's layout drawn from a
    generator seeded with ``seed`` on ``device``, and ``step_fn(state,
    step)`` trains on ``batch_at(step)``.  ``warmup`` is the schedule's
    warm-up (the reference's 10); ``overrides`` replace config fields
    (``num_layers``, ``remat``, ``dtype``)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    model = build_model(cfg, device)
    acfg = adamw.AdamWConfig(lr_peak=lr, lr_min=lr * 0.1,
                             warmup_steps=warmup, decay_steps=10_000)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = stack_layers(cfg, model.init_tree(gen))
    opt_state = adamw.init(acfg, params)

    fe = cfg.frontend
    dcfg = DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
        seed=seed,
        frontend_tokens=fe.num_tokens if fe and fe.kind == "vision" else 0,
        frontend_dim=fe.embed_dim if fe else 0,
        encoder_decoder=cfg.encoder_decoder)

    if compress:
        init_err, transform = make_compressor()
        err_holder = {"err": init_err(params)}

        def grad_transform(grads):
            g, err_holder["err"] = transform(grads, err_holder["err"])
            return g
    else:
        grad_transform = None

    step_fn_raw = make_train_step(model, acfg, n_micro=n_micro,
                                  grad_transform=grad_transform)

    def step_fn(state, step):
        params, opt_state = state
        b = batch_at(dcfg, step, device)
        params, opt_state, metrics = step_fn_raw(params, opt_state, b)
        return (params, opt_state), metrics

    return (params, opt_state), step_fn, model, cfg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-7b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    state, step_fn, model, cfg = build_training(
        args.arch, args.smoke, args.batch, args.seq, args.micro,
        args.compress_grads, args.lr, device=args.device)
    ckpt = CheckpointManager(args.ckpt, keep=2)
    start = 0
    if args.resume and ckpt.latest_step() is not None:
        start, state, extra = ckpt.restore(state)
        print(f"[train] resumed from step {start}")
    sup = TrainSupervisor(SupervisorConfig(
        checkpoint_every=args.ckpt_every), ckpt)
    injector = (inject_failure_at({args.inject_failure_at})
                if args.inject_failure_at is not None else None)
    t0 = time.time()
    rep = sup.run(state, step_fn, args.steps, start_step=start,
                  failure_injector=injector)
    dt = time.time() - t0
    first = rep.losses[0] if rep.losses else float("nan")
    last = rep.losses[-1] if rep.losses else float("nan")
    print(f"[train] arch={args.arch} device={args.device} "
          f"steps={rep.steps_run} restarts={rep.restarts} "
          f"stragglers={rep.stragglers} loss {first:.3f} -> {last:.3f} "
          f"({dt:.1f}s)")


if __name__ == "__main__":
    main()
