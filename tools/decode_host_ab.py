#!/usr/bin/env python3
"""Time the port's eager decode on one CUDA card for several source trees,
to see what host work a change adds to a token.

    python3 tools/decode_host_ab.py --src DIR:LABEL [--src DIR:LABEL ...]
        [--rounds N]

Each DIR is the root of a checkout: its ``src/repro_torch`` is imported
and its kernels are built into its own ``build/`` (e.g. a parent commit
unpacked with ``git archive`` into ``build/parent``, and ``.``).  The
trees run in turn, each in a process of its own, for ``--rounds`` rounds
(2 by default), every other round in the opposite order (a, b, b, a, ...),
so that a drift of the card or the host falls on both.  Each run prints
one JSON line:

  * ``decode_ms``: gemma-7b, zamba2-2.7b and rwkv6-3b at full width and
    depth with bf16 seeded weights: 4 requests of 256 tokens prefilled,
    then 4 warm-up and 32 timed greedy decode steps with one sync at the
    end; ms a token on the host's clock;
  * ``serve_step_ms``: ``run_serving``'s eager decode step
    (``launch/serve.py::decode_step``) on the smoke models at
    ``chip_smoke.py``'s serve_lm prompts; the mean of 50 after a sync;
  * ``serve_lm``: ``run_serving`` on those smoke models at
    ``chip_smoke.py``'s serve_lm configuration, in sync and prefetch
    mode: TTFT p50 and p99 (s) and the run's wall s.

Exits 1 without a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

FULL = ("gemma-7b", "zamba2-2.7b", "rwkv6-3b")
B, S, WARM, STEPS = 4, 256, 4, 32
# chip_smoke.py's SERVE_LM
SERVE = dict(n_sessions=12, n_requests=24, decode_tokens=2,
             store_latency=0.03, cache_sessions=6, arrival_rate=500.0)
PROMPTS = {"gemma-7b": 16, "zamba2-2.7b": 32, "rwkv6-3b": 32}


def child(root: str, label: str, rnd: int) -> dict:
    sys.path.insert(0, str(Path(root).resolve() / "src"))
    import numpy as np
    import torch
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels import cuda_build
    from repro_torch.launch.serve import (ServeConfig, StatePager, _grow_kv,
                                          decode_step, run_serving)
    from repro_torch.models.lm import build_model
    row = dict(label=label, round=rnd,
               src=str(Path(cuda_build.__file__).resolve().parents[3]),
               build_s=cuda_build.build_all())
    gen = lambda: torch.Generator(device="cuda").manual_seed(0)  # noqa: E731

    decode = {}
    for arch in FULL:
        cfg = get_config(arch).replace(dtype="bfloat16")
        model = build_model(cfg, "cuda").init_params(gen())
        g = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                               dtype=torch.int32)
        with torch.no_grad():
            logits, cache = model.prefill({"tokens": tokens})
            cache = _grow_kv(cache, S, S + WARM + STEPS)
            tok = logits.argmax(-1, keepdim=True).int()
            for i in range(WARM + STEPS):
                if i == WARM:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                logits, cache = model.decode(cache, {"tokens": tok,
                                                     "pos": S + i})
                tok = logits.argmax(-1, keepdim=True).int()
            torch.cuda.synchronize()
        decode[arch] = (time.perf_counter() - t0) / STEPS * 1e3
        if not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"{arch}: decode logits not finite")
        del model, cache, logits
        torch.cuda.empty_cache()
    row["decode_ms"] = decode

    step_ms, serve = {}, {}
    for arch, prompt in PROMPTS.items():
        scfg = get_smoke_config(arch)
        model = build_model(scfg, "cuda").init_params(gen())
        toks = np.random.RandomState(0).randint(
            0, scfg.vocab_size, (1, prompt)).astype(np.int32)
        _, kv = model.prefill({"tokens": torch.from_numpy(toks)})
        kv = _grow_kv(kv, prompt, prompt + SERVE["decode_tokens"] + 8)
        pager = StatePager(kv, ServeConfig.page_elems)
        pages, aux = pager.to_pages(kv)
        step = decode_step(model, pager)
        one = torch.ones((1, 1), dtype=torch.int32, device="cuda")
        pos = torch.tensor(prompt, dtype=torch.int32)
        for _ in range(5):
            step(pages, aux, one, pos)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            step(pages, aux, one, pos)
        torch.cuda.synchronize()
        step_ms[arch] = (time.perf_counter() - t0) / 50 * 1e3
        del model, kv, pages, aux, step
        cfg = ServeConfig(arch=arch, prompt_len=prompt, **SERVE)
        for mode in ("sync", "prefetch"):
            t0 = time.perf_counter()
            out = run_serving(cfg, mode, device="cuda")
            serve[f"{arch} {mode}"] = dict(
                ttft_p50=out["ttft_p50"], ttft_p99=out["ttft_p99"],
                wall_s=time.perf_counter() - t0)
    row["serve_step_ms"] = step_ms
    row["serve_lm"] = serve
    return row


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append", default=[],
                    help="DIR:LABEL, a checkout's root and its name")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", nargs=3, metavar=("DIR", "LABEL", "ROUND"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        root, label, rnd = args.child
        print(json.dumps(child(root, label, int(rnd))), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("decode_host_ab: no CUDA device", file=sys.stderr)
        return 1
    trees = [s.rsplit(":", 1) for s in args.src]
    rc = 0
    for rnd in range(args.rounds):
        for root, label in (trees if rnd % 2 == 0 else trees[::-1]):
            out = subprocess.run([sys.executable, __file__, "--child", root,
                                  label, str(rnd)], capture_output=True,
                                 text=True)
            lines = out.stdout.strip().splitlines()
            if out.returncode or not lines:
                print(json.dumps(dict(label=label, round=rnd,
                                      rc=out.returncode,
                                      error=out.stderr[-3000:])), flush=True)
                rc = 1
                continue
            print(lines[-1], flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
