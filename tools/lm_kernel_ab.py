#!/usr/bin/env python3
"""Time the forwards of K6 (flash attention), K7 (the Mamba2 SSD scan)
and K8 (the RWKV6 scan) of several source trees in one process on one
CUDA card, at ``chip_smoke.py``'s main-path shapes: K6 at zamba2-2.7b's
prefill (4 x 32 heads, S = T = 2048, d 80, bf16, causal), K7 at
zamba2-2.7b's prefill (4 x 80 heads, S 2048, Q 128, N = P = 64, bf16)
and K8 at rwkv6-3b's prefill (4 x 40 heads, S 2048, N 64, fp32).

    python3 tools/lm_kernel_ab.py --src DIR:LABEL [--src DIR:LABEL ...]
        [--rounds N]

Each DIR is the root of a checkout (e.g. a parent commit unpacked with
``git archive`` into ``build/parent``, and ``.``): its wrappers are
imported under its own ``cuda_build`` and their kernels built into its
own ``build/``.  Every tree's wrapper runs on the same tensors
(``chip_smoke``'s seeded draws), the trees in turn for ``--rounds``
rounds (4 by default), every other round in the opposite order (a, b, b,
a, ...), so that a drift of the card falls on both.  Each time is
``chip_smoke.device_ms`` of the wrapper (CUDA events).  Prints one JSON
line a (round, tree, kernel) and, last, one JSON object of each tree's
median a kernel, the outputs' largest difference from the first tree's
and the card's name and power limit.  Exits 1 without a card.
"""
from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
MODULES = {"flash_attention": "flash_attention.flash_attention",
           "mamba2_scan": "mamba2_scan.mamba2_scan",
           "rwkv6_scan": "rwkv6_scan.rwkv6_scan"}


def load_tree(root: Path) -> dict:
    """The three wrapper modules of the checkout at ``root``, their
    kernels built, imported apart from every other tree's."""
    for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(root / "src"))
    try:
        mods = {k: importlib.import_module(f"repro_torch.kernels.{m}")
                for k, m in MODULES.items()}
        build = importlib.import_module("repro_torch.kernels.cuda_build")
        build.build_all(tuple(MODULES))
    finally:
        sys.path.remove(str(root / "src"))
    return mods


def cases(torch, cs):
    """{kernel: (wrapper name, arguments)} at the main-path shapes."""
    g = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    q, k, v = (cs.randn((4, 2048, 32, 80), bf16, g) for _ in range(3))
    x = cs.randn((4, 2048, 80, 64), bf16, g)
    dt = torch.nn.functional.softplus(cs.randn((4, 2048, 80), f32, g))
    A = -torch.exp(cs.randn((4 * 80,), f32, g, 0.5))
    Bm, Cm = (cs.randn((4, 2048, 1, 64), bf16, g) for _ in range(2))
    r, vv = (cs.randn((4, 2048, 40, 64), f32, g) for _ in range(2))
    kk = cs.randn((4, 2048, 40, 64), f32, g, 0.3)
    w = torch.sigmoid(cs.randn((4, 2048, 40, 64), f32, g))
    u = cs.randn((4 * 40, 64), f32, g, 0.1)
    s0 = cs.randn((4, 40, 64, 64), f32, g, 0.1)
    return {"flash_attention": ("flash_attention_kernel", (q, k, v, True)),
            "mamba2_scan": ("mamba2_scan_kernel", (x, dt, A, Bm, Cm, 128)),
            "rwkv6_scan": ("rwkv6_scan_kernel", (r, kk, vv, w, u, s0))}


def first(out):
    return out[0] if isinstance(out, tuple) else out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", action="append", required=True,
                    help="DIR:LABEL, the root of a checkout and its name")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(HERE / "src"))
    import chip_smoke as cs              # this tree's draws and timer
    trees = []
    for spec in args.src:
        d, label = spec.rsplit(":", 1)
        trees.append((label, load_tree(Path(d).resolve())))
    calls = cases(torch, cs)
    times = {(lab, k): [] for lab, _ in trees for k in calls}
    diffs = {}
    with torch.no_grad():
        for kernel, (fn, a) in calls.items():
            ref = None
            for lab, mods in trees:
                out = first(getattr(mods[kernel], fn)(*a)).float()
                torch.cuda.synchronize()
                ref = out if ref is None else ref
                diffs[f"{lab} {kernel}"] = float((out - ref).abs().max())
            del ref, out
        for rnd in range(args.rounds):
            order = trees if rnd % 2 == 0 else trees[::-1]
            for lab, mods in order:
                for kernel, (fn, a) in calls.items():
                    f = getattr(mods[kernel], fn)
                    ms = cs.device_ms(lambda: f(*a), reps=5, rounds=5)
                    times[(lab, kernel)].append(ms)
                    print(json.dumps(dict(round=rnd, tree=lab, kernel=kernel,
                                          ms=ms)), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps(dict(
        card=card,
        median_ms={f"{lab} {k}": statistics.median(v)
                   for (lab, k), v in times.items()},
        max_abs_diff_from_first=diffs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
