#!/usr/bin/env python3
"""Time the paged decode attention kernel (K5) of several source trees in
one process on one CUDA card, at ``chip_smoke.py``'s two main-path
shapes: ``decode_32k`` (qwen2.5-32b's width, 1024 rows of 5 query heads
over 32,768 tokens, d 128, bf16) and ``serve`` (8 rows of 5 query heads
over 4097 tokens, d 128, fp32).

    python3 tools/decode_kernel_ab.py --src DIR:LABEL [--src DIR:LABEL ...]
        [--rounds N]

Each DIR is the root of a checkout (e.g. a parent commit unpacked with
``git archive`` into ``build/parent``, and ``.``): its
``repro_torch.kernels.decode_attention`` is imported under its own
``cuda_build`` and its library built into its own ``build/``.  Every
tree's wrapper runs on the same tensors, the trees in turn for
``--rounds`` rounds (4 by default), every other round in the opposite
order (a, b, b, a, ...), so that a drift of the card falls on both.  Each
time is ``chip_smoke.device_ms`` of ``attention_in_range`` (CUDA events).
Prints one JSON line a (round, tree, shape) and, last, one JSON object of
each tree's median a shape, the outputs' largest difference from the
first tree's and the card's name and power limit.  Exits 1 without a
card.
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


def load_tree(root: Path):
    """The decode attention wrapper module of the checkout at ``root``,
    its kernel built, imported apart from every other tree's."""
    for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(root / "src"))
    try:
        mod = importlib.import_module(
            "repro_torch.kernels.decode_attention.decode_attention")
        build = importlib.import_module("repro_torch.kernels.cuda_build")
        build.build_all(("decode_attention",))
    finally:
        sys.path.remove(str(root / "src"))
    return mod


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
    import chip_smoke as cs              # this tree's cases and timer
    trees = []
    for spec in args.src:
        d, label = spec.rsplit(":", 1)
        trees.append((label, load_tree(Path(d).resolve())))
    c = cs.DECODE_32K
    cases = {"decode_32k": cs.decode_32k_case(c),
             "serve": cs.serve_shape_case()}
    big = {"decode_32k": (3, 5), "serve": (20, 7)}   # as check_decode
    times = {(lab, s): [] for lab, _ in trees for s in cases}
    diffs = {}
    for shape, case in cases.items():
        first = None
        for lab, mod in trees:
            out = mod.attention_in_range(*case)
            torch.cuda.synchronize()
            if first is None:
                first = out
            diffs[f"{lab} {shape}"] = float((out.float() - first.float())
                                            .abs().max())
        del first, out
    for rnd in range(args.rounds):
        order = trees if rnd % 2 == 0 else trees[::-1]
        for lab, mod in order:
            for shape, case in cases.items():
                reps, rounds = big[shape]
                ms = cs.device_ms(lambda: mod.attention_in_range(*case),
                                  reps, rounds)
                times[(lab, shape)].append(ms)
                print(json.dumps(dict(round=rnd, tree=lab, shape=shape,
                                      ms=ms)), flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps(dict(
        card=card,
        median_ms={f"{lab} {s}": statistics.median(v)
                   for (lab, s), v in times.items()},
        max_abs_diff_from_first=diffs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
