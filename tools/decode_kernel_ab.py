#!/usr/bin/env python3
"""Time the paged decode attention kernel (K5) of several source trees in
one process on one CUDA card, at ``chip_smoke.py``'s two main-path
shapes, ``decode_32k`` (qwen2.5-32b's width, 1024 rows of 5 query heads
over 32,768 tokens, d 128, bf16) and ``serve`` (8 rows of 5 query heads
over 4097 tokens, d 128, fp32); at its timed zoo widths, ``gemma-7b
decode`` (128 rows of 1 head, d 256, 4096 tokens, bf16) and ``MLA
latent`` (8 rows of 128 heads, (576, 512), bf16); and past (576, 512):
the timed ``(1024, 1024)`` row (8 rows of 16 heads over 4096 tokens,
bf16) and the TF32 walk's (route 3's) rows at that shape in fp32 and
at a ragged bf16 (1001, 1000); the MLA latent in fp32; and bf16 at
(576, 512) with 1, 4, 16 and 32 heads a row and (264, 256) with 1 and 16
(route 5 where a tree before it ran route 1's 16-head blocks).

Then the routes of ``ROUTE_AB``: the last tree's ``launch_instance`` at
each named instance on the same inputs, in turns (a b b a), each output
against the plain version: route 3 (the TF32 walk, "walk") against route
2 (the lanes) in fp32 at gemma-7b's decode shape (128 rows x 1 head, d
256), at (576, 512), (96, 96) and (300, 100), and in ragged bf16 at
(100, 60), each at several head counts a row (where the two cross is
``LANES_HEADS``); and route 5 ("wgmma") against route 3 in bf16 at
(576, 512) and (264, 256) with few heads a row.

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
Before the rounds, ``torch.profiler`` gives each (tree, shape) its
device ms a call of pass 1 and of the merge (pass 2), over 20 calls.
Prints one JSON line a (round, tree, shape) and, last, one JSON object of
each tree's median a shape, the outputs' largest difference from the
first tree's, the plain version's time (``paged_decode_plain`` of the
first tree, the same rounds) at the three shapes past (576, 512), the
routes' medians and largest errors, and the card's name and power
limit.  Exits 1 without a card.
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
# name -> (rows, heads, d, dv, type, the routes run), 8 rows over 4096
# tokens but gemma-7b's 128 rows
LANES_WALK, WG_WALK = ("lanes", "walk"), ("wgmma", "walk")
ROUTE_AB = {"gemma-7b decode fp32": (128, 1, 256, 256, "fp32", LANES_WALK),
            **{f"({d}, {dv}) {t} x {h} heads": (8, h, d, dv, t, LANES_WALK)
               for d, dv, t, heads in (
                   (576, 512, "fp32", (4, 8, 12, 16, 32, 64, 128)),
                   (96, 96, "fp32", (1, 4, 8, 16, 32, 64)),
                   (300, 100, "fp32", (8, 16, 32, 64)),
                   (100, 60, "bf16", (8, 20, 32, 64)))
               for h in heads},
            **{f"({d}, {dv}) bf16 x {h} heads": (8, h, d, dv, "bf16",
                                                 WG_WALK)
               for d, dv, heads in ((576, 512, (1, 16)), (264, 256, (1,)))
               for h in heads}}


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
    from torch.profiler import ProfilerActivity, profile
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
    bf16, fp32 = torch.bfloat16, torch.float32
    cases = {"decode_32k": cs.decode_32k_case(c),
             "serve": cs.serve_shape_case(),
             "gemma-7b decode": cs.decode_case(128, 1, 256, 64, 64, bf16,
                                               length=4096, dv=256),
             "MLA latent": cs.decode_case(8, 128, 576, 64, 64, bf16,
                                          length=4096, dv=512),
             "MLA latent fp32": cs.decode_case(8, 128, 576, 64, 64, fp32,
                                               length=4096, dv=512),
             "(1024, 1024)": cs.decode_case(8, 16, 1024, 16, 256, bf16,
                                            length=4096, dv=1024),
             "(1024, 1024) fp32": cs.decode_case(8, 16, 1024, 16, 256, fp32,
                                                 length=4096, dv=1024),
             "(1001, 1000) bf16": cs.decode_case(8, 16, 1001, 16, 256, bf16,
                                                 length=4096, dv=1000),
             **{f"({d}, {dv}) bf16 x {h} heads": cs.decode_case(
                 8, h, d, 64, 64, bf16, length=4096, dv=dv)
                for d, dv, heads in ((576, 512, (1, 4, 16, 32)),
                                     (264, 256, (1, 16)))
                for h in heads}}
    big = {"decode_32k": (3, 5)}        # as check_decode; (20, 7) else
    walks = ("(1024, 1024)", "(1024, 1024) fp32", "(1001, 1000) bf16")
    times = {(lab, s): [] for lab, _ in trees for s in cases}
    plain = {s: [] for s in walks}
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
            q, vp = case[0], case[2]
            widths = (q.shape[2], vp.shape[2], q.dtype)
            try:
                inst = mod.instance(*widths, q.shape[1])
            except TypeError:          # a tree before route 5: no heads
                inst = mod.instance(*widths)
            print(json.dumps(dict(tree=lab, shape=shape, instance=inst)),
                  flush=True)
        del first, out
    for shape, case in cases.items():
        for lab, mod in trees:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    mod.attention_in_range(*case)
                torch.cuda.synchronize()
            by = {}
            for e in prof.key_averages():
                kind = ("merge" if "merge_kernel" in e.key else "pass1"
                        if "decode" in e.key else None)
                if kind and e.device_time_total > 0:
                    by[kind] = by.get(kind, 0.0) \
                        + e.device_time_total / 20 / 1000
            print(json.dumps(dict(profile=lab, shape=shape, device_ms=by)),
                  flush=True)
    for rnd in range(args.rounds):
        order = trees if rnd % 2 == 0 else trees[::-1]
        for lab, mod in order:
            for shape, case in cases.items():
                reps, rounds = big.get(shape, (20, 7))
                ms = cs.device_ms(lambda: mod.attention_in_range(*case),
                                  reps, rounds)
                times[(lab, shape)].append(ms)
                print(json.dumps(dict(round=rnd, tree=lab, shape=shape,
                                      ms=ms)), flush=True)
        for shape in walks:
            plain[shape].append(cs.device_ms(
                lambda: trees[0][1].paged_decode_plain(*cases[shape]), 20, 7))
    route_ms, route_err = route_ab(trees[-1][1], ROUTE_AB, args.rounds, cs)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps(dict(
        card=card,
        median_ms={f"{lab} {s}": statistics.median(v)
                   for (lab, s), v in times.items()},
        max_abs_diff_from_first=diffs,
        plain_median_ms={s: statistics.median(v) for s, v in plain.items()},
        route_median_ms=route_ms, route_max_abs_err=route_err)))
    return 0


def route_ab(mod, routes, rounds: int, cs):
    """Each ``ROUTE_AB`` case at its two routes through
    ``mod.launch_instance``, the two in turns (a b b a) for ``rounds``
    rounds; returns the medians and each output's largest error against
    the plain version."""
    import torch
    types = {"fp32": torch.float32, "bf16": torch.bfloat16}
    times, errs = {}, {}
    for name, (B, H, d, dv, t, names) in routes.items():
        case = cs.decode_case(B, H, d, 64, 64, types[t], length=4096,
                              dv=dv)
        insts = [("lanes", mod.LANES_D, mod.LANES_DV) if r == "lanes"
                 else (r, d, dv) for r in names]
        plain = mod.paged_decode_plain(*case)
        for inst in insts:
            out = mod.launch_instance(*case, inst)
            errs[f"{inst[0]} {name}"] = cs.max_err(out, plain)
        del out, plain
        for rnd in range(rounds):
            for inst in (insts if rnd % 2 == 0 else insts[::-1]):
                ms = cs.device_ms(lambda: mod.launch_instance(*case, inst))
                times.setdefault(f"{inst[0]} {name}", []).append(ms)
                print(json.dumps(dict(round=rnd, route=inst[0], shape=name,
                                      ms=ms)), flush=True)
        del case
        torch.cuda.empty_cache()
    return ({k: statistics.median(v) for k, v in times.items()}, errs)


if __name__ == "__main__":
    sys.exit(main())
