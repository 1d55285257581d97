#!/usr/bin/env python3
"""Time K7's backward (the Mamba2 SSD scan's gradient,
``csrc/mamba2_scan_bwd.cu``) of several source trees in one process on one
CUDA card, at zamba2-2.7b's training shape (4 x 80 heads, S 2048, Q 128,
N = P = 64, bf16: ``chip_smoke.SCAN_BWD_TIMED``).

    python3 tools/scan_bwd_ab.py --src DIR:LABEL [--src DIR:LABEL ...]
        [--rounds N]

Each DIR is the root of a checkout (e.g. a parent commit unpacked with
``git archive`` into ``build/parent``, and ``.``): its
``repro_torch.kernels.mamba2_scan`` is imported under its own
``cuda_build`` and its kernels built into its own ``build/``.  Every
tree's wrapper runs on the same tensors (``chip_smoke.check_mamba_bwd``'s
draw, from a nonzero initial state with a gradient of the final state):
its forward with the states saved, then ``mamba2_scan_backward``, the
trees in turn for ``--rounds`` rounds (4 by default), every other round
in the opposite order (a, b, b, a, ...), so that a drift of the card
falls on both.  Each time is ``chip_smoke.device_ms`` of the backward
(CUDA events).  Prints one JSON line a (round, tree) and, last, one JSON
object of each tree's median, whether each tree's gradients are
bit-equal to the first tree's and their largest error of the first's
largest magnitude (held to ``chip_smoke.BWD_TOL``), each tree's device
ms a call by kernel (``torch.profiler``), its ptxas registers and spills
of the backward's kernels, and the card's name and power limit.  Exits
1 without a card, 2 when a tree's gradients pass the gate's tolerance.
"""
from __future__ import annotations

import argparse
import importlib
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def load_tree(root: Path):
    """(the scan's wrapper module, its cuda_build) of the checkout at
    ``root``, the backward built, imported apart from every other tree's."""
    for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    sys.path.insert(0, str(root / "src"))
    try:
        mod = importlib.import_module(
            "repro_torch.kernels.mamba2_scan.mamba2_scan")
        build = importlib.import_module("repro_torch.kernels.cuda_build")
        build.build_all(("mamba2_scan", "mamba2_scan_bwd"))
    finally:
        sys.path.remove(str(root / "src"))
    return mod, build


def kernel_times(call, reps: int = 5) -> dict:
    """Device ms a call of each CUDA kernel that ``call`` launches, the
    mean over ``reps`` calls under ``torch.profiler`` (after one warm
    call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "device_time_total", None)
        if us is None:
            us = ev.cuda_time_total
        if us > 0:
            m = re.search(r"::(\w+)", ev.key)
            name = m.group(1) if m else ev.key[:40]
            out[name] = out.get(name, 0.0) + us / 1e3 / reps
    return out


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
    import chip_smoke as cs              # this tree's draw, timer and gate
    trees = []
    for spec in args.src:
        d, label = spec.rsplit(":", 1)
        trees.append((label, *load_tree(Path(d).resolve())))
    B, S, H, G, N, P, Q = cs.SCAN_BWD_TIMED["zamba2-2.7b train"]
    dtype = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(0)
    x = cs.randn((B, S, H, P), dtype, g)
    dt = torch.nn.functional.softplus(cs.randn((B, S, H), torch.float32, g))
    A = -torch.exp(cs.randn((B * H,), torch.float32, g, 0.5))
    Bm = cs.randn((B, S, G, N), dtype, g)
    Cm = cs.randn((B, S, G, N), dtype, g)
    init = cs.randn((B, H, N, P), torch.float32, g, 0.3)
    dy = cs.randn((B, S, H, P), dtype, g)
    dstate = cs.randn((B, H, N, P), torch.float32, g, 0.3)
    args_ = (x, dt, A, Bm, Cm, Q)
    calls, first, agree = {}, None, {}
    for lab, mod, _ in trees:
        s_prev = mod._forward(*args_, init, True)[2]
        calls[lab] = (lambda m=mod, sp=s_prev: m.mamba2_scan_backward(
            *args_, sp, dy, dstate))
        grads = calls[lab]()
        torch.cuda.synchronize()
        if first is None:
            first = grads
        agree[lab] = dict(
            bit_equal=all(torch.equal(a, b) for a, b in zip(grads, first)),
            rel_err=cs.grads_rel(grads, first))
    del first, grads
    times = {lab: [] for lab, *_ in trees}
    for rnd in range(args.rounds):
        order = trees if rnd % 2 == 0 else trees[::-1]
        for lab, *_ in order:
            ms = cs.device_ms(calls[lab], reps=3, rounds=5)
            times[lab].append(ms)
            print(json.dumps(dict(round=rnd, tree=lab, ms=ms)), flush=True)
    kernel_ms = {lab: kernel_times(calls[lab]) for lab, *_ in trees}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    ptxas = {lab: {k: v for k, v in build.ptxas_report(
        "mamba2_scan_bwd").items() if "ssd_" in k}
        for lab, _, build in trees}
    tol = cs.BWD_TOL[dtype]
    print(json.dumps(dict(
        card=card, shape=dict(B=B, S=S, H=H, G=G, N=N, P=P, Q=Q,
                              dtype="bfloat16"),
        median_ms={lab: statistics.median(v) for lab, v in times.items()},
        kernel_ms=kernel_ms, against_first=agree, tol=tol, ptxas=ptxas)))
    return 0 if all(a["rel_err"] <= tol for a in agree.values()) else 2


if __name__ == "__main__":
    sys.exit(main())
