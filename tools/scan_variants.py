#!/usr/bin/env python3
"""Time design variants of the port's two scan kernels on one CUDA card.

    python3 tools/scan_variants.py

Each variant is the committed source of K7 (``csrc/mamba2_scan.cu``),
K7's backward (``csrc/mamba2_scan_bwd.cu``) or K8
(``csrc/rwkv6_scan.cu``) with a textual edit or another launch
parameter.  All are built with nvcc at once into ``build/scan_variants``
and timed at the models' prefill shapes, zamba2-2.7b (4 x 80 heads,
S 2048, Q 128, N = P = 64, bf16) and rwkv6-3b (4 x 40 heads, S 2048,
N 64, fp32), each held against its plain version by ``chip_smoke``'s
gate.  The backward's variants run through the package's wrapper with
the variant's library in place of the built one, and print each
gradient's error (dx, ddt, dA, dB, dC, dinit) of its largest magnitude
against the plain backward on fp32 copies of the same bf16 inputs, and
the gate's reading (``rel_err``, against the plain backward in the
inputs' type).  Prints one JSON line a variant; exits 1 without a card.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

OUT = ROOT / "build" / "scan_variants"
ONE_ROUNDING = [  # M, B^T and s_prev rounded to bf16 once, not hi + lo
    ("  lo = pack_bf16(a - f.x, b - f.y);", "  lo = 0u;"),
    ("__float2bfloat16(s - __bfloat162float(hi));", "__float2bfloat16(0.f);")]
# the backward's M and LG (an A operand of d dtx += M^T g, dB += LG^T C
# and dC += LG B) rounded to bf16 once and multiplied once, not as hi + lo
ML_ONCE = [(f"mma_split({acc}, ah, al,", f"mma_row({acc}, ah,")
           for acc in ("dC[q]", "dd[q]", "dB[q]")]
COLS = "constexpr int kCols = 4;"
ROWS = "  return N < 16 ? N : 16;"
STEPS = "constexpr int kStep = 32;"
# name: (source, edits, launch parameter: heads for K7, cols for K8)
VARIANTS = {
    "k7 as built": ("mamba2_scan", [], None),
    "k7 8 heads a block": ("mamba2_scan", [], 8),
    "k7 16 heads a block": ("mamba2_scan", [], 16),
    "k7 one bf16 rounding": ("mamba2_scan", ONE_ROUNDING, None),
    "k7 bwd as built": ("mamba2_scan_bwd", [], None),
    "k7 bwd one rounding of M and LG": ("mamba2_scan_bwd", ML_ONCE, None),
    "k8 as built": ("rwkv6_scan", [], None),
    "k8 tile of 32 columns": ("rwkv6_scan", [], 32),
    "k8 16 steps a buffer": ("rwkv6_scan",
                             [(STEPS, STEPS.replace("32", "16"))], None),
    "k8 1 column a thread": ("rwkv6_scan",
                             [(COLS, COLS.replace("4", "1"))], None),
    "k8 2 columns a thread": ("rwkv6_scan",
                              [(COLS, COLS.replace("4", "2"))], None),
    "k8 8 rows a lane": ("rwkv6_scan",
                         [(ROWS, "  return N < 8 ? N : 8;")], None),
}


def build():
    from repro_torch.kernels import cuda_build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, (src, edits, _)) in enumerate(VARIANTS.items()):
        text = (cuda_build.CSRC / f"{src}.cu").read_text()
        inc = '#include "ssd_tc.cuh"'   # K7's shared pieces, edited in place
        text = text.replace(inc, (cuda_build.CSRC / "ssd_tc.cuh").read_text())
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the source has no {old!r}")
            text = text.replace(old, new)
        path = OUT / f"v{i}.cu"
        path.write_text(text)
        cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS,
               "-I", str(cuda_build.CSRC), "-o", str(OUT / f"libv{i}.so"),
               str(path)]
        procs[name] = (i, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for name, (i, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(OUT / f"libv{i}.so"))
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as c
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.mamba2_scan import mamba2_scan as ms
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan as rs
    libs = build()
    g = torch.Generator(device="cuda").manual_seed(0)
    B, S, H, P, N, Q = 4, 2048, 80, 64, 64, 128
    x = c.randn((B, S, H, P), torch.bfloat16, g)
    dt = torch.nn.functional.softplus(c.randn((B, S, H), torch.float32, g))
    A = -torch.exp(c.randn((B * H,), torch.float32, g, 0.5))
    Bm = c.randn((B, S, 1, N), torch.bfloat16, g)
    Cm = c.randn((B, S, 1, N), torch.bfloat16, g)
    py, pst = ms.mamba2_scan_plain(x, dt, A, Bm, Cm, Q)
    pl = ms.plan(B, S, H, 1, N, P, Q, *ms.card_slots(Q, N, P, x.device))
    nc = pl["chunks"]
    scratch = [torch.empty((B, nc, H, N, P), device="cuda"),
               torch.empty((B, nc, H, 2, N, P), dtype=torch.bfloat16,
                           device="cuda"),
               torch.empty((B, nc, H), device="cuda")]
    y, st = torch.empty_like(x), torch.empty((B, H, N, P), device="cuda")
    R, K = (4, 2048, 40, 64), 40
    r, v = c.randn(R, torch.float32, g), c.randn(R, torch.float32, g)
    k = c.randn(R, torch.float32, g, 0.3)
    w = torch.sigmoid(c.randn(R, torch.float32, g))
    u = c.randn((4 * K, 64), torch.float32, g, 0.1)
    s0 = c.randn((4, K, 64, 64), torch.float32, g, 0.1)
    ry, rst = rs.rwkv6_scan_plain(r[:1], k[:1], v[:1], w[:1], u[:K], s0[:1])
    y8, st8 = torch.empty_like(r), torch.empty_like(s0)
    stream = cuda_build.stream_ptr(x.device)
    # K7's backward at zamba2's training shape, from the forward's states
    dy = c.randn((B, S, H, P), torch.bfloat16, g)
    dstate = c.randn((B, H, N, P), torch.float32, g, 0.3)
    bargs = (x, dt, A, Bm, Cm, Q, ms._forward(x, dt, A, Bm, Cm, Q, None,
                                              True)[2], dy, dstate)
    gate = ms.mamba2_scan_backward_plain(x, dt, A, Bm, Cm, Q, None, dy,
                                         dstate)
    fine = ms.mamba2_scan_backward_plain(x.float(), dt, A, Bm.float(),
                                         Cm.float(), Q, None, dy.float(),
                                         dstate)
    for name, lib in libs.items():
        src, _, param = VARIANTS[name]
        if src == "mamba2_scan_bwd":
            built = cuda_build.load(src)
            cuda_build._LIBS[src] = lib
            try:
                grads = ms.mamba2_scan_backward(*bargs)
                torch.cuda.synchronize()
                row = dict(variant=name, ms=c.device_ms(
                    lambda: ms.mamba2_scan_backward(*bargs), reps=3,
                    rounds=5), rel_err=c.grads_rel(grads, gate),
                    rel_by_grad=[c.max_err(a, b) / float(b.abs().max())
                                 for a, b in zip(grads, fine)],
                    heads=ms.bwd_heads(x, Bm, Q))
            finally:
                cuda_build._LIBS[src] = built
            print(json.dumps(row), flush=True)
            continue
        if src == "mamba2_scan":
            fn = lib.mamba2_scan
            fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 \
                + [ctypes.c_void_p]
            heads = param or pl["heads"]
            ptrs = [t.data_ptr() for t in (x, dt, A, Bm, Cm)] + [0] \
                + [t.data_ptr() for t in [y, st] + scratch]
            call = lambda: fn(*ptrs, B, S, H, 1, N, P, Q, heads, 1,  # noqa
                              stream)
            out = [(y, py), (st, pst)]
            tol, extra = 2e-2, dict(heads=heads)
        else:
            fn = lib.rwkv6_scan
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 \
                + [ctypes.c_void_p]
            cols = param or rs.plan_columns(4 * K, 64, torch.cuda.
                                            get_device_properties(0).
                                            multi_processor_count)
            ptrs = [t.data_ptr() for t in (r, k, v, w, u, s0, y8, st8)] \
                + [0]                  # no saved states: the serving kernel
            call = lambda: fn(*ptrs, 4, 2048, K, 64, cols, 0, stream)  # noqa
            out = [(y8[:1], ry), (st8[:1], rst)]
            tol, extra = 2e-5, dict(cols=cols)
        err = call()
        torch.cuda.synchronize()
        print(json.dumps(dict(
            variant=name, error=err, ms=c.device_ms(call, reps=5, rounds=5),
            agrees=all(c.scan_agrees(a, b, tol) for a, b in out),
            y_errors=c.scan_errors(*out[0]), **extra)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
