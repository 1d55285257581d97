#!/usr/bin/env python3
"""Time builds of K6's backward against each other, on one CUDA card.

    python3 tools/flash_bwd_variants.py [--csrc DIR:LABEL ...]

Each ``--csrc`` names a directory holding a ``flash_attention_bwd.cu``
(and the headers it includes) and a label; the default is the checkout's
own ``src/repro_torch/csrc`` labelled ``as built``.  Each source is built
into ``build/flash_bwd_variants/<label>`` and called through its plain C
entry point ``flash_attention_bwd`` (dK/dV and dQ from the forward
kernel's lse and D = rowsum(dO o)) at the training shapes of
``chip_smoke.BWD_TIMED``, bf16, causal.  Every build must agree with the
first one (the largest difference over the first's largest magnitude, at
most 2e-2), and two calls of each (into outputs filled with NaN) must be
bit-equal.  Each is timed as ``chip_smoke.py`` times the backward
(``device_ms``), in the order given
and then in the reverse order, and one call is profiled for each
kernel's device time by name; SDPA's backward on the same tensors is
timed once as the yardstick.  Prints one JSON line a shape (and the ptxas
facts of each build); exits 1 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

OUT = ROOT / "build" / "flash_bwd_variants"


def build(csrc: Path, label: str) -> ctypes.CDLL:
    from repro_torch.kernels import cuda_build
    out = OUT / label.replace(" ", "_")
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / "libflash_attention_bwd.so"
    proc = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                           str(lib_path), str(csrc / "flash_attention_bwd.cu")],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {csrc}/flash_attention_bwd.cu:\n{log}")
    print(json.dumps({"build": label, "ptxas": [
        ln.strip() for ln in log.splitlines()
        if "registers" in ln or "spill" in ln or "Compiling" in ln]}),
        flush=True)
    lib = ctypes.CDLL(str(lib_path))
    # a source whose kernels take the scale as an argument (after causal)
    lib.takes_scale = "int causal, float scale" in (
        csrc / "flash_attention_bwd.cu").read_text()
    lib.flash_attention_bwd.argtypes = [ctypes.c_void_p] * 9 \
        + [ctypes.c_int] * 8 + [ctypes.c_float] * lib.takes_scale \
        + [ctypes.c_int, ctypes.c_void_p]
    lib.flash_attention_bwd.restype = ctypes.c_int
    return lib


def kernel_ms(call, reps: int = 3) -> dict:
    """Device ms of one call by kernel name, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    out: dict = {}
    for e in prof.events():
        if e.device_type == cuda and e.name != "Command Buffer Full":
            m = re.search(r"(\w+_kernel)\w*(<[^>]*>)?", e.name)
            name = m.group(0) if m else e.name[:80]
            out[name] = out.get(name, 0.0) \
                + (e.time_range.end - e.time_range.start) / 1e3 / reps
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", action="append", default=[],
                    help="DIR:LABEL, a directory with flash_attention_bwd.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.flash_attention import flash_attention as fa
    specs = [s.rsplit(":", 1) for s in args.csrc] \
        or [[str(cuda_build.CSRC), "as built"]]
    libs = {label: build(Path(d).resolve(), label) for d, label in specs}
    stream = cuda_build.stream_ptr(torch.device("cuda"))
    for label, c in cs.BWD_TIMED.items():
        B, S, H, KV, d, dv = (c[k] for k in ("B", "S", "H", "KV", "d", "dv"))
        g = torch.Generator(device="cuda").manual_seed(0)
        dt = torch.bfloat16
        q = cs.randn((B, S, H, d), dt, g)
        k = cs.randn((B, S, KV, d), dt, g)
        v = cs.randn((B, S, KV, dv), dt, g)
        dout = cs.randn((B, S, H, dv), dt, g)
        out, lse = fa._forward(q, k, v, True, True)
        delta = (out.float() * dout.float()).sum(-1).transpose(1, 2) \
            .contiguous()

        def call_of(lib, fill=None):
            def call():
                grads = [torch.empty_like(t) if fill is None
                         else torch.full_like(t, fill) for t in (q, k, v)]
                cuda_build.check(lib.flash_attention_bwd(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                    lse.data_ptr(), delta.data_ptr(),
                    *(t.data_ptr() for t in grads), B, S, S, H, KV, d, dv, 1,
                    *[1 / math.sqrt(d)] * lib.takes_scale, 1, stream),
                    "flash_attention_bwd variant")
                return grads
            return call

        calls = {name: call_of(lib) for name, lib in libs.items()}
        first = None
        row = {"shape": label, **c, "agrees": {}, "bit_equal": {}}
        for name, lib in libs.items():
            # outputs filled with NaN first: a gradient left unwritten fails
            a, b = call_of(lib, math.nan)(), call_of(lib, math.nan)()
            torch.cuda.synchronize()
            row["bit_equal"][name] = all(torch.equal(x, y)
                                         for x, y in zip(a, b))
            if first is None:
                first = a
            rel = max(cs.max_err(x, y) / (float(y.float().abs().max())
                                          + 1e-30) for x, y in zip(a, first))
            row["agrees"][name] = rel
            if not rel <= 2e-2 or not row["bit_equal"][name]:
                raise AssertionError(f"variant {name!r} at {label}: {row}")
            del a, b
        times = {name: [] for name in calls}
        for order in (list(calls), list(reversed(calls))):
            for name in order:
                times[name].append(cs.device_ms(calls[name], reps=3,
                                                rounds=5))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        leaves = [t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v)]
        o_lib = sdpa(*leaves, is_causal=True, enable_gqa=KV != H)
        do_lib = dout.transpose(1, 2)
        flops = 2.5 * 2 * S * S * (d + dv) * B * H / 2
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + out.numel()) * 2 \
            + 4 * lse.numel()
        row.update(
            ms={n: statistics.fmean(t) for n, t in times.items()},
            ms_each_order=times,
            kernel_ms={n: kernel_ms(call) for n, call in calls.items()},
            library_ms=cs.device_ms(lambda: torch.autograd.grad(
                o_lib, leaves, do_lib, retain_graph=True), reps=3, rounds=5),
            bound_ms=cs.bound(nbytes, ops=flops, peak=cs.BF16_OPS_PER_S)[0])
        print(json.dumps(row), flush=True)
        del o_lib, leaves, q, k, v, dout, out, lse, delta, first
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
