#!/usr/bin/env python3
"""Time where a launch of the fused plane's kernels spends its time, on one
CUDA card.

    python3 tools/fused_variants.py

Each variant is the committed ``csrc/tac_fused.cu`` with a textual edit:
as built, or the step kernel stopped at one of its phases (at entry,
after the key table, after the probe, before the tail, after the tail's
pass over the lanes' ways, after its pass over the keys, after the first
tile's sort, before the write-back), or without the fence before the
ticket, or with one part of its tail changed (every lane with a way
sorted, not only those of repeated keys) or skipped (the sort, the run
walk, the write-back; their results are wrong, their times are the
point).  All are built with nvcc at once into ``build/fused_variants``
and launched back to back on the q5-like ``mixed`` batch of
``chip_smoke.fused_case`` (B 256, 1024 and 4096, V 1, kind ``sum``)
against directories of 2048 and 262,144 ways, each variant on a
workspace of its own; the admit kernel as built on a chunk of 64
records.  Each time is the median over rounds of CUDA
events around 200 launches queued behind a spin kernel, so the host's
launch cost is hidden.  Prints one JSON line a variant and shape; exits 1
without a card.
"""
from __future__ import annotations

import ctypes
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

OUT = ROOT / "build" / "fused_variants"
STOP = "  if (a.B >= 0) return;\n"
ENTRY = "  const int B = a.B, W = a.W, V = a.V;\n"
TABLE = "    mine = h;\n  }\n  __syncthreads();\n"
PROBE = "  // one block holds every way in its table"
TAIL = "  // ---- the tail"
LANES = "  if (!small) {                            // the keys past one"
KEYS = "  const float ident = "
SORT = "    const Key* const sorted = sm.tail.sorted[buf];"
MULTI = "        multi = vlast[first] != first;\n"
SORT_LOOP = "    for (int k = 2; k <= S && G > 1; k <<= 1) {"
WALK = ("      for (int q = s; q <= t; ++q)\n        if (sm.tail.upd[q]) {\n"
        "          has_upd = true;")
POST = "  for (int i = t; i < B; i += kThreads) {\n    const bool mine_last"
WRITE = "  sync_tail(T);                           // every row read"
FENCE = "    __threadfence();\n"
# name: edits of the source
VARIANTS = {
    "as built": [],
    "stop at entry": [(ENTRY, ENTRY + STOP)],
    "stop after the key table": [(TABLE, TABLE + STOP)],
    "stop after the probe": [(PROBE, STOP + PROBE)],
    "stop before the tail": [(TAIL, STOP + TAIL)],
    "stop after the lane pass": [(LANES, STOP + LANES)],
    "stop after the key pass": [(KEYS, STOP + KEYS)],
    "stop after the first sort": [(SORT, STOP + SORT)],
    "stop before the write-back": [(WRITE, STOP + WRITE)],
    "no fence": [(FENCE, "")],
    # the tail's parts, each skipped (results wrong, times right)
    "sort every lane": [(MULTI, "        multi = true;\n")],
    "no sort": [(SORT_LOOP, SORT_LOOP.replace("G > 1;", "G > 1 && B < 0;"))],
    "no run walk": [(WALK, WALK.replace("q <= t;", "q <= t && B < 0;"))],
    "no write-back": [(POST, POST.replace("i < B;", "i < B && B < 0;"))],
}


def build():
    from repro_torch.kernels import cuda_build
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        text = (cuda_build.CSRC / "tac_fused.cu").read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the source has no single "
                                   f"{old!r}")
            text = text.replace(old, new)
        path = OUT / f"v{i}.cu"
        path.write_text(text)
        cmd = [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o",
               str(OUT / f"libv{i}.so"), str(path)]
        procs[name] = (i, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    libs = {}
    for name, (i, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name}:\n{log}")
        lib = ctypes.CDLL(str(OUT / f"libv{i}.so"))
        lib.tac_fused_step.argtypes = [ctypes.c_void_p] * 13 \
            + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.tac_fused_admit.argtypes = [ctypes.c_void_p] * 11 \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        libs[name] = lib
    return libs


def events_ms(launch, reps: int = 200, rounds: int = 5) -> float:
    launch()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        torch.cuda._sleep(20_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            launch()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def main() -> int:
    if not torch.cuda.is_available():
        print("fused_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.tac_fused import tac_fused as tfk
    libs = build()
    stream = cuda_build.stream_ptr(torch.device("cuda"))
    V = 1
    for W, B in itertools.product((2048, cs.DEPLOY_SLOTS),
                                  (256, 1024, 4096)):
        state, pages, lanes, _ = cs.fused_case(W, B, V, "mixed")
        out = torch.empty(tfk.step_out_words(B, V), dtype=torch.int32,
                          device="cuda")
        ptrs = [t.data_ptr() for t in lanes] + [
            state.keys.data_ptr(), state.ts.data_ptr(),
            state.dirty.data_ptr(), pages.data_ptr(), out.data_ptr()]
        for name, lib in libs.items():
            n_ways, n_firsts, n_scratch = tfk.step_workspace_words(B, W, V)
            ws = [torch.full((max(n, 1),), tfk.INT32_MAX, dtype=torch.int32,
                             device="cuda") for n in (n_ways, n_firsts)]
            ws[0][0] = 0
            ws.append(torch.empty(max(n_scratch, 1), dtype=torch.int32,
                                  device="cuda"))
            args = ptrs + [t.data_ptr() for t in ws] + [B, W, V, 0, stream]
            row = {"kernel": "tac_fused_step", "variant": name, "W": W,
                   "B": B, "ms": events_ms(lambda: lib.tac_fused_step(*args))}
            if name == "as built":
                # the packed entry point as chip_smoke times it, and the
                # host's own time a call
                fields = tfk.step_in_fields(B, V)
                packed = torch.from_numpy(tfk.fill(
                    np.zeros(tfk.nbytes(fields), np.uint8), fields,
                    *(t.cpu().numpy() for t in lanes))).cuda()
                call = lambda: tfk.fused_step_packed(  # noqa: E731
                    state, pages, packed, B, "sum")
                row["packed_device_ms"] = cs.device_ms(call)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    call()
                row["packed_host_ms"] = (time.perf_counter() - t0) / 200 * 1e3
                torch.cuda.synchronize()
            print(json.dumps(row), flush=True)
        if B != 256:
            continue
        N = 64
        rng = np.random.default_rng(1)
        recs = [rng.choice(W, N, replace=False).astype(np.int32),
                rng.integers(0, 8 * W, N).astype(np.int32),
                rng.random(N).astype(np.float32),
                rng.standard_normal((N, V)).astype(np.float32),
                rng.random(N) < 0.7, rng.random(N) < 0.5]
        recs = [torch.from_numpy(a).cuda() for a in recs]
        victims = torch.empty((N, 1, V + 1), device="cuda")
        args = [t.data_ptr() for t in recs] + [
            state.keys.data_ptr(), state.ts.data_ptr(),
            state.dirty.data_ptr(), pages.data_ptr(), victims.data_ptr(),
            N, W, V, stream]
        ms = events_ms(lambda: libs["as built"].tac_fused_admit(*args))
        print(json.dumps({"kernel": "tac_fused_admit", "variant": "as built",
                          "W": W, "N": N, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
