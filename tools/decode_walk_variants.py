#!/usr/bin/env python3
"""Build edits of K5's walks (``decode_walk_tc_kernel``, route 4, and
``decode_walk_kernel``, route 3) and of its wgmma route
(``decode_wgmma_kernel``, route 5) in
``src/repro_torch/csrc/decode_attention.cu`` side by side and time them
in turns in one process on one CUDA card, each against the plain version.

    python3 tools/decode_walk_variants.py [VARIANT ...] [--rounds N]

The variants (all by default): ``as built``; of the tensor-core walk,
``no L2 prefetch`` (plain 16-byte cp.async), ``one block an SM`` (no
second block's launch bound), ``4 stages`` (a ring of 4 entries),
``loads only`` (the ring filled, no product), ``compute only`` (the
products on whatever the ring holds, no copy); of the TF32 walk, ``walk:
one block an SM`` (a block's whole shared memory, Q resident where it
fits), ``walk: bf16 6 stages`` (Q resident at (1001, 1000)), ``walk:
loads only``, ``walk: compute only``; of the wgmma route, ``wg: 16
splits`` and ``wg: 4 splits`` (the wrapper's split count, 8 at MLA's
latent, replaced), ``wg: no L2 prefetch``, ``wg: no proxy fence`` (the
consumers' fence between a stage's copies and its products dropped),
``wg: one wait for S`` (a tile's score products issued together, their
stages released after one wait), ``wg: two score chains`` (as that, d's
even and odd boxes summed into two accumulators, added after),
``wg: loads only`` (the products skipped), ``wg: compute only``
(every copy zero-filled, nothing read) and ``wg: no copies`` (the
producer only arrives on each stage).  Loads only and compute only give
wrong outputs and are timed only.  Each source is built with ``nvcc``
into ``build/decode_walk_variants`` and loaded in place of the wrapper's
library.  Shapes: the tensor-core walk's variants at (1024, 1024) with 8
rows of 16 heads over 4096 tokens (``chip_smoke.WIDE_TIMED``), (4096,
4096) with 2 rows of 16 heads over 1024 tokens, (640, 512) with 32 rows
of 16 heads over 1024 tokens, bf16; the TF32 walk's at (1024, 1024) fp32
and (1001, 1000) bf16 with 8 rows of 16 heads over 4096 tokens; pages of
16; the wgmma route's at MLA's latent, 8 rows of 128 heads at (576, 512)
over 4096 tokens in pages of 64, bf16; ``as built`` at all six.
Prints one JSON line a variant (registers, spills), a (variant, shape)
check (agreement, bit-equal to ``as built``), a (variant, shape) profile
(device ms of pass 1 and of the merge from ``torch.profiler``), then one
object of each median ms (CUDA events, ``chip_smoke.device_ms``,
``--rounds`` rounds in turns, every other round reversed), the bounds
and the card's name and power limit.
Exits 1 without a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "src"))
OUT = HERE / "build" / "decode_walk_variants"
KERNELS = {"walk_tc": "decode_walk_tc_kernel(const",
           "walk": "decode_walk_kernel(const T*",
           "wg": "decode_wgmma_kernel(const"}


def _in_kernel(src: str, old: str, new: str, kernel="walk_tc") -> str:
    """``old`` -> ``new`` within one walk kernel's body only (up to the
    next pass's comment)."""
    a = src.index(KERNELS[kernel])
    b = src.index("// Pass ", a)
    assert old in src[a:b], old
    return src[:a] + src[a:b].replace(old, new) + src[b:]


def _in_walk(old: str, new: str):
    return lambda s: _in_kernel(s, old, new, "walk")


def _swap(old: str, new: str):
    def edit(src: str) -> str:
        assert old in src, old
        return src.replace(old, new)
    return edit


VARIANTS = {
    "as built": [],
    "no L2 prefetch": [lambda s: _in_kernel(s, "cp_async16_l2(",
                                            "cp_async16(")],
    "one block an SM": [_swap("__launch_bounds__(kWtThreads, 2)",
                              "__launch_bounds__(kWtThreads)")],
    "4 stages": [_swap("constexpr int kWtStages = 8;",
                       "constexpr int kWtStages = 4;")],
    "loads only": [lambda s: _in_kernel(
        _in_kernel(s, "for (int kk = 0; kk < kWtChunk / 16; kk += 2) {",
                   "for (int kk = 0; kk < kWtChunk / 16; kk += 2) "
                   "if (inv_scale > 1e30f) {"),
        "for (int half = 0; half < 2; ++half) {",
        "for (int half = 0; half < 2; ++half) if (inv_scale > 1e30f) {")],
    "compute only": [lambda s: _in_kernel(
        s, "if (is_tile < n_tiles) {",
        "if (is_tile < n_tiles && inv_scale > 1e30f) {")],
}
VARIANTS.update({
    "walk: one block an SM": [
        _swap("__launch_bounds__(kWkThreads, 2)",
              "__launch_bounds__(kWkThreads, 1)"),
        _swap("constexpr int kWkBlockSmem = 115712;",
              "constexpr int kWkBlockSmem = 232448;")],
    "walk: bf16 6 stages": [_swap(
        "static constexpr int kStages = 8, kKPitch = 72",
        "static constexpr int kStages = 6, kKPitch = 72")],
    "walk: loads only": [
        _in_walk("for (int k0 = 0; k0 < kWkChunk; k0 += 8) {",
                 "for (int k0 = 0; k0 < kWkChunk; k0 += 8) "
                 "if (inv_scale > 1e30f) {"),
        _in_walk("for (int kk = 0; kk < kWkTile / 8; ++kk) {\n"
                 "        const uint4 h4",
                 "for (int kk = 0; kk < kWkTile / 8; ++kk) "
                 "if (inv_scale > 1e30f) {\n        const uint4 h4")],
    "walk: compute only": [_in_walk(
        "if (is_tile < n_tiles) {",
        "if (is_tile < n_tiles && inv_scale > 1e30f) {")],
})
VARIANTS.update({
    "wg: 16 splits": [],
    "wg: 4 splits": [],
    "wg: no L2 prefetch": [_swap(
        "      cp_async16_l2(dst + (r0 + 16 * k) * 128,",
        "      cp_async16(dst + (r0 + 16 * k) * 128,")],
    "wg: no proxy fence": [_swap(
        "    mbar_wait(&full[a.y], a.x & 1);\n    fence_proxy_async();",
        "    mbar_wait(&full[a.y], a.x & 1);")],
    "wg: loads only": [
        lambda s: _in_kernel(s, "wg_box_scores(x, q_s",
                             "if (inv_scale > 1e30f) wg_box_scores(x, q_s",
                             "wg"),
        lambda s: _in_kernel(s, "wg_box_sum(o[c], a, ring.box(my));",
                             "if (inv_scale > 1e30f) "
                             "wg_box_sum(o[c], a, ring.box(my));", "wg")],
    "wg: one wait for S": [lambda s: _in_kernel(s, """      if (j > 0) {
        wgmma_wait<1>();
        ring.release(base + j - 1);
      }
    }
    wgmma_wait<0>();
    fence_acc(x);
    ring.release(base + na - 1);""", """    }
    wgmma_wait<0>();
    fence_acc(x);
    for (int j = 0; j < na; ++j) ring.release(base + j);""", "wg")],
    "wg: two score chains": [lambda s: _in_kernel(s, """    float x[32];
    for (int j = 0; j < na; ++j) {
      ring.wait(base + j);
      wg_box_scores(x, q_s + j * kWgBox, ring.box(base + j), j > 0);
      if (j > 0) {
        wgmma_wait<1>();
        ring.release(base + j - 1);
      }
    }
    wgmma_wait<0>();
    fence_acc(x);
    ring.release(base + na - 1);""", """    float x[32], y[32];
    for (int j = 0; j < na; j += 2) {
      ring.wait(base + j);
      wg_box_scores(x, q_s + j * kWgBox, ring.box(base + j), j > 0);
      if (j + 1 < na) {
        ring.wait(base + j + 1);
        wg_box_scores(y, q_s + (j + 1) * kWgBox, ring.box(base + j + 1),
                      j > 0);
      }
    }
    wgmma_wait<0>();
    fence_acc(x);
    fence_acc(y);
    for (int j = 0; j < na; ++j) ring.release(base + j);
    if (na > 1) {
#pragma unroll
      for (int v = 0; v < 32; ++v) x[v] += y[v];
    }""", "wg")],
    "wg: no copies": [_swap(
        "    for (int k = 0; k < 4; ++k) {\n"
        "      const bool ok = tok[k] >= 0 && col < width;",
        "    for (int k = 0; k < 4 * (width < 0); ++k) {\n"
        "      const bool ok = tok[k] >= 0 && col < width;")],
    "wg: compute only": [_swap(
        "src + (ok ? (int64_t)tok[k] * width + col : 0),\n"
        "                    ok ? 16 : 0);", "src, 0);")],
})
SPLITS = {"wg: 16 splits": 16, "wg: 4 splits": 4}  # the wrapper's, replaced
TIMED_ONLY = ("loads only", "compute only", "walk: loads only",
              "walk: compute only", "wg: loads only", "wg: compute only",
              "wg: no copies")


def build(names, csrc: Path):
    """Each variant's library (``None`` where nvcc failed) and facts."""
    from repro_torch.kernels import cuda_build
    OUT.mkdir(parents=True, exist_ok=True)
    base = (csrc / "decode_attention.cu").read_text()
    procs = {}
    for name in names:
        src = base
        for edit in VARIANTS[name]:
            src = edit(src)
        stem = re.sub(r"\W+", "_", name)
        path = OUT / f"{stem}.cu"
        path.write_text(src)
        procs[name] = (OUT / f"lib{stem}.so", subprocess.Popen(
            [cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-I", str(csrc),
             "-o", str(OUT / f"lib{stem}.so"), str(path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        facts, fn = {}, None
        for line in log.splitlines():
            m = re.search(r"(?:Compiling entry function '|Function "
                          r"properties for )([\w$.]+)", line)
            if m:
                fn = m.group(1)
            if fn and ("decode_walk" in fn or "decode_wgmma" in fn):
                kind = ("walk_tc" if "walk_tc" in fn else "wgmma"
                        if "wgmma" in fn else "walk fp32"
                        if "kernelIf" in fn else "walk bf16")
                for key, pat in (("registers", r"Used (\d+) registers"),
                                 ("spill_stores", r"(\d+) bytes spill st")):
                    m = re.search(pat, line)
                    if m:
                        facts[f"{kind} {key}"] = int(m.group(1))
        print(json.dumps(dict(variant=name, rc=proc.returncode, **facts,
                              log=log[-1500:] if proc.returncode else "")),
              flush=True)
        if proc.returncode == 0:
            libs[name] = ctypes.CDLL(str(lib))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*", default=list(VARIANTS))
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.decode_attention import decode_attention as da
    from torch.profiler import ProfilerActivity, profile
    libs = build(args.variants, cuda_build.CSRC)

    splits_for = da.splits_for

    def use(name):
        cuda_build._LIBS["decode_attention"] = libs[name]
        da._PLANS.clear()
        da.splits_for = (splits_for if name not in SPLITS
                         else lambda *a, **k: SPLITS[name])

    bf16, fp32 = torch.bfloat16, torch.float32
    shapes = {"(1024, 1024)": cs.decode_case(8, 16, 1024, 16, 256, bf16,
                                             length=4096, dv=1024),
              "(4096, 4096)": cs.decode_case(2, 16, 4096, 16, 64, bf16,
                                             length=1024, dv=4096),
              "(640, 512)": cs.decode_case(32, 16, 640, 16, 64, bf16,
                                           length=1024, dv=512),
              "(1024, 1024) fp32": cs.decode_case(8, 16, 1024, 16, 256,
                                                  fp32, length=4096,
                                                  dv=1024),
              "(1001, 1000) bf16": cs.decode_case(8, 16, 1001, 16, 256,
                                                  bf16, length=4096,
                                                  dv=1000),
              "MLA latent": cs.decode_case(8, 128, 576, 64, 64, bf16,
                                           length=4096, dv=512)}
    walk_shapes = ("(1024, 1024) fp32", "(1001, 1000) bf16")
    wg_shapes = ("MLA latent",)
    plain = {k: da.paged_decode_plain(*a) for k, a in shapes.items()}
    names = list(libs)
    first = {}

    def shapes_of(name):
        kind = name.split(":")[0] if ":" in name else "walk_tc"
        return [k for k in shapes if name == "as built" or kind == (
            "walk" if k in walk_shapes else "wg" if k in wg_shapes
            else "walk_tc")]
    for name in names:
        use(name)
        for shape in shapes_of(name):
            a = shapes[shape]
            out = da.attention_in_range(*a)
            again = da.attention_in_range(*a)
            torch.cuda.synchronize()
            row = dict(variant=name, shape=shape,
                       splits=da.splits_for(a[0], a[3].shape[1],
                                            a[2].shape[2]),
                       plan=da.launch_plan(a[0].shape[2], a[2].shape[2],
                                           a[0].shape[1], a[0].dtype))
            if name not in TIMED_ONLY:
                first.setdefault(shape, out)
                row.update(agrees=cs.decode_agrees(
                               out, plain[shape], cs.TOL[a[0].dtype]),
                           max_abs_err=cs.max_err(out, plain[shape]),
                           bit_equal_rerun=bool(torch.equal(out, again)),
                           bit_equal_as_built=bool(torch.equal(
                               out, first[shape])))
            print(json.dumps(row), flush=True)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    da.attention_in_range(*a)
                torch.cuda.synchronize()
            by = {}
            for e in prof.key_averages():
                kind = ("merge" if "merge_kernel" in e.key else "pass1"
                        if "decode_w" in e.key else None)
                if kind:
                    by[kind] = by.get(kind, 0.0) \
                        + e.device_time_total / 10 / 1000
            print(json.dumps(dict(profile=name, shape=shape,
                                  device_ms=by)), flush=True)
    times = {}
    for rnd in range(args.rounds):
        for name in (names if rnd % 2 == 0 else names[::-1]):
            use(name)
            for shape in shapes_of(name):
                a = shapes[shape]
                times.setdefault(f"{name} {shape}", []).append(
                    cs.device_ms(lambda: da.attention_in_range(*a)))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps(dict(
        median_ms={k: statistics.median(v) for k, v in times.items()},
        bound_ms={k: cs.decode_bound(a[0], a[4], a[3].shape[1],
                                     a[1].shape[1], a[2].shape[2])[0]
                  for k, a in shapes.items()},
        plain_ms={k: cs.device_ms(lambda: da.paged_decode_plain(
            *shapes[k])) for k in walk_shapes + wg_shapes},
        card=card)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
