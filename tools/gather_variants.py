#!/usr/bin/env python3
"""Time K2's page gather against its variants, on one CUDA card.

    python3 tools/gather_variants.py

Builds ``csrc/page_gather.cu`` with two more gathers appended into
``build/gather_variants``: the earlier design (one 128-thread block
a row, each thread walking its row's units one after another) and a TMA
variant (a block per (row, chunk) whose one thread moves the chunk with
``cp.async.bulk`` global -> shared on an ``mbarrier``, then shared ->
global as a bulk group), the latter with the planner's chunks and with
16 KB chunks.  At each of ``chip_smoke.gather_shapes()`` in fp32, every
variant must equal the plain gather bit for bit; then each is timed as
``chip_smoke.py`` times K2 (``rotating_ms``: back to back over the
disjoint ``slot_sets`` of the pool), beside ``torch.index_select`` and an
empty launch, in one order and then the reverse.  Prints one JSON line a
shape; exits 1 without a card.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

OUT = ROOT / "build" / "gather_variants"
VARIANTS_CU = r'''
namespace variants {

// the earlier design: one block a row
template <typename U>
__global__ void __launch_bounds__(128)
one_block_a_row(const int32_t* __restrict__ slots, const U* __restrict__ pages,
                U* __restrict__ out, int n_slots, int64_t row_units) {
  const int i = blockIdx.x;
  const int32_t s = slots[i];
  U* dst = out + (int64_t)i * row_units;
  if (s < 0 || s >= n_slots) {
    const U zero{};
    for (int64_t j = threadIdx.x; j < row_units; j += 128) dst[j] = zero;
    return;
  }
  const U* src = pages + (int64_t)s * row_units;
  for (int64_t j = threadIdx.x; j < row_units; j += 128) dst[j] = src[j];
}

constexpr int kBulkUnits = 1024;      // 16 KB of shared memory

// TMA: one thread moves a (row, chunk) through shared memory
__global__ void __launch_bounds__(32)
bulk_chunks(const int32_t* __restrict__ slots, const uint4* __restrict__ pages,
            uint4* __restrict__ out, int n_slots, int64_t row_units,
            int chunk_units, int n_chunks) {
  __shared__ __align__(128) uint4 buf[kBulkUnits];
  __shared__ __align__(8) uint64_t bar;
  const int i = blockIdx.x / n_chunks;
  const int64_t lo = (int64_t)(blockIdx.x - i * n_chunks) * chunk_units;
  const int64_t hi = min(lo + chunk_units, row_units);
  const int32_t s = slots[i];
  uint4* dst = out + (int64_t)i * row_units + lo;
  if (s < 0 || s >= n_slots) {
    for (int64_t u = threadIdx.x; u < hi - lo; u += blockDim.x)
      dst[u] = make_uint4(0, 0, 0, 0);
    return;
  }
  if (threadIdx.x != 0) return;
  const uint4* src = pages + (int64_t)s * row_units + lo;
  const uint32_t bytes = (uint32_t)(hi - lo) * 16u;
  const uint32_t b = (uint32_t)__cvta_generic_to_shared(&bar);
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(buf);
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(b) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(b), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];"
               :: "r"(d), "l"(src), "r"(bytes), "r"(b) : "memory");
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins > (1u << 20)) __trap();       // a lost transfer ends the launch
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                 " selp.u32 %0, 1, 0, p;\n}"
                 : "=r"(done) : "r"(b) : "memory");
  }
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(d), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

}  // namespace variants

extern "C" {

int gather_one_block_a_row(const void* slots, const void* pages, void* out,
                           int n, int n_slots, long long row_bytes, int unit,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define ROWS(U) variants::one_block_a_row<U><<<n, 128, 0, st>>>( \
    (const int32_t*)slots, (const U*)pages, (U*)out, n_slots,   \
    row_bytes / (int64_t)sizeof(U))
  switch (unit) {
    case 16: ROWS(uint4); break;
    case 8: ROWS(uint2); break;
    case 4: ROWS(uint32_t); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef ROWS
  return (int)cudaGetLastError();
}

int gather_bulk(const void* slots, const void* pages, void* out, int n,
                int n_slots, long long row_bytes, int chunk_units,
                void* stream) {
  const int64_t row_units = row_bytes / 16;
  if (row_bytes % 16 || chunk_units <= 0
      || chunk_units > variants::kBulkUnits)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (int)((row_units + chunk_units - 1) / chunk_units);
  variants::bulk_chunks<<<n * n_chunks, 32, 0, (cudaStream_t)stream>>>(
      (const int32_t*)slots, (const uint4*)pages, (uint4*)out, n_slots,
      row_units, chunk_units, n_chunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
'''


def build() -> ctypes.CDLL:
    from repro_torch.kernels import cuda_build
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "gather_variants.cu"
    src.write_text((cuda_build.CSRC / "page_gather.cu").read_text()
                   + VARIANTS_CU)
    lib_path = OUT / "libgather_variants.so"
    proc = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                           str(lib_path), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc gather_variants:\n{proc.stdout}"
                           f"{proc.stderr}")
    print(json.dumps({"build": [ln.strip() for ln in proc.stdout.splitlines()
                                + proc.stderr.splitlines()
                                if "registers" in ln or "spill" in ln]}),
          flush=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.gather_one_block_a_row.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 2 + [ctypes.c_longlong, ctypes.c_int,
                             ctypes.c_void_p]
    lib.gather_bulk.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 \
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("gather_variants: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.page_gather import page_gather as pg
    lib = build()
    stream = cuda_build.stream_ptr(torch.device("cuda"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, (n_slots, page, d, N) in cs.gather_shapes().items():
        _, pages, _ = cs.page_case(n_slots, page, d, N, torch.float32)
        sets = cs.slot_sets(n_slots, N)
        lsets = [x.long() for x in sets]
        row_bytes = page * d * 4
        want = pg.page_gather_plain(sets[0], pages)
        unit = pg.copy_unit(row_bytes, pages, want)
        row_units = row_bytes // unit
        plan = pg.plan_gather(N, row_bytes, unit, sms)

        def raw(fn, *extra):
            def call(slots):
                out = torch.empty_like(want)
                cuda_build.check(fn(slots.data_ptr(), pages.data_ptr(),
                                    out.data_ptr(), N, n_slots, row_bytes,
                                    *extra, stream), "gather variant")
                return out
            return call

        calls = {"unrolled (as built)": lambda x: pg.gather_in_range(x,
                                                                     pages),
                 "one block a row (earlier)": raw(lib.gather_one_block_a_row,
                                                unit)}
        if unit == 16:
            calls["bulk, planner chunks"] = raw(lib.gather_bulk,
                                                plan.chunk_units)
            calls["bulk, 16 KB chunks"] = raw(lib.gather_bulk,
                                              min(1024, row_units))
        for name, call in calls.items():
            if not torch.equal(call(sets[0]), want):
                raise AssertionError(f"gather variant {name!r} differs at "
                                     f"{label}")
        calls["index_select"] = lambda x: torch.index_select(pages, 0, x)
        calls["empty launch"] = lambda x: torch.cuda._sleep(0)
        times = {name: [] for name in calls}
        for order in (list(calls), list(reversed(calls))):
            for name in order:
                times[name].append(cs.rotating_ms(
                    calls[name], lsets if name == "index_select" else sets))
        print(json.dumps({
            "shape": label, "n_slots": n_slots, "page": page, "d": d, "N": N,
            "row_bytes": row_bytes, "unit": unit, "plan": plan._asdict(),
            "slot_sets": len(sets),
            "bound_ms": cs.bound(N * 4 + 2 * N * row_bytes)[0],
            "ms": {k: statistics.fmean(v) for k, v in times.items()},
            "ms_each_order": times}), flush=True)
        del pages
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
