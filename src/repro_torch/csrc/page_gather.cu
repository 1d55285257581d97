// Slot-indirect page gather and in-place page scatter for Hopper (sm_90a),
// plain C interface.
//
// Replaces: src/repro/kernels/page_gather/page_gather.py:page_gather_kernel
// (out[i] = pages[slots[i]]) and :page_scatter_kernel (pages[slots[i]] =
// blocks[i] on the aliased pool, last write in grid order wins).
//
// Bound: bytes.  Each kernel moves N rows of page*d*itemsize bytes and
// computes nothing.  The fused plane's rows are 8 bytes (presence flag +
// one value), so at its widths a launch is bound by its fixed cost, not
// by the bytes; the serving pages are kilobytes, where bandwidth rules.
//
// Design: one block per row.  A row is copied in the widest unit (16, 8,
// 4, 2 or 1 bytes) that divides the row and the alignment of both base
// pointers, which the caller passes as `unit`; 16-byte units give one
// vector load and store per thread.  A slot outside [0, n_slots) reads
// and writes nothing (the gather writes zeros in its place).
//
// The scatter resolves duplicates itself, as CUDA gives blocks no order:
// the block for row i first checks, with all its threads, whether any
// later row j > i names the same slot, and writes only if none does.  That
// is the grid order of the TPU kernel at O(N) work per block, which is
// cheap for the N <= a few hundred rows of the fused path.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <typename U>
__global__ void __launch_bounds__(kThreads)
gather_rows(const int32_t* __restrict__ slots, const U* __restrict__ pages,
            U* __restrict__ out, int n_slots, int64_t row_units) {
  const int i = blockIdx.x;
  const int32_t s = slots[i];
  U* dst = out + (int64_t)i * row_units;
  if (s < 0 || s >= n_slots) {
    const U zero{};
    for (int64_t j = threadIdx.x; j < row_units; j += kThreads) dst[j] = zero;
    return;
  }
  const U* src = pages + (int64_t)s * row_units;
  for (int64_t j = threadIdx.x; j < row_units; j += kThreads) dst[j] = src[j];
}

template <typename U>
__global__ void __launch_bounds__(kThreads)
scatter_rows(const int32_t* __restrict__ slots, const U* __restrict__ blocks,
             U* __restrict__ pages, int n, int n_slots, int64_t row_units) {
  const int i = blockIdx.x;
  const int32_t s = slots[i];
  if (s < 0 || s >= n_slots) return;
  bool later = false;
  for (int j = i + 1 + threadIdx.x; j < n; j += kThreads)
    later |= slots[j] == s;
  if (__syncthreads_or(later)) return;
  const U* src = blocks + (int64_t)i * row_units;
  U* dst = pages + (int64_t)s * row_units;
  for (int64_t j = threadIdx.x; j < row_units; j += kThreads) dst[j] = src[j];
}

template <typename U>
int gather_as(const void* slots, const void* pages, void* out, int n,
              int n_slots, int64_t row_bytes, cudaStream_t stream) {
  gather_rows<U><<<n, kThreads, 0, stream>>>(
      (const int32_t*)slots, (const U*)pages, (U*)out, n_slots,
      row_bytes / (int64_t)sizeof(U));
  return (int)cudaGetLastError();
}

template <typename U>
int scatter_as(const void* slots, const void* blocks, void* pages, int n,
               int n_slots, int64_t row_bytes, cudaStream_t stream) {
  scatter_rows<U><<<n, kThreads, 0, stream>>>(
      (const int32_t*)slots, (const U*)blocks, (U*)pages, n, n_slots,
      row_bytes / (int64_t)sizeof(U));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a CUDA error code; cudaErrorInvalidValue for an unknown unit.
int page_gather(const void* slots, const void* pages, void* out, int n,
                int n_slots, long long row_bytes, int unit, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (unit) {
    case 16: return gather_as<uint4>(slots, pages, out, n, n_slots, row_bytes, st);
    case 8: return gather_as<uint2>(slots, pages, out, n, n_slots, row_bytes, st);
    case 4: return gather_as<uint32_t>(slots, pages, out, n, n_slots, row_bytes, st);
    case 2: return gather_as<uint16_t>(slots, pages, out, n, n_slots, row_bytes, st);
    case 1: return gather_as<uint8_t>(slots, pages, out, n, n_slots, row_bytes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int page_scatter(const void* slots, const void* blocks, void* pages, int n,
                 int n_slots, long long row_bytes, int unit, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (unit) {
    case 16: return scatter_as<uint4>(slots, blocks, pages, n, n_slots, row_bytes, st);
    case 8: return scatter_as<uint2>(slots, blocks, pages, n, n_slots, row_bytes, st);
    case 4: return scatter_as<uint32_t>(slots, blocks, pages, n, n_slots, row_bytes, st);
    case 2: return scatter_as<uint16_t>(slots, blocks, pages, n, n_slots, row_bytes, st);
    case 1: return scatter_as<uint8_t>(slots, blocks, pages, n, n_slots, row_bytes, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
