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
// by the bytes; the serving pages are 32 KB, where a launch of a few rows
// is bound by one round trip to device memory and a batch by bandwidth.
//
// Both kernels copy a row in the widest unit (16, 8, 4, 2 or 1 bytes) that
// divides the row and the alignment of the base pointers, which the caller
// passes as `unit`.  A slot outside [0, n_slots) reads and writes nothing
// (the gather writes zeros in its place).
//
// Gather design: a block per (row, chunk of `chunk_units` units), a grid
// of rows by chunks, the chunks and the block size from the wrapper's
// launch planner
// (kernels/page_gather/page_gather.py:plan_gather), so that a launch of a
// few kilobyte rows fills the card and not one SM a row; a short row is
// one chunk.  Each thread issues its kVec loads (unrolled) before it
// stores any of them, so it keeps kVec 16-byte loads in flight instead of
// one after another; the planner sizes the block so that one such round
// covers the chunk, and the kernel loops where it does not.  A launch of
// a few rows costs two dependent round trips to device memory (slot,
// then row) beside the launch itself.  Moving each chunk with
// cp.async.bulk through shared memory (one thread, an mbarrier) timed no
// faster on the card (tools/gather_variants.py, PERF.md), so the gather
// stays on plain vector loads, which take any unit.
//
// The scatter resolves duplicates itself, as CUDA gives blocks no order:
// the block for row i first checks, with all its threads, whether any
// later row j > i names the same slot, and writes only if none does.  That
// is the grid order of the TPU kernel at O(N) work per block, which is
// cheap for the N <= a few hundred rows of the fused path.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;    // the scatter's block
constexpr int kMaxThreads = 256; // the gather's largest block
constexpr int kVec = 4;          // units a gather thread loads before storing

template <typename U>
__global__ void __launch_bounds__(kMaxThreads)
gather_chunks(const int32_t* __restrict__ slots, const U* __restrict__ pages,
              U* __restrict__ out, int n_slots, int64_t row_units,
              int chunk_units) {
  const int i = blockIdx.x;                  // row, then chunk: the slot
  const int32_t s = slots[i];                // load starts at once
  const int64_t lo = (int64_t)blockIdx.y * chunk_units;
  const int64_t hi = min(lo + chunk_units, row_units);
  const bool in_range = s >= 0 && s < n_slots;
  const U* src = pages + (in_range ? (int64_t)s * row_units : 0);
  U* dst = out + (int64_t)i * row_units;
  for (int64_t base = lo + threadIdx.x; base < hi;
       base += (int64_t)kVec * blockDim.x) {
    U v[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int64_t u = base + k * blockDim.x;
      v[k] = in_range && u < hi ? src[u] : U{};
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int64_t u = base + k * blockDim.x;
      if (u < hi) dst[u] = v[k];
    }
  }
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
              int n_slots, int64_t row_bytes, int threads, int chunk_units,
              cudaStream_t stream) {
  const int64_t row_units = row_bytes / (int64_t)sizeof(U);
  const int64_t n_chunks = (row_units + chunk_units - 1) / chunk_units;
  if (n_chunks > 65535) return (int)cudaErrorInvalidValue;
  gather_chunks<U><<<dim3(n, (unsigned)n_chunks), threads, 0, stream>>>(
      (const int32_t*)slots, (const U*)pages, (U*)out, n_slots, row_units,
      chunk_units);
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

// A block of `threads` threads per (row, chunk of `chunk_units` units):
// the wrapper's plan_gather.  Returns a CUDA error code;
// cudaErrorInvalidValue for an unknown unit or a launch shape out of
// range.
int page_gather(const void* slots, const void* pages, void* out, int n,
                int n_slots, long long row_bytes, int unit, int threads,
                int chunk_units, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0 || threads <= 0 || threads > kMaxThreads || chunk_units <= 0)
    return (int)cudaErrorInvalidValue;
#define GATHER(U) gather_as<U>(slots, pages, out, n, n_slots, row_bytes, \
                               threads, chunk_units, st)
  switch (unit) {
    case 16: return GATHER(uint4);
    case 8: return GATHER(uint2);
    case 4: return GATHER(uint32_t);
    case 2: return GATHER(uint16_t);
    case 1: return GATHER(uint8_t);
    default: return (int)cudaErrorInvalidValue;
  }
#undef GATHER
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
