// Batched Count-Min Sketch update and estimate for Hopper (sm_90a), plain C
// interface.
//
// Replaces: src/repro/kernels/cms_sketch/cms_sketch.py:cms_update_kernel,
// the Pallas kernel that keeps one counter row in VMEM per grid step and
// walks the batch in order with a scalar loop.
//
// Computes, per sketch row r and in batch order i: c = cols[r, i];
// v = min(ctr[r, c] + 1, max_count); ctr[r, c] = v; est[r, i] = v.  The
// counters come back as a new array (the input is left as it was).
//
// Bound: bytes.  The function reads and writes each counter row once (the
// new array) and reads cols and writes est; it does one increment per
// lane.  At the hint filter's sketch (d 4, w 10,000, B 256) that is about
// 0.33 MB, a tenth of a microsecond at full bandwidth, so a launch is
// bound by its fixed cost.
//
// Design: the sequential walk is replaced by its exact parallel form.  Lane
// i of a row sees the counter after its own increment, which is
// min(ctr0[c] + rank + 1, max_count), where rank counts the earlier lanes
// of the row with the same column; the final counter of a touched column is
// the value its last lane sees.  One block per row copies the row into the
// output, stages the row's columns in shared memory, and each thread ranks
// its lanes by comparing with every other lane of the row (B * B compares,
// 65,536 at B = 256).  Only the last lane of each column writes it, so no
// two threads write one counter and no atomics are needed, which would
// hand out ranks in no fixed order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
cms_kernel(const int32_t* __restrict__ cols,
           const int32_t* __restrict__ counters,
           int32_t* __restrict__ out_counters, int32_t* __restrict__ est,
           int B, int w, int max_count) {
  extern __shared__ int32_t col_s[];
  const int r = blockIdx.x;
  const int32_t* crow = counters + (int64_t)r * w;
  int32_t* orow = out_counters + (int64_t)r * w;
  for (int j = threadIdx.x; j < w; j += kThreads) orow[j] = crow[j];
  for (int i = threadIdx.x; i < B; i += kThreads)
    col_s[i] = cols[(int64_t)r * B + i];
  __syncthreads();
  for (int i = threadIdx.x; i < B; i += kThreads) {
    const int c = col_s[i];
    int rank = 0;
    bool last = true;
    for (int j = 0; j < B; ++j) {
      if (col_s[j] == c) {
        rank += j < i;
        last &= j <= i;
      }
    }
    // a column outside the row reads and writes nothing
    const bool in_row = c >= 0 && c < w;
    const int64_t v = in_row ? min((int64_t)crow[c] + rank + 1,
                                   (int64_t)max_count)
                             : 0;
    est[(int64_t)r * B + i] = (int32_t)v;
    if (in_row && last) orow[c] = (int32_t)v;
  }
}

}  // namespace

extern "C" {

// Largest batch a launch accepts: its columns in 48 KB of shared memory.
int cms_max_batch() { return (48 * 1024) / (int)sizeof(int32_t); }

// cols [d, B], counters and out_counters [d, w], est [d, B], all int32 and
// contiguous.  Returns a CUDA error code.
int cms_update(const void* cols, const void* counters, void* out_counters,
               void* est, int d, int B, int w, int max_count, void* stream) {
  cms_kernel<<<d, kThreads, sizeof(int32_t) * B, (cudaStream_t)stream>>>(
      (const int32_t*)cols, (const int32_t*)counters,
      (int32_t*)out_counters, (int32_t*)est, B, w, max_count);
  return (int)cudaGetLastError();
}

}  // extern "C"
