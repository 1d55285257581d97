// Batched TAC directory probe for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/tac_probe/tac_probe.py:tac_probe_kernel, the
// Pallas kernel that loads one bucket per grid step and compares its
// `ways` keys with the query key.
//
// Computes, per query b: compare qkeys[b] with the `ways` keys of bucket
// buckets[b]; hit[b] = any match; way[b] = first matching way or -1;
// out[b, :] = fp32 sum of the matched value rows, cast to the value type.
//
// Bound: the compares.  The function must read each probed bucket's keys
// once (4 B each) and only the matched value rows, but it compares every
// query with every way of its bucket: B * ways integer ops, which at the
// fused plane's shape (B = 256 queries against ONE bucket of ways =
// capacity) outweigh the bytes.  Each query re-reads the shared key row,
// which stays in L2.
//
// Design: one block of 256 threads per (query, tile of kTileD value
// columns).  Each warp strides over the ways with coalesced 128-byte key
// loads and a ballot; a warp that sees a match adds the matched value
// row's columns of the tile into its own fp32 row in shared memory (lanes
// stride over the tile), so matches cost nothing when they are absent and
// need no atomics.  The first match of a warp is its smallest way (ways
// are visited in increasing order per warp); a block-wide min over the
// warps gives the first match overall, which the first tile's block
// writes.  Nothing assumes ways <= 32.  A tile is kWarps fp32 rows of
// kTileD, 32 KB of shared memory, within the 48 KB a block takes without
// opting in with the warps' first matches beside it, so any D runs: a
// wider row takes more tiles, each comparing the bucket's keys again
// (they stay in L2).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNone = 0x7fffffff;
constexpr int kTileD = 1024;            // value columns a block sums

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
tac_probe_kernel(const int32_t* __restrict__ qkeys,
                 const int32_t* __restrict__ buckets,
                 const int32_t* __restrict__ bucket_keys,
                 const T* __restrict__ bucket_vals, T* __restrict__ out,
                 int32_t* __restrict__ hit, int32_t* __restrict__ way,
                 int n_buckets, int ways, int D) {
  extern __shared__ float acc[];          // [kWarps, W] fp32 partial rows
  __shared__ int first[kWarps];
  const int b = blockIdx.x;
  const int d0 = blockIdx.y * kTileD, W = min(kTileD, D - d0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int32_t q = qkeys[b];
  const int bucket = buckets[b];
  // an out-of-range bucket reads nothing and reports a miss
  const bool valid = bucket >= 0 && bucket < n_buckets;
  const int32_t* keys = bucket_keys + (int64_t)bucket * ways;
  const T* vals = bucket_vals + (int64_t)bucket * ways * D + d0;
  float* mine = acc + warp * W;
  for (int d = lane; d < W; d += 32) mine[d] = 0.f;
  __syncwarp();
  int warp_first = kNone;
  if (valid) {
    for (int base = warp * 32; base < ways; base += kThreads) {
      const int w = base + lane;
      const bool m = w < ways && keys[w] == q;
      unsigned mask = __ballot_sync(0xffffffffu, m);
      while (mask) {
        const int wm = base + __ffs(mask) - 1;
        mask &= mask - 1;
        warp_first = min(warp_first, wm);
        const T* row = vals + (int64_t)wm * D;
        for (int d = lane; d < W; d += 32) mine[d] += to_f32(row[d]);
      }
    }
  }
  if (lane == 0) first[warp] = warp_first;
  __syncthreads();
  int f = kNone;
  for (int i = 0; i < kWarps; ++i) f = min(f, first[i]);
  for (int d = threadIdx.x; d < W; d += kThreads) {
    float s = 0.f;
    for (int i = 0; i < kWarps; ++i) s += acc[i * W + d];
    store(out + (int64_t)b * D + d0 + d, s);
  }
  if (threadIdx.x == 0 && blockIdx.y == 0) {
    hit[b] = f != kNone;
    way[b] = f != kNone ? f : -1;
  }
}

template <typename T>
int launch(const void* qkeys, const void* buckets, const void* bucket_keys,
           const void* bucket_vals, void* out, void* hit, void* way, int B,
           int n_buckets, int ways, int D, void* stream) {
  if (D < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * kWarps * (D < kTileD ? D : kTileD);
  const dim3 grid(B, (D + kTileD - 1) / kTileD);
  tac_probe_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)qkeys, (const int32_t*)buckets,
      (const int32_t*)bucket_keys, (const T*)bucket_vals, (T*)out,
      (int32_t*)hit, (int32_t*)way, n_buckets, ways, D);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tac_probe_f32(const void* qkeys, const void* buckets,
                  const void* bucket_keys, const void* bucket_vals, void* out,
                  void* hit, void* way, int B, int n_buckets, int ways, int D,
                  void* stream) {
  return launch<float>(qkeys, buckets, bucket_keys, bucket_vals, out, hit,
                       way, B, n_buckets, ways, D, stream);
}

int tac_probe_bf16(const void* qkeys, const void* buckets,
                   const void* bucket_keys, const void* bucket_vals,
                   void* out, void* hit, void* way, int B, int n_buckets,
                   int ways, int D, void* stream) {
  return launch<__nv_bfloat16>(qkeys, buckets, bucket_keys, bucket_vals, out,
                               hit, way, B, n_buckets, ways, D, stream);
}

}  // extern "C"
