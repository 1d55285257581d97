// Batched Count-Min Sketch update and estimate for Hopper (sm_90a), plain C
// interface.
//
// Replaces: src/repro/kernels/cms_sketch/cms_sketch.py:cms_update_kernel,
// the Pallas kernel that keeps one counter row in VMEM per grid step and
// walks the batch in order with a scalar loop.
//
// Computes, per sketch row r and in batch order i: c = cols[r, i];
// v = min(ctr[r, c] + 1, max_count); ctr[r, c] = v; est[r, i] = v.  The
// counters come back as a new array (the input is left as it was).  A
// column outside [0, w) reads and writes nothing, and its est is 0.
//
// Bound: bytes.  The function reads and writes each counter row once (the
// new array) and reads cols and writes est; it does one increment per
// lane.  At the hint filter's sketch (d 4, w 10,000, B 256) that is about
// 0.33 MB, a tenth of a microsecond at full bandwidth, so a launch is
// bound by its fixed cost and its chain of dependent steps.
//
// Design: a block per (sketch row, tile of `tile` columns), the tiles from
// the wrapper's plan_tiles, so that the hint filter's four rows fill the
// card.  A block copies its tile of the counter row into shared memory
// (16-byte loads where the row allows), then streams the row's B columns
// through shared memory in chunks of kChunk lanes, so B is unbounded.  In
// each chunk it compacts the lanes whose column falls in its tile, in batch
// order, into a queue (a block-wide scan of per-thread counts), and one
// warp walks the queue 32 lanes a turn: a lane's rank among the turn's
// lanes of its column comes from __match_any_sync, it sees
// v = min(sctr[c] + rank + 1, max_count), and the turn's last lane of each
// column writes v back before the next turn.  Since
// min(min(s + k, M) + j, M) = min(s + k + j, M), that is the sequential
// walk, exactly: O(B) work a tile, no two threads writing one counter, and
// no global atomics, which would hand out ranks in no fixed order.  Tile 0
// of each row writes est = 0 for the lanes whose column is out of the row.
// Last, the block writes its tile of the new counters.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 8;                    // lanes a thread stages a chunk
constexpr int kChunk = kThreads * kLanes;
constexpr int kColBits = 12;
constexpr int kMaxTile = 1 << kColBits;      // counters a block holds

__global__ void __launch_bounds__(kThreads)
cms_tile_kernel(const int32_t* __restrict__ cols,
                const int32_t* __restrict__ counters,
                int32_t* __restrict__ out_counters, int32_t* __restrict__ est,
                int B, int w, int tile, int n_tiles, int max_count,
                int vec) {
  __shared__ __align__(16) int32_t sctr[kMaxTile];
  __shared__ int32_t queue[kChunk];          // (lane in chunk << 12) | col
  __shared__ int warp_sum[kThreads / 32];
  const int r = blockIdx.x / n_tiles;
  const int t = blockIdx.x - r * n_tiles;
  const int c0 = t * tile;
  const int width = max(0, min(c0 + tile, w) - c0);
  const int32_t* crow = counters + (int64_t)r * w + c0;
  int32_t* orow = out_counters + (int64_t)r * w + c0;
  if (vec) {                                 // w % 4 == 0, rows 16-aligned
    for (int j = threadIdx.x; j < width / 4; j += kThreads)
      reinterpret_cast<int4*>(sctr)[j] = reinterpret_cast<const int4*>(crow)[j];
  } else {
    for (int j = threadIdx.x; j < width; j += kThreads) sctr[j] = crow[j];
  }
  const int32_t* rcols = cols + (int64_t)r * B;
  int32_t* rest = est + (int64_t)r * B;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int64_t base = 0; base < B; base += kChunk) {
    // this thread's lanes: base + threadIdx.x * kLanes + k, in batch order
    int loc[kLanes];
    int mine = 0;
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      const int64_t i = base + threadIdx.x * kLanes + k;
      const int c = i < B ? rcols[i] : -1;
      const bool in_tile = i < B && c >= c0 && c < c0 + width;
      loc[k] = in_tile ? c - c0 : -1;
      mine += in_tile;
      if (t == 0 && i < B && (c < 0 || c >= w)) rest[i] = 0;
    }
    // exclusive scan of the per-thread counts, in thread order
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(~0u, incl, o);
      if (lane >= o) incl += x;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();                          // also: sctr filled
    int pos = incl - mine, total = 0;
#pragma unroll
    for (int j = 0; j < kThreads / 32; ++j) {
      const int s = warp_sum[j];
      pos += j < warp ? s : 0;
      total += s;
    }
#pragma unroll
    for (int k = 0; k < kLanes; ++k)
      if (loc[k] >= 0)
        queue[pos++] = ((threadIdx.x * kLanes + k) << kColBits) | loc[k];
    __syncthreads();
    if (warp == 0) {
      for (int q = 0; q < total; q += 32) {
        const bool act = q + lane < total;
        const int e = act ? queue[q + lane] : 0;
        const int c = act ? e & (kMaxTile - 1) : -1;
        const unsigned peers = __match_any_sync(~0u, c);
        const int rank = __popc(peers & ((1u << lane) - 1));
        const int32_t v = act ? (int32_t)min((int64_t)sctr[c] + rank + 1,
                                             (int64_t)max_count)
                              : 0;
        __syncwarp();                         // every lane has read sctr
        if (act) {
          rest[base + (e >> kColBits)] = v;
          if ((peers >> lane) == 1u) sctr[c] = v;   // the column's last lane
        }
        __syncwarp();
      }
    }
    __syncthreads();                          // queue and warp_sum reused
  }
  __syncthreads();
  if (vec) {
    for (int j = threadIdx.x; j < width / 4; j += kThreads)
      reinterpret_cast<int4*>(orow)[j] = reinterpret_cast<const int4*>(sctr)[j];
  } else {
    for (int j = threadIdx.x; j < width; j += kThreads) orow[j] = sctr[j];
  }
}

}  // namespace

extern "C" {

// cols [d, B], counters and out_counters [d, w], est [d, B], all int32 and
// contiguous; a block per (row, tile of `tile` columns), n_tiles a row
// (the wrapper's plan_tiles; a tile of more than kMaxTile columns is
// refused).
// vec: w % 4 == 0, tile % 4 == 0 and both counter arrays 16-byte aligned.
// Returns a CUDA error code.
int cms_update(const void* cols, const void* counters, void* out_counters,
               void* est, int d, int B, int w, int tile, int n_tiles,
               int max_count, int vec, void* stream) {
  if (tile <= 0 || tile > kMaxTile || n_tiles <= 0 || (vec && tile % 4))
    return (int)cudaErrorInvalidValue;
  cms_tile_kernel<<<d * n_tiles, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cols, (const int32_t*)counters,
      (int32_t*)out_counters, (int32_t*)est, B, w, tile, n_tiles, max_count,
      vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
