// The fused plane's batch step and admission for Hopper (sm_90a), one
// launch each, plain C interface.
//
// Replaces, on the fused plane's path, the TPU kernels
// src/repro/kernels/tac_probe/tac_probe.py:tac_probe_kernel (K1, the
// directory probe) and src/repro/kernels/page_gather/page_gather.py:
// page_scatter_kernel (K3, the write-back), with the page gather (K2) and
// the tensor code around them in src/repro/core/tac_jax.py:fused_step and
// :fused_admit, which the TPU runs as one jitted program per operator
// config.
//
// fused_step computes, for a batch of B <= kMaxB lanes against a directory
// of ONE bucket of W ways and its pool pages [W + 1, 1, V + 1] (channel 0
// the presence flag, the last row a zeroed scratch row):
//   - the probe: the first way whose key equals the lane's key, hit &=
//     valid, the slot (the scratch row W on a miss);
//   - the row at the probe's way (the scratch row where no way matched),
//     and new_vals: lane i folds in every earlier
//     same-key update lane (j <= i, hit, not fire, kind != read), as a sum
//     in lane order (`sum`, `read`) or a max (`max`); present = the row's
//     flag or any such lane; new_vals zeroed where not present;
//   - the timestamp refresh (the max over a key's hit lanes), the dirty bit
//     (any update lane of the key) and the write-back of (present, new_v)
//     by a key's LAST update lane; the scratch row zeroed (kind != read);
//   - the (hits, misses) tallies over valid lanes.
// Every per-lane result goes into one int32 buffer:
//   [hit B | slots B | present B | tallies 2 | new_vals f32 bits B*V].
// fused_admit computes, for N host-chosen slots: the victim rows gathered
// before the overwrite; the new rows (presence flag, values) scattered with
// the last write winning on a repeated slot; the scratch row zeroed; the
// directory's key, timestamp and dirty bit written at the slots.
//
// Bound: bytes, and the launch.  The step must read the W directory keys
// once (4 B each: 1 MB at W = 262,144, 0.31 us at 3.35 TB/s) and a few KB
// of lanes and rows; its compares are W table lookups and, for a key that
// repeats within the batch, the pairs of its lanes.  Both are far below
// the cost of one launch, which is what the design minimises.
//
// Design (step): one launch of blocks of 1024 threads, enough warps on an
// SM to hide the lookups' shared-memory latency.  Every block builds the
// same open-addressing table of the batch's distinct keys in shared memory
// (a key's entry holds its first lane), then looks up each directory key
// of its tile of kWaysPerBlock ways once: a thread loads its
// kWaysPerThread keys (coalesced, all in flight at once) at entry, while
// the table builds.  A match
// takes the block's minimum way per key (shared-memory atomicMin).  When
// the directory fits one tile (W <= 2048, the plane of the e2e runs) that
// block goes straight on to the tail.  Otherwise each block folds its
// minima into a global workspace indexed by the key's first lane
// (atomicMin in L2), and the last block to finish (a __threadfence and an
// atomic ticket) runs the tail, then resets the workspace and the ticket
// for the next launch.  The tail has one thread a lane (the block's first
// kMaxB threads); the lanes' weights were copied to shared memory at entry,
// and the row and timestamp loads start as soon as the way is known.  A key's lanes are
// a 256-bit mask (a __match_any_sync word a warp, kept by the key's first
// lane), and the hit and update lanes two more (ballots), so a lane finds
// its key's earlier and later update and hit lanes with a few word
// operations and folds only its key's update lanes, in lane order.  After
// a barrier (every row read before any is written) the key's last update
// lane writes the row back; the timestamp and dirty bit, which no lane
// reads, are written before it.  A query key of -1 matches the first empty
// way, as the reference compares keys with no exception; nothing treats a
// directory entry as "skip".  Tensor cores, TMA and wgmma have no part in
// integer compares over bytes that sit in L2.
//
// Design (admit): one block; the gather of every victim row, a barrier,
// then the writes, each by the last lane naming its slot (O(N^2 / 256)
// compares for the N <= 64 of a chunk), a barrier, the scratch row.  Slots
// outside [0, W) read as zero rows and write nothing (the wrapper's caller
// checks them on the host).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;           // a step block
constexpr int kMaxB = 256;                 // lanes: the tail's first threads
constexpr int kLaneWarps = kMaxB / 32;
constexpr int kTableBits = 9;
constexpr int kTable = 1 << kTableBits;    // >= 2 kMaxB: load factor <= 1/2
constexpr int kWaysPerThread = 2;
constexpr int kWaysPerBlock = kWaysPerThread * kThreads;
constexpr int kAdmitThreads = 256;
constexpr int kSmemDefault = 48 * 1024;    // a block's shared memory without
constexpr int kSmemLimit = 227 * 1024;     // the opt-in, and with it
constexpr int kNone = 0x7fffffff;
constexpr int kSum = 0, kMax = 1, kRead = 2;
static_assert(kTable >= 2 * kMaxB, "the key table must stay half empty");

__device__ __forceinline__ int home(int32_t key) {
  return (int)(((uint32_t)key * 2654435761u) >> (32 - kTableBits));
}

struct StepArgs {
  const int32_t* keys;
  const float* ts;
  const float* weights;                    // [B, V]
  const uint8_t* fire;
  const uint8_t* valid;
  const int32_t* dir_keys;                 // [W]
  float* dir_ts;                           // [W]
  uint8_t* dir_dirty;                      // [W]
  float* pages;                            // [W + 1, V + 1]
  int32_t* out;                            // [3 B + 2 + B V]
  int32_t* ws;                             // [kMaxB + 1]: ways, ticket
  int B, W, V, kind;
};

// The lanes of warp w at or before lane t of the batch: all of an earlier
// warp, lanes 0..t % 32 of t's own warp, none of a later one.
__device__ __forceinline__ unsigned upto(int w, int t) {
  const int wt = t >> 5;
  return w < wt ? ~0u : w > wt ? 0u : (2u << (t & 31)) - 1u;
}

__global__ void __launch_bounds__(kThreads) fused_step_kernel(StepArgs a) {
  __shared__ int32_t s_key[kMaxB];
  __shared__ int s_lane[kTable];           // a lane holding the key; -1 empty
  __shared__ int s_first[kTable];          // the key's first lane
  __shared__ int s_way[kTable];            // this block's first matching way
  __shared__ unsigned s_lanes[kMaxB][kLaneWarps];  // by a key's first
  //                                                  lane: its lanes
  __shared__ unsigned s_hit[kLaneWarps], s_upd[kLaneWarps];  // ballots
  __shared__ float s_ts[kMaxB];
  __shared__ int s_is_last;
  extern __shared__ float s_w[];           // [B, V] the lanes' weights
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int B = a.B, W = a.W, V = a.V;
  const bool in_batch = t < B;
  // this thread's directory keys, all in flight while the key table builds
  const int w0 = blockIdx.x * kWaysPerBlock + t;
  int32_t dk[kWaysPerThread];
#pragma unroll
  for (int i = 0; i < kWaysPerThread; ++i)
    dk[i] = w0 + i * kThreads < W ? __ldg(a.dir_keys + w0 + i * kThreads) : 0;
  // the lane's own inputs, loaded while the probe runs
  bool valid = false, fire = false;
  float ts = 0.f;
  if (in_batch) {
    valid = a.valid[t] != 0;
    fire = a.fire[t] != 0;
    ts = a.ts[t];
    s_key[t] = a.keys[t];
  }
  for (int e = t; e < B * V; e += kThreads) s_w[e] = a.weights[e];
  for (int h = t; h < kTable; h += kThreads) {
    s_lane[h] = -1;
    s_first[h] = kNone;
    s_way[h] = kNone;
  }
  __syncthreads();
  int mine = 0;                            // this lane's table entry
  if (in_batch) {
    const int32_t k = s_key[t];
    int h = home(k);
    for (;;) {
      const int prev = atomicCAS(&s_lane[h], -1, t);
      if (prev == -1 || s_key[prev] == k) break;
      h = (h + 1) & (kTable - 1);
    }
    atomicMin(&s_first[h], t);
    mine = h;
  }
  __syncthreads();
  // the probe: each directory key of this block's tile looked up once
#pragma unroll
  for (int i = 0; i < kWaysPerThread; ++i) {
    if (w0 + i * kThreads >= W) break;
    for (int h = home(dk[i]), l; (l = s_lane[h]) >= 0;
         h = (h + 1) & (kTable - 1))
      if (s_key[l] == dk[i]) {
        atomicMin(&s_way[h], w0 + i * kThreads);
        break;
      }
  }
  __syncthreads();
  // one block holds every way in its table; more fold theirs into the
  // workspace, and the last to finish runs the tail
  const bool single = gridDim.x == 1;
  if (!single) {
    for (int h = t; h < kTable; h += kThreads)
      if (s_way[h] != kNone) atomicMin(&a.ws[s_first[h]], s_way[h]);
    __threadfence();
    __syncthreads();
    if (t == 0)
      s_is_last = atomicAdd(&a.ws[kMaxB], 1) == (int)gridDim.x - 1;
    __syncthreads();
    if (!s_is_last) return;
  }

  // ---- the tail: one block, one thread a lane
  const int first = in_batch ? s_first[mine] : 0;
  const int way = !in_batch ? kNone
                  : single ? s_way[mine] : __ldcg(&a.ws[first]);
  const bool hit = valid && way < W;
  const bool upd = hit && a.kind != kRead && !fire;
  // the row at the probe's way, valid or not, as the reference gathers it,
  // and the directory's timestamp: loads in flight while the masks build
  const float* row = a.pages + (int64_t)(way < W ? way : W) * (V + 1);
  float flag = 0.f, g0 = 0.f, cur_ts = 0.f;
  if (in_batch) {
    flag = row[0];
    if (V > 0) g0 = row[1];
    if (hit) cur_ts = a.dir_ts[way];
    for (int j = 0; j < kLaneWarps; ++j) s_lanes[t][j] = 0u;
    s_ts[t] = ts;
  }
  // a key's lanes in this warp (keys matched by their first lane)
  const unsigned same = __match_any_sync(~0u, in_batch ? first : -1)
                        & __ballot_sync(~0u, in_batch);
  const unsigned hits = __ballot_sync(~0u, hit);
  const unsigned upds = __ballot_sync(~0u, upd);
  if (lane == 0 && warp < kLaneWarps) {
    s_hit[warp] = hits;
    s_upd[warp] = upds;
  }
  const int n_hit = __syncthreads_count(hit);
  if (in_batch && lane == __ffs(same) - 1) s_lanes[first][warp] = same;
  // every lane has read its way: the workspace is clean for the next launch
  if (!single) {
    if (in_batch) a.ws[t] = kNone;
    if (t == 0) a.ws[kMaxB] = 0;
  }
  const int n_miss = __syncthreads_count(valid && !hit);
  bool has_upd = false, later_upd = false, later_hit = false;
  if (in_batch)
    for (int j = 0; j < kLaneWarps; ++j) {
      const unsigned key_j = s_lanes[first][j], le = upto(j, t);
      has_upd |= (key_j & s_upd[j] & le) != 0u;
      later_upd |= (key_j & s_upd[j] & ~le) != 0u;
      later_hit |= (key_j & s_hit[j] & ~le) != 0u;
    }
  const int slot = hit ? way : W;
  float* new_vals = reinterpret_cast<float*>(a.out + 3 * B + 2);
  float v0 = 0.f;                          // channel 0's new value
  if (in_batch) {
    const bool present = flag > 0.5f || has_upd;
    for (int c = 0; c < V; ++c) {
      // the key's update lanes up to this one, in lane order
      float v = a.kind == kMax ? -INFINITY : 0.f;
      for (int j = 0; j <= warp; ++j)
        for (unsigned m = s_lanes[first][j] & s_upd[j] & upto(j, t); m;
             m &= m - 1) {
          const float x = s_w[(j * 32 + __ffs(m) - 1) * V + c];
          v = a.kind == kMax ? fmaxf(v, x) : v + x;
        }
      const float g = c == 0 ? g0 : row[1 + c];
      v = a.kind == kMax ? fmaxf(flag > 0.5f ? g : -INFINITY, v)
                         : (flag > 0.5f ? g : 0.f) + v;
      v = present ? v : 0.f;
      new_vals[(int64_t)t * V + c] = v;
      if (c == 0) v0 = v;
    }
    a.out[t] = hit;
    a.out[B + t] = slot;
    a.out[2 * B + t] = present;
  }
  if (t == 0) {
    a.out[3 * B] = n_hit;
    a.out[3 * B + 1] = n_miss;
  }
  // the directory's timestamp (the max over the key's hit lanes) and dirty
  // bit, by the key's last hit and last update lane; no lane reads them
  if (hit && !later_hit) {
    float m = -INFINITY;
    for (int j = 0; j < kLaneWarps; ++j)
      for (unsigned b = s_lanes[first][j] & s_hit[j]; b; b &= b - 1)
        m = fmaxf(m, s_ts[j * 32 + __ffs(b) - 1]);
    a.dir_ts[way] = fmaxf(cur_ts, m);
  }
  if (upd && !later_upd) a.dir_dirty[way] = 1;
  __syncthreads();                         // every row read before any write
  if (upd && !later_upd) {
    float* dst = a.pages + (int64_t)way * (V + 1);
    dst[0] = 1.f;
    if (V > 0) dst[1] = v0;
    for (int c = 1; c < V; ++c) dst[1 + c] = new_vals[(int64_t)t * V + c];
  }
  if (a.kind != kRead)
    for (int c = t; c <= V; c += kThreads)
      a.pages[(int64_t)W * (V + 1) + c] = 0.f;
}

struct AdmitArgs {
  const int32_t* slots;
  const int32_t* kids;
  const float* ts;
  const float* rows;                       // [N, V]
  const uint8_t* present;
  const uint8_t* dirty;
  int32_t* dir_keys;
  float* dir_ts;
  uint8_t* dir_dirty;
  float* pages;                            // [W + 1, V + 1]
  float* victims;                          // [N, V + 1]
  int N, W, V;
};

__global__ void __launch_bounds__(kAdmitThreads)
fused_admit_kernel(AdmitArgs a) {
  const int R = a.V + 1;
  for (int64_t e = threadIdx.x; e < (int64_t)a.N * R; e += kAdmitThreads) {
    const int32_t s = a.slots[e / R];
    a.victims[e] = s >= 0 && s < a.W ? a.pages[(int64_t)s * R + e % R] : 0.f;
  }
  __syncthreads();                         // every victim read before a write
  for (int i = threadIdx.x; i < a.N; i += kAdmitThreads) {
    const int32_t s = a.slots[i];
    if (s < 0 || s >= a.W) continue;
    bool later = false;
    for (int j = i + 1; j < a.N && !later; ++j) later = a.slots[j] == s;
    if (later) continue;
    float* dst = a.pages + (int64_t)s * R;
    dst[0] = a.present[i] ? 1.f : 0.f;
    for (int c = 0; c < a.V; ++c) dst[1 + c] = a.rows[(int64_t)i * a.V + c];
    a.dir_keys[s] = a.kids[i];
    a.dir_ts[s] = a.ts[i];
    a.dir_dirty[s] = a.dirty[i] != 0;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < R; c += kAdmitThreads)
    a.pages[(int64_t)a.W * R + c] = 0.f;
}

}  // namespace

extern "C" {

int tac_fused_max_b() { return kMaxB; }

// Blocks of a step launch over W ways (the probe's tiles).
int tac_fused_step_blocks(int W) {
  return W > 0 ? (W + kWaysPerBlock - 1) / kWaysPerBlock : 1;
}

// Returns a CUDA error code; cudaErrorInvalidValue for B outside
// [0, kMaxB], an unknown kind, or B * V weights beyond a block's shared
// memory (V up to about 200 at B = 256).  `ws` holds kMaxB + 1 int32: kNone in the
// first kMaxB and 0 in the last before the first launch; every launch
// leaves it so.
int tac_fused_step(const void* keys, const void* ts, const void* weights,
                   const void* fire, const void* valid, const void* dir_keys,
                   void* dir_ts, void* dir_dirty, void* pages, void* out,
                   void* ws, int B, int W, int V, int kind, void* stream) {
  static size_t static_smem = 0;           // the kernel's own, read once
  if (static_smem == 0) {
    cudaFuncAttributes fa;
    const cudaError_t err = cudaFuncGetAttributes(&fa, fused_step_kernel);
    if (err != cudaSuccess) return (int)err;
    static_smem = fa.sharedSizeBytes;
  }
  const size_t smem = sizeof(float) * (size_t)B * V;  // the lanes' weights
  if (B < 0 || B > kMaxB || V < 0 || kind < kSum || kind > kRead
      || static_smem + smem > (size_t)kSmemLimit)
    return (int)cudaErrorInvalidValue;
  if (static_smem + smem > (size_t)kSmemDefault) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  StepArgs a{(const int32_t*)keys, (const float*)ts, (const float*)weights,
             (const uint8_t*)fire, (const uint8_t*)valid,
             (const int32_t*)dir_keys, (float*)dir_ts, (uint8_t*)dir_dirty,
             (float*)pages, (int32_t*)out, (int32_t*)ws, B, W, V, kind};
  fused_step_kernel<<<tac_fused_step_blocks(W), kThreads, smem,
                      (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

int tac_fused_admit(const void* slots, const void* kids, const void* ts,
                    const void* rows, const void* present, const void* dirty,
                    void* dir_keys, void* dir_ts, void* dir_dirty, void* pages,
                    void* victims, int N, int W, int V, void* stream) {
  AdmitArgs a{(const int32_t*)slots, (const int32_t*)kids, (const float*)ts,
              (const float*)rows, (const uint8_t*)present,
              (const uint8_t*)dirty, (int32_t*)dir_keys, (float*)dir_ts,
              (uint8_t*)dir_dirty, (float*)pages, (float*)victims, N, W, V};
  fused_admit_kernel<<<1, kAdmitThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
