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
// fused_step computes, for a batch of B lanes (any B >= 0) against a
// directory of ONE bucket of W ways and its pool pages [W + 1, 1, V + 1]
// (channel 0 the presence flag, the last row a zeroed scratch row):
//   - the probe: the first way whose key equals the lane's key, hit &=
//     valid, the slot (the scratch row W on a miss);
//   - the row at the probe's way (the scratch row where no way matched),
//     and new_vals: lane i folds in every earlier
//     same-key update lane (j <= i, hit, not fire, kind != read), as a sum
//     in lane order (`sum`, `read`) or a max (`max`); present = the row's
//     flag or any such lane; new_vals zeroed where not present;
//   - the timestamp refresh (the max over a key's hit lanes), the dirty bit
//     (any update lane of the key) and the write-back of (present, new_v)
//     by a key's LAST update lane in the whole batch; the scratch row
//     zeroed (kind != read);
//   - the (hits, misses) tallies over valid lanes.
// Every row is read before any row is written, as the reference gathers
// before it scatters.  Every per-lane result goes into one int32 buffer:
//   [hit B | slots B | present B | tallies 2 | new_vals f32 bits B*V].
// fused_admit computes, for N host-chosen slots: the victim rows gathered
// before the overwrite; the new rows (presence flag, values) scattered with
// the last write winning on a repeated slot; the scratch row zeroed; the
// directory's key, timestamp and dirty bit written at the slots.
//
// Bound: bytes, and the launch.  The step must read the W directory keys
// once (4 B each: 1 MB at W = 262,144, 0.31 us at 3.35 TB/s), the lanes,
// and the rows it reads and writes; its compares are W table lookups and,
// for a key that repeats within the batch, the pairs of its lanes.  At the
// plane's batches both are far below the cost of one launch, which is what
// the design minimises: one launch a batch, whatever B and V are.
//
// Design (step): one launch of blocks of 1024 threads, a block per (tile of
// kWaysPerBlock ways, partition of kTile lanes).  Each block builds an
// open-addressing table of its partition's distinct keys in shared memory
// (a 64-bit entry, the key above the partition's first lane holding it,
// so one atomicMin keeps the first lane), then looks up each directory key
// of its tile of ways once: a thread loads its kWaysPerThread keys
// (coalesced, all in flight at once) at entry, while the table builds.  A
// match takes the block's minimum way per key (shared-memory atomicMin).
// When one block covers the batch and the directory (B <= kTile, W <=
// kWaysPerBlock: the plane of the e2e runs at batch 256) it goes straight
// on to the tail.  Otherwise each block folds its minima into the global
// workspace `ways`, indexed by the partition's first lane of the key
// (atomicMin in L2), and the last block to finish (a __threadfence and an
// atomic ticket) runs the tail.  A partition of kTile lanes never fills
// its table past half, whatever the keys are, and the probe's shared
// memory does not grow with B.
//
// The tail, one block, its first T threads (a thread a lane of a tile; the
// warps past a small batch leave, and the rest meet at a named barrier):
// each lane's way and its key's first lane in the batch (the table's when
// there is one partition; past that the least lane naming the way, an
// atomicMin into the workspace `firsts` [W]); each key's last lane, last
// hit and update lane and latest hit timestamp, atomicMax by key.  Then
// the lanes in tiles of kTile, in lane order.  A lane alone with its key
// folds only itself.  The lanes of keys with more lanes are packed in lane
// order and sorted by (key's first lane, lane), a bitonic network
// (exchanges within a warp by shuffles, across warps through shared
// memory, entries of 32 bits below 2^22 lanes), so each key's lanes in the
// tile form a run in lane order; a lane's fold is its key's carry from the
// earlier tiles followed by the run's update lanes up to it, in order, so
// the sum is the sequential one bit for bit.  The run's last lane carries
// the fold and whether an update was seen to the next tile (the workspace
// `scratch`, read only by a key that spans tiles).  The lane arrays sit in
// dynamic shared memory when B <= kTile, in `scratch` beyond.  After the
// last tile (every row read) the key's last update lane writes the row
// back from its new_vals, its last hit lane the timestamp, and the
// workspace is left clean for the next launch.  A query key of -1 matches
// the first empty way, as the reference compares keys with no exception;
// nothing treats a directory entry as "skip".  Tensor cores, TMA and
// wgmma have no part in integer compares over bytes that sit in L2.
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

typedef unsigned long long u64;

constexpr int kThreads = 1024;           // a step block
constexpr int kTile = kThreads;          // lanes: a probe partition, a tail tile
constexpr int kMaxTable = 2 * kTile;     // a partition's table, at most half full
constexpr int kWaysPerThread = 2;
constexpr int kWaysPerBlock = kWaysPerThread * kThreads;
constexpr int kAdmitThreads = 256;
constexpr int kNone = 0x7fffffff;
constexpr u64 kEmpty = ~0ull;            // a free table entry
constexpr int kSum = 0, kMax = 1, kRead = 2;
constexpr uint8_t kHitLane = 1, kUpdLane = 2, kRowFlag = 4;

__device__ __forceinline__ int home(int32_t key, int bits) {
  return (int)(((uint32_t)key * 2654435761u) >> (32 - bits));
}

// floats as ints in the same order (for atomicMax), and back
__device__ __forceinline__ int ordered(float x) {
  const int b = __float_as_int(x);
  return b >= 0 ? b : b ^ 0x7fffffff;
}
__device__ __forceinline__ float unordered(int b) {
  return __int_as_float(b >= 0 ? b : b ^ 0x7fffffff);
}

// The tail sorts a tile's lanes by entries (key's first lane << kShift |
// tile lane): 32 bits while the first lane fits in 22 (B < 2^22), 64
// beyond; kPad fills the network past the lanes.
template <typename Key>
struct Sort {
  static constexpr int kShift = sizeof(Key) == 4 ? 10 : 32;
  static constexpr Key kPad = ~Key(0);
};
static_assert(kTile <= 1 << 10, "a tile lane must fit in the entry's low bits");

// The tail's lane arrays, each of B int32: a lane's way and its key's
// first lane (-1 for no way), then by a key's first lane its last lane,
// last hit lane, last update lane and its hit lanes' latest timestamp
// (ordered); in dynamic shared memory while one tile holds the batch.
enum { kWay, kFirst, kLast, kLastHit, kLastUpd, kLatest, kLaneArrays };

__device__ __forceinline__ void reset_key(int32_t* lanes, int B, int f) {
  lanes[kLast * B + f] = -1;
  lanes[kLastHit * B + f] = -1;
  lanes[kLastUpd * B + f] = -1;
  lanes[kLatest * B + f] = ordered(-INFINITY);
}

// lane i of key f, valid or not, updating or not, at time ts
__device__ __forceinline__ void note_lane(int32_t* lanes, int B, int f, int i,
                                          bool valid, bool upd, float ts) {
  atomicMax(lanes + kLast * B + f, i);
  if (!valid) return;
  atomicMax(lanes + kLastHit * B + f, i);
  atomicMax(lanes + kLatest * B + f, ordered(ts));
  if (upd) atomicMax(lanes + kLastUpd * B + f, i);
}

__device__ __forceinline__ int pow2_ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// a barrier of the tail's T threads (barrier 0 is __syncthreads)
__device__ __forceinline__ void sync_tail(int T) {
  asm volatile("bar.sync 1, %0;" ::"r"(T) : "memory");
}

// a bitonic compare-exchange: the lower place of a pair keeps the smaller
// entry where the run ascends (`up`), the upper place the larger
template <typename Key>
__device__ __forceinline__ Key exchange(Key e, Key o, bool up, int upper) {
  return (upper == 0) == up ? (o < e ? o : e) : (o > e ? o : e);
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
  int32_t* ways;      // [1 + B]: the ticket, then a way by a partition's
  //                     first lane of a key (kNone); left so by every launch
  int32_t* firsts;    // [W] when B > kTile: a way's first lane (kNone); so
  int32_t* scratch;   // [B] each lane's partition first lane; when B >
  //                     kTile also the lane arrays [6 B], seen [B] and the
  //                     carried folds f32 [B, V]
  int B, W, V, kind;
};

// the probe's key table and the tail's tile share the block's shared memory
struct ProbeShared {
  u64 key[kMaxTable];                      // key << 32 | first lane; kEmpty
  int way[kMaxTable];                      // this block's first matching way
};
template <typename Key>
struct TailShared {
  Key sorted[2][kTile];                    // (key's first lane, tile lane):
  //                                          the sort's exchange, two deep
  float w[kTile];                          // sorted: an update lane's weight
  uint8_t upd[kTile];                      // sorted: an update lane
  int way[kTile];                          // by tile lane
  float g0[kTile];                         // by tile lane: the row's value 0
  float w0[kTile];                         // by tile lane: weight 0 (update)
  float nv0[kTile];                        // by tile lane: new value 0
  uint8_t flags[kTile];                    // by tile lane: kHitLane,
  //                                          kUpdLane, kRowFlag
};
template <typename Key>
union StepShared {
  ProbeShared probe;
  TailShared<Key> tail;
};

// two blocks an SM (32 registers a thread): the probe's grid grows with W
// and B
template <typename Key>
__global__ void __launch_bounds__(kThreads, 2)
fused_step_kernel(StepArgs a) {
  using K = Sort<Key>;
  __shared__ StepShared<Key> sm;
  __shared__ int s_is_last, s_tally[2], s_warp[kThreads / 32];
  extern __shared__ int s_lanes[];         // [6 B] when B <= kTile
  const int t = threadIdx.x;
  const int B = a.B, W = a.W, V = a.V;
  // ---- the probe: this block's partition of lanes, its tile of ways
  const int p0 = blockIdx.y * kTile;
  const bool in_part = t < B - p0;
  int bits = 6;
  while ((1 << bits) < 2 * min(B, kTile)) ++bits;
  const int mask = (1 << bits) - 1;
  // this thread's directory keys, all in flight while the key table builds
  const int w0 = blockIdx.x * kWaysPerBlock + t;
  int32_t dk[kWaysPerThread];
#pragma unroll
  for (int i = 0; i < kWaysPerThread; ++i)
    dk[i] = w0 + i * kThreads < W ? __ldg(a.dir_keys + w0 + i * kThreads) : 0;
  const int32_t key = in_part ? a.keys[p0 + t] : 0;
  for (int h = t; h <= mask; h += kThreads) {
    sm.probe.key[h] = kEmpty;
    sm.probe.way[h] = kNone;
  }
  if (B <= kTile && t < B) reset_key(s_lanes, B, t);  // the tail's, below
  if (t < 2) s_tally[t] = 0;
  __syncthreads();
  int mine = 0;                            // this lane's table entry
  if (in_part) {
    const u64 e = (u64)(uint32_t)key << 32 | (uint32_t)(p0 + t);
    int h = home(key, bits);
    for (;; h = (h + 1) & mask) {
      const u64 prev = atomicCAS(&sm.probe.key[h], kEmpty, e);
      if (prev == kEmpty) break;
      if ((uint32_t)(prev >> 32) == (uint32_t)key) {
        if (prev > e) atomicMin(&sm.probe.key[h], e);
        break;
      }
    }
    mine = h;
  }
  __syncthreads();
  // each directory key of this block's tile looked up once
#pragma unroll
  for (int i = 0; i < kWaysPerThread; ++i) {
    if (w0 + i * kThreads >= W) break;
    for (int h = home(dk[i], bits);; h = (h + 1) & mask) {
      const u64 e = sm.probe.key[h];
      if (e == kEmpty) break;
      if ((uint32_t)(e >> 32) == (uint32_t)dk[i]) {
        atomicMin(&sm.probe.way[h], w0 + i * kThreads);
        break;
      }
    }
  }
  __syncthreads();
  // one block holds every way in its table; more fold theirs into the
  // workspace, and the last to finish runs the tail
  const bool single = gridDim.x == 1 && gridDim.y == 1;
  int32_t* const lane_part = a.scratch;    // [B] partition first lanes
  if (!single) {
    for (int h = t; h <= mask; h += kThreads)
      if (sm.probe.way[h] != kNone)
        atomicMin(&a.ways[1 + (uint32_t)sm.probe.key[h]], sm.probe.way[h]);
    if (blockIdx.x == 0 && in_part)
      lane_part[p0 + t] = (int)(uint32_t)sm.probe.key[mine];
    __threadfence();
    __syncthreads();
    if (t == 0)
      s_is_last = atomicAdd(&a.ways[0], 1)
                  == (int)(gridDim.x * gridDim.y) - 1;
    __syncthreads();
    if (!s_is_last) return;
    if (t == 0) a.ways[0] = 0;             // every block has its ticket
  }

  // ---- the tail: one block, its first T threads (a thread a lane of a
  // tile, at least the tile's sorting network); the others leave
  const int T = B >= kTile ? kThreads : max(32, pow2_ceil(B));
  if (t >= T) return;
  const bool small = B <= kTile;           // one partition, one tile
  int32_t* const lanes = small ? s_lanes : a.scratch + B;
  int32_t* const lane_way = lanes + kWay * B;
  int32_t* const lane_first = lanes + kFirst * B;
  int32_t* const key_seen = a.scratch + 7 * B;  // an update in an earlier tile
  float* const carry = reinterpret_cast<float*>(a.scratch + 8 * B);  // [B, V]
  const int t_last = B > 0 ? (B - 1) / kTile * kTile : 0;  // the last tile
  // each lane's way and its key's first lane (one partition: the table's;
  // more: the least lane naming the way, an atomicMin into `firsts`), each
  // key's last lane, last hit and update lane and latest hit timestamp
  // (past one partition in a second pass, once `firsts` is complete); the
  // tallies (read after the last tile)
  int n_hit = 0, n_miss = 0;
  int my_part = 0;                         // this thread's lane in the last
  for (int i = t; i < B; i += kThreads) {  // tile: its partition first lane
    int first, way;
    if (single) {                          // i == t
      first = (int)(uint32_t)sm.probe.key[mine];
      way = sm.probe.way[mine];
    } else {
      first = my_part = __ldcg(lane_part + i);
      way = __ldcg(a.ways + 1 + first);
    }
    lane_way[i] = way;
    const bool valid = a.valid[i] != 0;
    n_hit += valid && way < W;
    n_miss += valid && way >= W;
    if (!small) {
      reset_key(lanes, B, i);
      if (way < W) atomicMin(a.firsts + way, i);
    } else if (way < W) {
      lane_first[i] = first;
      note_lane(lanes, B, first, i, valid, a.kind != kRead && !a.fire[i],
                a.ts[i]);
    } else {
      lane_first[i] = -1;
    }
  }
  n_hit = __reduce_add_sync(~0u, n_hit);
  n_miss = __reduce_add_sync(~0u, n_miss);
  if ((t & 31) == 0) {
    atomicAdd(&s_tally[0], n_hit);
    atomicAdd(&s_tally[1], n_miss);
  }
  sync_tail(T);
  if (!small) {                            // the keys past one partition
    for (int i = t; i < B; i += kThreads) {
      const int way = lane_way[i];
      if (way >= W) continue;
      const int f = __ldcg(a.firsts + way);
      lane_first[i] = f;
      note_lane(lanes, B, f, i, a.valid[i] != 0,
                a.kind != kRead && !a.fire[i], a.ts[i]);
    }
    sync_tail(T);
  }

  const volatile int32_t* const vlast = lanes + kLast * B;
  const float ident = a.kind == kMax ? -INFINITY : 0.f;
  float* const new_vals = reinterpret_cast<float*>(a.out + 3 * (int64_t)B + 2);
  int last_way = W, last_first = -1;       // this thread's lane of the last
  float last_ts = 0.f;                     // tile, for the write-back
  for (int t0 = 0; t0 < B; t0 += kTile) {
    const int nl = min(kTile, B - t0);
    const bool more = t0 + kTile < B;      // a key's state goes on
    // this thread's lane of the tile: its way, key, flags, row and first
    // weight, loads in flight while the tile sorts
    const int i = t0 + t;
    int way = W, first = -1;
    bool upd = false, multi = false;       // multi: the key has more lanes
    uint8_t fl = 0;
    float flag = 0.f, g0 = 0.f, w0 = 0.f, cur_ts = 0.f;
    if (t < nl) {
      way = lane_way[i];
      const bool hit = a.valid[i] && way < W;
      upd = hit && a.kind != kRead && !a.fire[i];
      if (way < W) {
        first = lane_first[i];
        multi = vlast[first] != first;
      }
      fl = (hit ? kHitLane : 0) | (upd ? kUpdLane : 0);
      // the row at the probe's way, valid or not, as the reference gathers
      // it; no row is written before the last tile
      const float* row = a.pages + (int64_t)(way < W ? way : W) * (V + 1);
      flag = row[0];
      if (V > 0) {
        g0 = row[1];
        if (upd) w0 = a.weights[(int64_t)i * V];
      }
      if (!more && hit) cur_ts = a.dir_ts[way];
      a.out[i] = hit;
      a.out[B + i] = hit ? way : W;
    }
    last_way = way;
    last_first = first;
    last_ts = cur_ts;
    // the lanes of keys with more than one lane, packed in lane order
    const unsigned ballot = __ballot_sync(~0u, multi);
    if ((t & 31) == 0) s_warp[t >> 5] = __popc(ballot);
    sync_tail(T);
    int G = 0, at = __popc(ballot & ((1u << (t & 31)) - 1));
    for (int w = 0; w < T / 32; ++w) {
      const int n = s_warp[w];
      G += n;
      if (w < t >> 5) at += n;
    }
    if (multi) sm.tail.sorted[0][at] = (Key)first << K::kShift | (Key)t;
    sync_tail(T);
    // sort them by (key's first lane, lane), a key's lanes into a run: a
    // bitonic network, its exchanges across warps through shared memory
    // (all threads at the barriers), within a warp by shuffles; the warps
    // past the packed lanes' power of two sit out
    Key e = t < G ? sm.tail.sorted[0][t] : K::kPad;
    const int S = max(32, pow2_ceil(G));
    int buf = 0;
    for (int k = 2; k <= S && G > 1; k <<= 1) {
      const bool up = (t & k) == 0;
      for (int j = k >> 1; j >= 32; j >>= 1) {
        if (t < S) sm.tail.sorted[buf][t] = e;
        sync_tail(T);
        if (t < S) e = exchange(e, sm.tail.sorted[buf][t ^ j], up, t & j);
        buf ^= 1;
      }
      if (t < S) {
#pragma unroll
        for (int j = 16; j > 0; j >>= 1)
          if (j < k) e = exchange(e, __shfl_xor_sync(~0u, e, j), up, t & j);
      }
    }
    const Key* const sorted = sm.tail.sorted[buf];
    sm.tail.sorted[buf][t] = e;
    if (multi) {
      sm.tail.way[t] = way;
      sm.tail.flags[t] = fl | (flag > 0.5f ? kRowFlag : 0);
      sm.tail.g0[t] = g0;
      sm.tail.w0[t] = w0;
    }
    sync_tail(T);
    // a lane alone with its key (or with no way) folds only itself
    if (t < nl && !multi) {
      const bool row_flag = flag > 0.5f;
      const bool present = row_flag || upd;
      const float* row = a.pages + (int64_t)(way < W ? way : W) * (V + 1);
      a.out[2 * B + i] = present;
      for (int c = 0; c < V; ++c) {
        float v = ident;
        if (upd) {
          const float x = c == 0 ? w0 : a.weights[(int64_t)i * V + c];
          v = a.kind == kMax ? fmaxf(v, x) : v + x;
        }
        const float g = c == 0 ? g0 : row[1 + c];
        float nv = a.kind == kMax ? fmaxf(row_flag ? g : -INFINITY, v)
                                  : (row_flag ? g : 0.f) + v;
        nv = present ? nv : 0.f;
        new_vals[(int64_t)i * V + c] = nv;
        if (c == 0) sm.tail.nv0[t] = nv;
      }
    }
    // position t of the sorted lanes takes its lane; its key's run in the
    // tile is [s, t]
    const bool real = t < G;
    const uint32_t fk = (uint32_t)(e >> K::kShift);
    const int lt = (int)(e & (kTile - 1));  // the lane's place in the tile
    const int li = t0 + lt;
    int s = t;
    bool last = false;
    if (real) {
      const Key lo_key = (Key)fk << K::kShift;
      int lo = 0, hi = t;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (sorted[mid] < lo_key) lo = mid + 1;
        else hi = mid;
      }
      s = lo;
      last = t + 1 == G || (uint32_t)(sorted[t + 1] >> K::kShift) != fk;
    }
    const bool earlier = real && fk < (uint32_t)t0;  // lanes in a tile
    //                                                  before this one
    uint8_t pfl = 0;
    int pway = W;
    float pg0 = 0.f;
    if (real) {
      pfl = sm.tail.flags[lt];
      pway = sm.tail.way[lt];
      pg0 = sm.tail.g0[lt];
      sm.tail.w[t] = sm.tail.w0[lt];
    }
    sm.tail.upd[t] = (pfl & kUpdLane) != 0;
    const bool seen = earlier && key_seen[fk] != 0;
    float v = earlier && V > 0 ? carry[(int64_t)fk * V] : ident;
    sync_tail(T);
    // the key's update lanes up to this one, in lane order (channel 0)
    bool has_upd = false;
    if (real)
      for (int q = s; q <= t; ++q)
        if (sm.tail.upd[q]) {
          has_upd = true;
          const float x = sm.tail.w[q];
          v = a.kind == kMax ? fmaxf(v, x) : v + x;
        }
    const bool row_flag = (pfl & kRowFlag) != 0;
    const bool present = row_flag || seen || has_upd;
    if (real) a.out[2 * B + li] = present;
    if (last && more) key_seen[fk] = seen || has_upd;
    const float* prow = a.pages + (int64_t)(pway < W ? pway : W) * (V + 1);
    for (int c = 0; c < V; ++c) {
      if (c > 0) {                         // channel c's weights, sorted
        sync_tail(T);
        if (real)
          sm.tail.w[t] = (pfl & kUpdLane) ? a.weights[(int64_t)li * V + c]
                                          : 0.f;
        v = earlier ? carry[(int64_t)fk * V + c] : ident;
        sync_tail(T);
        if (real)
          for (int q = s; q <= t; ++q)
            if (sm.tail.upd[q]) {
              const float x = sm.tail.w[q];
              v = a.kind == kMax ? fmaxf(v, x) : v + x;
            }
      }
      if (real) {
        if (last && more) carry[(int64_t)fk * V + c] = v;
        const float g = c == 0 ? pg0 : prow[1 + c];
        float nv = a.kind == kMax ? fmaxf(row_flag ? g : -INFINITY, v)
                                  : (row_flag ? g : 0.f) + v;
        nv = present ? nv : 0.f;
        new_vals[(int64_t)li * V + c] = nv;
        if (c == 0) sm.tail.nv0[lt] = nv;
      }
    }
  }
  sync_tail(T);                           // every row read before a write
  if (t == 0) {
    a.out[3 * B] = s_tally[0];
    a.out[3 * B + 1] = s_tally[1];
  }
  // a key's timestamp and dirty bit by its last hit and update lane, and
  // its row from its last update lane's new values; the workspace left
  // clean.  A thread's lane of the last tile is in its registers.
  const volatile int32_t* const vhit = lanes + kLastHit * B;
  const volatile int32_t* const vupd = lanes + kLastUpd * B;
  const volatile int32_t* const vts = lanes + kLatest * B;
  for (int i = t; i < B; i += kThreads) {
    const bool mine_last = i >= t_last;
    const int way = mine_last ? last_way : lane_way[i];
    if (way < W) {
      const int f = mine_last ? last_first : lane_first[i];
      if (vhit[f] == i)
        a.dir_ts[way] = fmaxf(mine_last ? last_ts : a.dir_ts[way],
                              unordered(vts[f]));
      if (vupd[f] == i) {
        a.dir_dirty[way] = 1;
        float* dst = a.pages + (int64_t)way * (V + 1);
        dst[0] = 1.f;
        if (V > 0)
          dst[1] = mine_last ? sm.tail.nv0[i - t_last]
                             : new_vals[(int64_t)i * V];
        for (int c = 1; c < V; ++c) dst[1 + c] = new_vals[(int64_t)i * V + c];
      }
      if (!small) a.firsts[way] = kNone;
    }
    if (!single)
      a.ways[1 + (mine_last ? my_part : __ldcg(lane_part + i))] = kNone;
  }
  if (a.kind != kRead)
    for (int c = t; c <= V; c += T) a.pages[(int64_t)W * (V + 1) + c] = 0.f;
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

template <typename Key>
int launch_step(const StepArgs& a, void* stream) {
  // the tail's lane arrays, in shared memory while one tile holds the batch
  const size_t smem = a.B <= kTile ? sizeof(int32_t) * kLaneArrays * a.B : 0;
  static bool opted_in = false;            // beyond 48 KB with the static
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_step_kernel<Key>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(int32_t) * kLaneArrays * kTile));
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  const dim3 grid(a.W > 0 ? (a.W + kWaysPerBlock - 1) / kWaysPerBlock : 1,
                  a.B > 0 ? (a.B + kTile - 1) / kTile : 1);
  fused_step_kernel<Key><<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Lanes of a probe partition and of a tail tile.
int tac_fused_tile() { return kTile; }

// Blocks of a step launch over B lanes and W ways: the probe's (tiles of
// ways) x (partitions of lanes).
int tac_fused_step_blocks(int B, int W) {
  const int tiles = W > 0 ? (W + kWaysPerBlock - 1) / kWaysPerBlock : 1;
  const int parts = B > 0 ? (B + kTile - 1) / kTile : 1;
  return tiles * parts;
}

// Returns a CUDA error code; cudaErrorInvalidValue for a negative size or
// an unknown kind.  `ways` holds 1 + B int32: 0 then kNone; `firsts` W
// int32 at kNone when B > kTile; every launch leaves both so.  `scratch`
// holds B int32, and 8 B + B V when B > kTile; it needs no contents.
int tac_fused_step(const void* keys, const void* ts, const void* weights,
                   const void* fire, const void* valid, const void* dir_keys,
                   void* dir_ts, void* dir_dirty, void* pages, void* out,
                   void* ways, void* firsts, void* scratch, int B, int W,
                   int V, int kind, void* stream) {
  if (B < 0 || W < 0 || V < 0 || kind < kSum || kind > kRead)
    return (int)cudaErrorInvalidValue;
  StepArgs a{(const int32_t*)keys, (const float*)ts, (const float*)weights,
             (const uint8_t*)fire, (const uint8_t*)valid,
             (const int32_t*)dir_keys, (float*)dir_ts, (uint8_t*)dir_dirty,
             (float*)pages, (int32_t*)out, (int32_t*)ways, (int32_t*)firsts,
             (int32_t*)scratch, B, W, V, kind};
  return B < 1 << 22 ? launch_step<uint32_t>(a, stream)
                     : launch_step<u64>(a, stream);
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
