// Paged single-token decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/decode_attention/decode_attention.py:
// paged_decode_attention_kernel, the Pallas kernel whose grid walks
// (sequence, page) in order, dereferences the page table from scalar-prefetch
// memory and keeps the online-softmax state in VMEM scratch.
//
// Computes, per sequence row b and query head h: attention of q[b, h, :]
// over the first seq_lens[b] positions of the row's K/V history, stored as
// pages k_pages[page_table[b, p]] ([page, d]) and v_pages[page_table[b, p]]
// ([page, dv]); keys and values may differ in width (a paged MLA latent
// cache: d 576, dv 512).  A score is the fp32 dot divided by sqrt(d) after
// the dot (the wrapper passes 1/sqrt(d) as inv_scale); the
// softmax is online with fp32 accumulation; out = acc / max(l, 1e-30), so a
// row of length 0 gives zeros.  Pages at or past seq_len are never read
// (their table entries may be -1).  One KV head is shared by all H query
// heads: a caller with grouped-query attention folds the KV heads into the
// rows (rows = sequences x KV heads, H = query heads per KV head).
//
// Bound: bytes.  Every K and V element below seq_len is read once and takes
// part in 2 * H flops; at H = 5 query heads per KV head that is about 2.5
// flops per byte of bf16 K/V, far below the ~295 the card needs before its
// arithmetic binds.
//
// Design: split-K over pages, two passes.  Pass 1: one block of 128
// threads per (row, chunk of query heads, split), where a split is a
// contiguous range of the row's page table; the wrapper picks the number of
// splits so that few rows still fill the card's SMs and many rows fill
// whole waves of resident blocks.  Each block keeps a running max, sum and
// [heads, D] accumulator in fp32.  With one split it writes
// out = acc / max(l, 1e-30); otherwise its (max, sum, accumulator) go to
// fp32 scratch and pass 2, one block per (row, head), combines the splits
// in order with log-sum-exp weights.  A split whose pages all lie at or
// past seq_len reads nothing and writes m = -1e30, l = 0, so a row of
// length 0 still gives zeros.  No atomics: the result is the same from run
// to run.
//
// Instances and routes (the wrapper's decode_attention.instance picks one;
// every route reads the pool in place, at its own row widths d and dv):
//   0  float32 at d = dv in {16, 32, 64, 128}: decode_kernel below;
//   1  bfloat16 with rows of whole 16-byte chunks (d, dv multiples of 8)
//      up to 256: decode_bf16_kernel<D> for d, dv <= D in {16, 32, 64,
//      128}, and decode_wide_kernel<256, 256>, whose Q and accumulator do
//      not fit registers at that width;
//   2  any other width up to (576, 512), either type, at up to 4 query
//      heads a row: decode_lanes_kernel, a warp a token and a column of
//      32 a lane, scalar loads, each K and V byte read once a 4 heads;
//   3  past (576, 512), and up to it past 4 heads a row, float32 and
//      bfloat16 rows that are not whole 16-byte chunks:
//      decode_walk_kernel, route 4's plan on the tensor cores in TF32
//      (float32 as three products of split operands), rows of any
//      alignment copied as the 16-byte windows that cover them;
//   4  past (576, 512), bfloat16 at d, dv multiples of 8:
//      decode_walk_tc_kernel, 16 heads a block on the tensor cores, K and
//      V walked through a ring of cp.async entries, each byte read once
//      up to dv = kWtCols;
//   5  bfloat16 at d, dv multiples of 8 past 256 up to (576, 512), MLA's
//      latent: decode_wgmma_kernel, 64 heads a block on wgmma, each K and
//      V byte read once a (row, 64 heads).
// Columns of an instance past d (or dv) are zero in shared memory and
// registers, never read from the pool; q is zero-padded to DK by the
// wrapper for route 1 (a copy of q only).  Rows of many heads: a block of
// routes 3 and 5 takes a chunk of a row's heads, and the chunks of a (row,
// split) are neighbours in the grid, so that the row's tokens come from
// device memory about once and from the L2 for the other chunks.
//
// bfloat16 runs pass 1 on the tensor cores (decode_bf16_kernel: 16 heads a
// block as the rows of mma.sync, K/V tiles staged by cp.async).  float32 at
// the square widths stays on the CUDA cores, since its 2e-5 tolerance rules
// out one TF32 product (decode_kernel: up to 8 heads a block; a "worker"
// of D / 4 lanes owns one token at a time, each lane loading one 16-byte
// vector of the token's K row and one of its V row, the group summing its
// partial dots with shuffles; every worker keeps its own softmax state in
// registers over the tokens it owns, four tokens a step so that eight
// 16-byte loads are in flight per lane, and the workers' states are merged
// through shared memory).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 4;           // tokens per worker per step
constexpr float kNegInf = -1e30f;    // the Pallas kernel's NEG_INF

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static uint4 load(const float* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ static void cvt(const uint4& v, float* x) {
    x[0] = __uint_as_float(v.x);
    x[1] = __uint_as_float(v.y);
    x[2] = __uint_as_float(v.z);
    x[3] = __uint_as_float(v.w);
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Pass 1.  With out != nullptr (one split) writes the normalised output;
// otherwise part_m/part_l [B, H, n_splits] and part_acc [B, H, n_splits, D].
template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
              const T* __restrict__ v_pages,
              const int32_t* __restrict__ table,
              const int32_t* __restrict__ seq_lens, T* __restrict__ out,
              float* __restrict__ part_m, float* __restrict__ part_l,
              float* __restrict__ part_acc, int H, int P, int page,
              int n_slots, int split_pages) {
  constexpr int E = Vec16<T>::N;        // elements per lane
  constexpr int LPT = D / E;            // lanes per worker
  static_assert(LPT >= 1 && LPT <= 32 && 32 % LPT == 0, "head dim");
  constexpr int NW = kThreads / LPT;    // workers per block
  constexpr int STEP = NW * kUnroll;    // tokens per block step
  __shared__ float q_s[G * D];
  __shared__ float m_s[NW * G];
  __shared__ float l_s[NW * G];
  __shared__ float acc_s[NW * G * D];

  const int row = blockIdx.x;
  const int h0 = blockIdx.y * G;
  const int split = blockIdx.z;
  const int n_splits = gridDim.z;
  const int gn = min(G, H - h0);        // heads of this chunk
  const int worker = threadIdx.x / LPT;
  const int sub = threadIdx.x % LPT;    // which 16-byte vector of the row
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    q_s[i] = g < gn ? to_f32(q[((int64_t)row * H + h0 + g) * D + i % D])
                    : 0.f;
  }
  __syncthreads();

  const float inv_scale = 1.f / sqrtf((float)D);
  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }
  const int len = seq_lens[row];
  const int32_t* trow = table + (int64_t)row * P;
  const int n_pages = len <= 0 ? 0 : min(P, (len + page - 1) / page);
  const int p_end = min(n_pages, (split + 1) * split_pages);
  const int64_t page_elems = (int64_t)page * D;
  for (int pi = split * split_pages; pi < p_end; ++pi) {
    const int slot = trow[pi];
    if (slot < 0 || slot >= n_slots) continue;   // the wrapper raises first
    const int n_valid = min(page, len - pi * page);
    const T* kb = k_pages + slot * page_elems + sub * E;
    const T* vb = v_pages + slot * page_elems + sub * E;
    // block-uniform trip count: every lane reaches every shuffle
    for (int base = 0; base < n_valid; base += STEP) {
      uint4 kr[kUnroll], vr[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = base + worker * kUnroll + u;
        ok[u] = t < n_valid;
        kr[u] = vr[u] = make_uint4(0u, 0u, 0u, 0u);
        if (ok[u]) {
          kr[u] = Vec16<T>::load(kb + (int64_t)t * D);
          vr[u] = Vec16<T>::load(vb + (int64_t)t * D);
        }
      }
      float s[kUnroll][G];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float kx[E];
        Vec16<T>::cvt(kr[u], kx);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (g >= gn) break;                     // uniform in the block
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e)
            part = fmaf(q_s[g * D + sub * E + e], kx[e], part);
#pragma unroll
          for (int off = LPT / 2; off > 0; off >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, off);
          s[u][g] = part * inv_scale;
        }
      }
      // s becomes p = exp(s - m_new) in place; the accumulator is
      // rescaled once a step, then each token's V row is widened once
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g >= gn) break;
        float mn = m[g];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (ok[u]) mn = fmaxf(mn, s[u][g]);
        const float alpha = expf(m[g] - mn);
        float ps = 0.f;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          s[u][g] = ok[u] ? expf(s[u][g] - mn) : 0.f;
          ps += s[u][g];
        }
        l[g] = l[g] * alpha + ps;
        m[g] = mn;
#pragma unroll
        for (int e = 0; e < E; ++e) acc[g][e] *= alpha;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float vx[E];
        Vec16<T>::cvt(vr[u], vx);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (g >= gn) break;
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[g][e] = fmaf(s[u][g], vx[e], acc[g][e]);
        }
      }
    }
  }

  // merge the workers' (max, sum, accumulator) states
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (sub == 0) {
      m_s[worker * G + g] = m[g];
      l_s[worker * G + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      acc_s[(worker * G + g) * D + sub * E + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gn * D; i += kThreads) {
    const int g = i / D;
    const int c = i % D;
    float M = kNegInf;
    for (int w = 0; w < NW; ++w) M = fmaxf(M, m_s[w * G + g]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float sc = expf(m_s[w * G + g] - M);
      L = fmaf(l_s[w * G + g], sc, L);
      A = fmaf(acc_s[(w * G + g) * D + c], sc, A);
    }
    const int64_t rh = (int64_t)row * H + h0 + g;
    if (out != nullptr) {
      store(out + rh * D + c, A / fmaxf(L, 1e-30f));
    } else {
      part_acc[(rh * n_splits + split) * D + c] = A;
      if (c == 0) {
        part_m[rh * n_splits + split] = M;
        part_l[rh * n_splits + split] = L;
      }
    }
  }
}

// Pass 1 for bfloat16, on the tensor cores: one block of 4 warps per (row,
// chunk of up to 16 query heads, split), at any d, dv <= D that are
// multiples of 8 (q zero-padded to D rows by the wrapper; K and V columns
// past d and dv zero-filled, not read).  The split's tokens go through
// shared memory in tiles of kTile, double-buffered with cp.async: a tile's
// row offsets (page table, page, position) are computed one tile ahead,
// one thread a token, and every 16-byte chunk of K and V is copied by
// address, zero-filled past the split's end or for a slot outside the
// pool (whose positions then score 0: the wrapper rejects such tables, the
// kernel only stays inside the pool).  Warp w takes tokens 16 w .. 16 w +
// 15 of each tile: S = Q K^T on mma.sync.m16n8k16 with the heads as the 16
// rows (Q's fragments held in registers), the online softmax on the
// fragments, P in bf16 as the A operand of P V, V through ldmatrix.trans;
// the four warps' states are merged through shared memory at the end.
constexpr int kTile = 64;            // tokens a tile, 16 a warp
constexpr int kHeads = 16;           // query heads a block (mma rows)

template <int D>
constexpr int bf16_smem_bytes() {
  // two stages of K and V tiles, then the row offsets of two tiles; the
  // warps' merge reuses the tiles' space (4 x 16 x D floats + m and l)
  return 2 * 2 * kTile * (D + 8) * 2 + 2 * kTile * 8;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
decode_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k_pages,
                   const __nv_bfloat16* __restrict__ v_pages,
                   const int32_t* __restrict__ table,
                   const int32_t* __restrict__ seq_lens,
                   __nv_bfloat16* __restrict__ out,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, int H, int P, int page,
                   int n_slots, int split_pages, int d, int dv,
                   float inv_scale) {
  static_assert(D % 16 == 0 && 4 * kHeads * D * 4 + 8 * kHeads * 4
                <= 2 * 2 * kTile * (D + 8) * 2, "merge space");
  constexpr int DP = D + 8;            // padded row (16 bytes)
  constexpr int NO = D / 8;            // output n-tiles
  constexpr int CPR = D / 8;           // 16-byte chunks a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* v_s = k_s + 2 * kTile * DP;
  int64_t* off_s = reinterpret_cast<int64_t*>(v_s + 2 * kTile * DP);

  const int row = blockIdx.x;
  const int h0 = blockIdx.y * kHeads;
  const int split = blockIdx.z;
  const int n_splits = gridDim.z;
  const int gn = min(kHeads, H - h0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const float sl2 = 1.4426950408889634f * inv_scale;

  // Q's A fragments: heads g and g + 8 (zero past the chunk's heads)
  uint32_t qa[D / 16][4];
  const __nv_bfloat16* qrow = q + ((int64_t)row * H + h0) * D;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int hh = g + 8 * (i & 1);
      const int c = kk * 16 + tig * 2 + 8 * (i >> 1);
      qa[kk][i] = hh < gn
          ? *reinterpret_cast<const uint32_t*>(qrow + hh * D + c) : 0u;
    }

  const int len = seq_lens[row];
  const int32_t* trow = table + (int64_t)row * P;
  const int n_pages = len <= 0 ? 0 : min(P, (len + page - 1) / page);
  const int t_begin = split * split_pages * page;
  const int t_end = min(min(n_pages, (split + 1) * split_pages) * page, len);
  const int n_tiles = t_end > t_begin ? (t_end - t_begin + kTile - 1) / kTile
                                      : 0;

  auto offsets = [&](int tile) {       // a thread a token: its pool row
    if (threadIdx.x < kTile) {
      const int t = t_begin + tile * kTile + threadIdx.x;
      int64_t off = -1;
      if (t < t_end) {
        const int pi = t / page;
        const int slot = trow[pi];
        if (slot >= 0 && slot < n_slots)
          off = (int64_t)slot * page + (t - pi * page);
      }
      off_s[(tile & 1) * kTile + threadIdx.x] = off;
    }
  };
  auto issue = [&](int tile) {
    const int st = tile & 1;
    for (int c = threadIdx.x; c < kTile * CPR; c += kThreads) {
      const int r = c / CPR, col = (c % CPR) * 8;
      const int64_t off = off_s[st * kTile + r];
      const bool kok = off >= 0 && col < d, vok = off >= 0 && col < dv;
      cp_async16(smem_addr(k_s + (st * kTile + r) * DP + col),
                 k_pages + (kok ? off * d + col : 0), kok);
      cp_async16(smem_addr(v_s + (st * kTile + r) * DP + col),
                 v_pages + (vok ? off * dv + col : 0), vok);
    }
    cp_async_commit();
  };

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // heads g and g + 8, log2 units
  float l[2] = {0.f, 0.f};              // this thread's part of the sums
  // ldmatrix lane offsets: K rows (tokens) lane % 8 + 8 * (lane / 16),
  // column half (lane / 8) % 2; V^T tokens lane % 8 + 8 * ((lane / 8) % 2),
  // column half lane / 16
  const int k_off = (warp * 16 + lane % 8 + 8 * (lane / 16)) * DP
                    + ((lane / 8) % 2) * 8;
  const int v_off = (warp * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * DP
                    + (lane / 16) * 8;

  if (n_tiles > 0) {
    offsets(0);
    __syncthreads();
    issue(0);
  }
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) offsets(tile + 1);
    cp_async_wait<0>();
    __syncthreads();                   // tile landed, next offsets visible
    if (tile + 1 < n_tiles) issue(tile + 1);
    const int st = tile & 1;
    const __nv_bfloat16* kt = k_s + st * kTile * DP;
    const __nv_bfloat16* vt = v_s + st * kTile * DP;
    const int t0 = t_begin + tile * kTile + warp * 16;

    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t bk[4];
      ldsm_x4(bk, smem_addr(kt + k_off + kk * 16));
      mma_bf16(s[0], qa[kk], bk[0], bk[1]);
      mma_bf16(s[1], qa[kk], bk[2], bk[3]);
    }
    if (t0 + 16 > t_end) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (t0 + j * 8 + tig * 2 + (e & 1) >= t_end) s[j][e] = -INFINITY;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                       fmaxf(s[1][2 * r], s[1][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * sl2);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[r] - m_use);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[j][2 * r] = exp2f(fmaf(s[j][2 * r], sl2, -m_use));
        s[j][2 * r + 1] = exp2f(fmaf(s[j][2 * r + 1], sl2, -m_use));
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }
    uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                      pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int j = 0; j < NO; j += 2) {
      uint32_t bv[4];
      ldsm_x4_t(bv, smem_addr(vt + v_off + j * 8));
      mma_bf16(o[j], pa, bv[0], bv[1]);
      mma_bf16(o[j + 1], pa, bv[2], bv[3]);
    }
  }

  // merge the warps' states: [warp][head] max and sum, [warp][head][D] O
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __syncthreads();                     // the tiles' space is free
  float* o_s = reinterpret_cast<float*>(smem_raw);       // [4][16][D]
  float* m_s = o_s + 4 * kHeads * D;                     // [4][16]
  float* l_s = m_s + 4 * kHeads;                         // [4][16]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int hh = g + 8 * r;
    if (tig == 0) {
      m_s[warp * kHeads + hh] = m[r];
      l_s[warp * kHeads + hh] = l[r];
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o_s[(warp * kHeads + hh) * D + j * 8 + tig * 2] = o[j][2 * r];
      o_s[(warp * kHeads + hh) * D + j * 8 + tig * 2 + 1] = o[j][2 * r + 1];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gn * dv; i += kThreads) {
    const int hh = i / dv, c = i % dv;
    float M = -INFINITY;
    for (int w = 0; w < 4; ++w) M = fmaxf(M, m_s[w * kHeads + hh]);
    float L = 0.f, A = 0.f;
    if (M != -INFINITY) {
      for (int w = 0; w < 4; ++w) {
        const float sc = exp2f(m_s[w * kHeads + hh] - M);
        L = fmaf(l_s[w * kHeads + hh], sc, L);
        A = fmaf(o_s[(w * kHeads + hh) * D + c], sc, A);
      }
    }
    const int64_t rh = (int64_t)row * H + h0 + hh;
    if (out != nullptr) {
      out[rh * dv + c] = __float2bfloat16(A / fmaxf(L, 1e-30f));
    } else {
      part_acc[(rh * n_splits + split) * dv + c] = A;
      if (c == 0) {                    // the max in natural-log units
        part_m[rh * n_splits + split] =
            M == -INFINITY ? kNegInf : M * 0.6931471805599453f;
        part_l[rh * n_splits + split] = L;
      }
    }
  }
}

// Pass 1 for bfloat16 at wide rows, on the tensor cores: (256, 256).  Q
// fragments of 16 heads at d 256 would take 64 registers a thread and the
// [16, dv] accumulator 128, so here Q sits
// in shared memory (read by ldmatrix each k-step) and the four warps split
// the accumulator's columns instead of the tokens: warp w scores tokens
// 8 w .. 8 w + 7 of each tile of kWideTile for all 16 heads (S = Q K^T on
// mma.sync.m16n8k16), the tile's per-head maximum is taken across the
// warps through shared memory, so that all warps keep one running max;
// each warp writes its probabilities to shared memory as bf16 and then
// adds P V for its DV / 4 value columns over all the tile's tokens.  The
// running sum is kept per warp (of its tokens) and summed at the end.  K
// and V tiles are double-buffered with cp.async as in decode_bf16_kernel.
// Per block at (256, 256): Q 16 x 264, K 2 x 32 x 264, V 2 x 32 x 264 and
// P 16 x 40 bf16, 78,080 bytes of shared memory with the offsets and
// sums, so an SM holds two blocks.
constexpr int kWideTile = 32;        // tokens a tile, 8 a warp

template <int DK, int DV>
constexpr int wide_smem_bytes() {
  // Q [16][DK + 8], two stages of K [32][DK + 8] and V [32][DV + 8], P
  // [16][40] bf16; the row offsets of two tiles; [4][16] fp32 a warp's
  // maxima, then its sums
  return 2 * (kHeads * (DK + 8) + 2 * kWideTile * (DK + 8)
              + 2 * kWideTile * (DV + 8) + kHeads * (kWideTile + 8))
         + 2 * kWideTile * 8 + 4 * kHeads * 4;
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
decode_wide_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k_pages,
                   const __nv_bfloat16* __restrict__ v_pages,
                   const int32_t* __restrict__ table,
                   const int32_t* __restrict__ seq_lens,
                   __nv_bfloat16* __restrict__ out,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, int H, int P, int page,
                   int n_slots, int split_pages, int d, int dv,
                   float inv_scale) {
  static_assert(DK % 32 == 0 && DV % 64 == 0, "widths");
  constexpr int KP = DK + 8, VP = DV + 8;   // padded rows (16 bytes)
  constexpr int PP = kWideTile + 8;
  constexpr int CK = DK / 8, CV = DV / 8;   // 16-byte chunks a row
  constexpr int NO = DV / 32;               // a warp's output n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kHeads * KP;            // [2][tile][KP]
  __nv_bfloat16* v_s = k_s + 2 * kWideTile * KP;     // [2][tile][VP]
  __nv_bfloat16* p_s = v_s + 2 * kWideTile * VP;     // [16][PP]
  int64_t* off_s = reinterpret_cast<int64_t*>(p_s + kHeads * PP);
  float* red_s = reinterpret_cast<float*>(off_s + 2 * kWideTile);  // [4][16]

  const int row = blockIdx.x;
  const int h0 = blockIdx.y * kHeads;
  const int split = blockIdx.z;
  const int n_splits = gridDim.z;
  const int gn = min(kHeads, H - h0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const float sl2 = 1.4426950408889634f * inv_scale;
  const int col0 = warp * (DV / 4);         // this warp's value columns

  const int len = seq_lens[row];
  const int32_t* trow = table + (int64_t)row * P;
  const int n_pages = len <= 0 ? 0 : min(P, (len + page - 1) / page);
  const int t_begin = split * split_pages * page;
  const int t_end = min(min(n_pages, (split + 1) * split_pages) * page, len);
  const int n_tiles = t_end > t_begin
      ? (t_end - t_begin + kWideTile - 1) / kWideTile : 0;

  auto offsets = [&](int tile) {       // a thread a token: its pool row
    if (threadIdx.x < kWideTile) {
      const int t = t_begin + tile * kWideTile + threadIdx.x;
      int64_t off = -1;
      if (t < t_end) {
        const int pi = t / page;
        const int slot = trow[pi];
        if (slot >= 0 && slot < n_slots)
          off = (int64_t)slot * page + (t - pi * page);
      }
      off_s[(tile & 1) * kWideTile + threadIdx.x] = off;
    }
  };
  auto issue = [&](int tile) {
    const int st = tile & 1;
    for (int c = threadIdx.x; c < kWideTile * CK; c += kThreads) {
      const int r = c / CK, col = (c % CK) * 8;
      const int64_t off = off_s[st * kWideTile + r];
      const bool ok = off >= 0 && col < d;
      cp_async16(smem_addr(k_s + (st * kWideTile + r) * KP + col),
                 k_pages + (ok ? off * d + col : 0), ok);
    }
    for (int c = threadIdx.x; c < kWideTile * CV; c += kThreads) {
      const int r = c / CV, col = (c % CV) * 8;
      const int64_t off = off_s[st * kWideTile + r];
      const bool ok = off >= 0 && col < dv;
      cp_async16(smem_addr(v_s + (st * kWideTile + r) * VP + col),
                 v_pages + (ok ? off * dv + col : 0), ok);
    }
    cp_async_commit();
  };

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // heads g and g + 8, log2 units
  float l[2] = {0.f, 0.f};              // this thread's part of the sums
  // ldmatrix lane offsets: Q rows lane % 16, column half lane / 16; K rows
  // (tokens) lane % 8, column eighth lane / 8 (two k-steps an x4); P rows
  // lane % 16, column half lane / 16; V^T tokens lane % 8 + 8 ((lane / 8)
  // % 2), column half lane / 16
  const int q_off = (lane % 16) * KP + (lane / 16) * 8;
  const int k_off = (warp * 8 + lane % 8) * KP + (lane / 8) * 8;
  const int p_off = (lane % 16) * PP + (lane / 16) * 8;
  const int v_off = (lane % 8 + 8 * ((lane / 8) % 2)) * VP + (lane / 16) * 8
                    + col0;

  if (n_tiles > 0) {
    const __nv_bfloat16* qrow = q + ((int64_t)row * H + h0) * DK;
    for (int c = threadIdx.x; c < kHeads * CK; c += kThreads) {
      const int hh = c / CK, col = (c % CK) * 8;
      cp_async16(smem_addr(q_s + hh * KP + col),
                 qrow + (hh < gn ? hh * DK + col : 0), hh < gn);
    }
    offsets(0);
    __syncthreads();
    issue(0);                          // Q joins the first tile's group
  }
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) offsets(tile + 1);
    cp_async_wait<0>();
    __syncthreads();                   // tile landed, next offsets visible
    if (tile + 1 < n_tiles) issue(tile + 1);
    const int st = tile & 1;
    const __nv_bfloat16* kt = k_s + st * kWideTile * KP;
    const __nv_bfloat16* vt = v_s + st * kWideTile * VP;
    const int t0 = t_begin + tile * kWideTile + warp * 8;

    // S: the 16 heads x this warp's 8 tokens
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int kk = 0; kk < DK / 16; kk += 2) {
      uint32_t a0[4], a1[4], bk[4];
      ldsm_x4(bk, smem_addr(kt + k_off + kk * 16));
      ldsm_x4(a0, smem_addr(q_s + q_off + kk * 16));
      ldsm_x4(a1, smem_addr(q_s + q_off + kk * 16 + 16));
      mma_bf16(s, a0, bk[0], bk[1]);
      mma_bf16(s, a1, bk[2], bk[3]);
    }
    if (t0 + 8 > t_end) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (t0 + tig * 2 + (e & 1) >= t_end) s[e] = -INFINITY;
    }
    // the tile's maximum of each head over the four warps
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(s[2 * r], s[2 * r + 1]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      if (tig == 0) red_s[warp * kHeads + g + 8 * r] = mx;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int hh = g + 8 * r;
      float mx = red_s[hh];
#pragma unroll
      for (int w = 1; w < 4; ++w) mx = fmaxf(mx, red_s[w * kHeads + hh]);
      const float m_new = fmaxf(m[r], mx * sl2);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[r] - m_use);
      m[r] = m_new;
      const float p0 = exp2f(fmaf(s[2 * r], sl2, -m_use));
      const float p1 = exp2f(fmaf(s[2 * r + 1], sl2, -m_use));
      l[r] = l[r] * alpha + p0 + p1;
      *reinterpret_cast<uint32_t*>(p_s + hh * PP + warp * 8 + tig * 2) =
          pack_bf16(p0, p1);
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }
    __syncthreads();                   // P of all the tile's tokens
    // O[:, this warp's columns] += P V
#pragma unroll
    for (int kk = 0; kk < kWideTile / 16; ++kk) {
      uint32_t pa[4];
      ldsm_x4(pa, smem_addr(p_s + p_off + kk * 16));
#pragma unroll
      for (int j = 0; j < NO; j += 2) {
        uint32_t bv[4];
        ldsm_x4_t(bv, smem_addr(vt + kk * 16 * VP + v_off + j * 8));
        mma_bf16(o[j], pa, bv[0], bv[1]);
        mma_bf16(o[j + 1], pa, bv[2], bv[3]);
      }
    }
  }

  // the sums: over the quad, then over the warps (all share the max)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (tig == 0) red_s[warp * kHeads + g + 8 * r] = l[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int hh = g + 8 * r;
    if (hh >= gn) continue;
    const float L = red_s[hh] + red_s[kHeads + hh] + red_s[2 * kHeads + hh]
                    + red_s[3 * kHeads + hh];
    const int64_t rh = (int64_t)row * H + h0 + hh;
    if (out != nullptr) {
      const float inv = 1.f / fmaxf(L, 1e-30f);
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const int c = col0 + j * 8 + tig * 2;
        if (c < dv)
          *reinterpret_cast<__nv_bfloat162*>(out + rh * dv + c) =
              __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
      }
    } else {
      float* acc = part_acc + (rh * n_splits + split) * dv;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const int c = col0 + j * 8 + tig * 2;
        if (c < dv) {
          acc[c] = o[j][2 * r];
          acc[c + 1] = o[j][2 * r + 1];
        }
      }
      if (warp == 0 && tig == 0) {     // the max in natural-log units
        part_m[rh * n_splits + split] =
            m[r] == -INFINITY ? kNegInf : m[r] * 0.6931471805599453f;
        part_l[rh * n_splits + split] = L;
      }
    }
  }
}

// Pass 1 on the CUDA cores at any widths d <= 32 KC, dv <= 32 VC (route
// 2: float32 outside decode_kernel's instances, bfloat16 rows that are not
// whole 16-byte chunks): kLaneHeads query heads a block, each warp a token
// at a time (kLaneUnroll tokens a step), lane l holding key columns l, l +
// 32, ... and value columns alike, read as scalars in place (any width,
// any alignment: neighbouring lanes read neighbouring elements); the
// lanes' partial dots are summed with shuffles, each warp keeps its own
// softmax state over its tokens, and the warps' states are merged through
// shared memory.  A fallback for widths no model of the zoo uses: no
// vector loads, no tensor cores.
constexpr int kLaneHeads = 4;
constexpr int kLaneUnroll = 2;

template <typename T, int KC, int VC>
__global__ void __launch_bounds__(kThreads)
decode_lanes_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int32_t* __restrict__ table,
                    const int32_t* __restrict__ seq_lens, T* __restrict__ out,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int H, int P, int page,
                    int n_slots, int split_pages, int d, int dv,
                    float inv_scale) {
  constexpr int G = kLaneHeads, U = kLaneUnroll, NW = kThreads / 32;
  constexpr int STEP = NW * U;          // tokens a block step
  __shared__ float q_s[G * 32 * KC];
  __shared__ float m_s[NW * G];
  __shared__ float l_s[NW * G];
  __shared__ float acc_s[NW * G * 32 * VC];

  const int row = blockIdx.x;
  const int h0 = blockIdx.y * G;
  const int split = blockIdx.z;
  const int n_splits = gridDim.z;
  const int gn = min(G, H - h0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < G * 32 * KC; i += kThreads) {
    const int hh = i / (32 * KC), c = i % (32 * KC);
    q_s[i] = hh < gn && c < d
        ? to_f32(q[((int64_t)row * H + h0 + hh) * d + c]) : 0.f;
  }
  __syncthreads();

  float m[G], l[G], acc[G][VC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < VC; ++c) acc[g][c] = 0.f;
  }
  const int len = seq_lens[row];
  const int32_t* trow = table + (int64_t)row * P;
  const int n_pages = len <= 0 ? 0 : min(P, (len + page - 1) / page);
  const int p_end = min(n_pages, (split + 1) * split_pages);
  for (int pi = split * split_pages; pi < p_end; ++pi) {
    const int slot = trow[pi];
    if (slot < 0 || slot >= n_slots) continue;   // the wrapper raises first
    const int n_valid = min(page, len - pi * page);
    const int64_t tok0 = (int64_t)slot * page;
    // block-uniform trip count: every lane reaches every shuffle
    for (int base = 0; base < n_valid; base += STEP) {
      float kx[U][KC], vx[U][VC];
      bool ok[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = base + warp * U + u;
        ok[u] = t < n_valid;
        const T* kr = k_pages + (tok0 + t) * d;
        const T* vr = v_pages + (tok0 + t) * dv;
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          const int col = lane + 32 * c;
          kx[u][c] = ok[u] && col < d ? to_f32(kr[col]) : 0.f;
        }
#pragma unroll
        for (int c = 0; c < VC; ++c) {
          const int col = lane + 32 * c;
          vx[u][c] = ok[u] && col < dv ? to_f32(vr[col]) : 0.f;
        }
      }
      float s[U][G];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float part = 0.f;
#pragma unroll
          for (int c = 0; c < KC; ++c)
            part = fmaf(q_s[g * 32 * KC + lane + 32 * c], kx[u][c], part);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, off);
          s[u][g] = part * inv_scale;
        }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mn = m[g];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (ok[u]) mn = fmaxf(mn, s[u][g]);
        const float alpha = expf(m[g] - mn);
        float ps = 0.f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          s[u][g] = ok[u] ? expf(s[u][g] - mn) : 0.f;
          ps += s[u][g];
        }
        l[g] = l[g] * alpha + ps;
        m[g] = mn;
#pragma unroll
        for (int c = 0; c < VC; ++c) {
          float a = acc[g][c] * alpha;
#pragma unroll
          for (int u = 0; u < U; ++u) a = fmaf(s[u][g], vx[u][c], a);
          acc[g][c] = a;
        }
      }
    }
  }

  // merge the warps' (max, sum, accumulator) states
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      m_s[warp * G + g] = m[g];
      l_s[warp * G + g] = l[g];
    }
#pragma unroll
    for (int c = 0; c < VC; ++c)
      acc_s[(warp * G + g) * 32 * VC + lane + 32 * c] = acc[g][c];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gn * dv; i += kThreads) {
    const int g = i / dv, c = i % dv;
    float M = kNegInf;
    for (int w = 0; w < NW; ++w) M = fmaxf(M, m_s[w * G + g]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float sc = expf(m_s[w * G + g] - M);
      L = fmaf(l_s[w * G + g], sc, L);
      A = fmaf(acc_s[(w * G + g) * 32 * VC + c], sc, A);
    }
    const int64_t rh = (int64_t)row * H + h0 + g;
    if (out != nullptr) {
      store(out + rh * dv + c, A / fmaxf(L, 1e-30f));
    } else {
      part_acc[(rh * n_splits + split) * dv + c] = A;
      if (c == 0) {
        part_m[rh * n_splits + split] = M;
        part_l[rh * n_splits + split] = L;
      }
    }
  }
}

// Pass 1 past the lanes kernel's widths for bfloat16 rows of whole 16-byte
// chunks (route 4: d past 576 or dv past 512, d and dv multiples of 8), on
// the tensor cores.  One block of 8 warps per (row, chunk of up to 16
// query heads, group of up to kWtCols value columns, split), so each K and
// V byte of a (row, head chunk) is read by one block, K once a group.  The
// split's tokens go in tiles of kWtTile through a ring of kWtStages
// entries in shared memory, each entry kWtTile tokens x kWtChunk columns
// of K or V, filled by 16-byte cp.async kWtStages - 1 entries ahead: a
// tile walks d's chunks of K, then the group's chunks of V.  Every thread
// copies the same token of every entry (its pool row, from the page
// table, fetched a tile ahead), zero-filled past the split's end, past
// the widths or for a slot outside the pool.  Q sits in shared memory for
// the whole split where it fits beside the ring (plan.q_resident; up to
// d 4800); wider, each K entry brings Q's 16 rows of its columns too.
// Warp w scores tokens 8 w .. 8 w + 7 of a tile for the 16 heads (S = Q
// K^T on mma.sync.m16n8k16, summed over d's chunks in the fragments); the
// tile's maximum of each head is taken across the warps through shared
// memory, so all warps keep one running max; P goes to shared memory as
// bf16, and each warp adds P V for columns 8 w .. 8 w + 7 of every V
// chunk (V through ldmatrix.trans), 16 n-tiles a thread at most: a [16,
// kWtCols] fp32 accumulator over the block.  A group past the first
// recomputes the scores (reads K again), so K is read ceil(dv / kWtCols)
// times, V once.
constexpr int kWtThreads = 256;
constexpr int kWtWarps = kWtThreads / 32;
constexpr int kWtTile = 64;                  // tokens a tile, 8 a warp
constexpr int kWtChunk = 64;                 // columns an entry
constexpr int kWtPitch = kWtChunk + 8;       // a shared row: 144 bytes
constexpr int kWtStages = 8;                 // entries of the ring
constexpr int kWtCols = 1024;                // value columns a block
constexpr int kWtVChunks = kWtCols / kWtChunk;   // a warp's n-tiles
constexpr int kSmemLimit = 232448;           // an H100 block's most
static_assert((kWtStages & (kWtStages - 1)) == 0, "stages a power of 2");

// 16 bytes global -> shared that also asks the L2 to fetch the 256 bytes
// around the source (the next chunk of a token's row then comes from the
// L2); `bytes` of them read (0-16), the rest zero-filled
__device__ __forceinline__ void cp_async16_l2(uint32_t dst, const void* src,
                                              int bytes) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

// the shared-memory plan of (d, dv): ring, then resident Q, then P [16]
// [kWtPitch] bf16 and the warps' maxima (then sums) [8][16] fp32
struct WalkTcPlan {
  int k_chunks, groups, group_cols, v_chunks, q_resident, entry_rows,
      smem_bytes;
};

__host__ __device__ inline WalkTcPlan walk_tc_plan(int d, int dv) {
  WalkTcPlan p;
  p.k_chunks = (d + kWtChunk - 1) / kWtChunk;
  p.groups = (dv + kWtCols - 1) / kWtCols;
  p.group_cols = dv < kWtCols ? dv : kWtCols;
  p.v_chunks = (p.group_cols + kWtChunk - 1) / kWtChunk;
  const int fixed = kHeads * kWtPitch * 2 + kWtWarps * kHeads * 4;
  const int q_bytes = kHeads * (p.k_chunks * kWtChunk + 8) * 2;
  const int ring = kWtStages * kWtTile * kWtPitch * 2;
  p.q_resident = fixed + q_bytes + ring <= kSmemLimit;
  p.entry_rows = kWtTile + (p.q_resident ? 0 : kHeads);
  p.smem_bytes = fixed + (p.q_resident ? q_bytes : 0)
                 + kWtStages * p.entry_rows * kWtPitch * 2;
  return p;
}

__global__ void __launch_bounds__(kWtThreads, 2)
decode_walk_tc_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k_pages,
                      const __nv_bfloat16* __restrict__ v_pages,
                      const int32_t* __restrict__ table,
                      const int32_t* __restrict__ seq_lens,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      float* __restrict__ part_acc, int H, int P, int page,
                      int n_slots, int split_pages, int d, int dv,
                      float inv_scale) {
  const WalkTcPlan plan = walk_tc_plan(d, dv);
  const int nk = plan.k_chunks;
  const int QP = nk * kWtChunk + 8;           // a resident Q row
  const int entry = plan.entry_rows * kWtPitch;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* q_s = ring + kWtStages * entry;
  __nv_bfloat16* p_s = q_s + (plan.q_resident ? kHeads * QP : 0);
  float* red_s = reinterpret_cast<float*>(p_s + kHeads * kWtPitch);

  const int row = blockIdx.x;
  const int h0 = blockIdx.y / plan.groups * kHeads;
  const int v0 = blockIdx.y % plan.groups * kWtCols;
  const int cols = min(kWtCols, dv - v0);
  const int nv = (cols + kWtChunk - 1) / kWtChunk;
  const int per_tile = nk + nv;
  const int split = blockIdx.z;
  const int n_splits = gridDim.z;
  const int gn = min(kHeads, H - h0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const float sl2 = 1.4426950408889634f * inv_scale;

  const int len = seq_lens[row];
  const int32_t* trow = table + (int64_t)row * P;
  const int n_pages = len <= 0 ? 0 : min(P, (len + page - 1) / page);
  const int t_begin = split * split_pages * page;
  const int t_end = min(min(n_pages, (split + 1) * split_pages) * page, len);
  const int n_tiles = t_end > t_begin
      ? (t_end - t_begin + kWtTile - 1) / kWtTile : 0;
  const __nv_bfloat16* qrow = q + ((int64_t)row * H + h0) * d;

  // the copier: token my_tok of every entry, columns my_c and my_c + 32
  const int my_tok = threadIdx.x / 4, my_c = (threadIdx.x % 4) * 8;
  auto pool_row = [&](int tile) -> int64_t {
    const int t = t_begin + tile * kWtTile + my_tok;
    if (tile >= n_tiles || t >= t_end) return -1;
    const int pi = t / page;
    const int slot = trow[pi];
    return slot >= 0 && slot < n_slots
        ? (int64_t)slot * page + (t - pi * page) : -1;
  };
  int is_tile = 0, is_part = 0, is_stage = 0;
  int64_t off = pool_row(0), off_next = pool_row(1);
  auto issue = [&]() {                 // the next entry, into its stage
    if (is_tile < n_tiles) {
      __nv_bfloat16* dst = ring + is_stage * entry;
      const bool key = is_part < nk;
      const __nv_bfloat16* src = key ? k_pages : v_pages;
      const int width = key ? d : dv;
      const int col0 = key ? is_part * kWtChunk
                           : v0 + (is_part - nk) * kWtChunk;
      const int lim = key ? d : v0 + cols;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = my_c + 32 * h;
        const bool ok = off >= 0 && col0 + c < lim;
        cp_async16_l2(smem_addr(dst + my_tok * kWtPitch + c),
                   src + (ok ? off * width + col0 + c : 0), ok ? 16 : 0);
      }
      if (key && !plan.q_resident && threadIdx.x < kHeads * 8) {
        const int hh = threadIdx.x / 8, c = (threadIdx.x % 8) * 8;
        const bool ok = hh < gn && col0 + c < d;
        cp_async16_l2(smem_addr(dst + (kWtTile + hh) * kWtPitch + c),
                   qrow + (ok ? hh * d + col0 + c : 0), ok ? 16 : 0);
      }
    }
    cp_async_commit();
    is_stage = (is_stage + 1) & (kWtStages - 1);
    if (++is_part == per_tile) {
      is_part = 0;
      ++is_tile;
      off = off_next;
      off_next = pool_row(is_tile + 1);
    }
  };
  // the next entry has landed, every thread is done with the one before,
  // whose stage the entry kWtStages - 1 ahead then takes
  int cs_stage = 0;
  auto step = [&]() -> const __nv_bfloat16* {
    cp_async_wait<kWtStages - 2>();
    __syncthreads();
    issue();
    const __nv_bfloat16* e = ring + cs_stage * entry;
    cs_stage = (cs_stage + 1) & (kWtStages - 1);
    return e;
  };

  if (n_tiles > 0) {
    if (plan.q_resident) {             // Q joins the first entry's group
      const int cpr = nk * kWtChunk / 8;
      for (int c = threadIdx.x; c < kHeads * cpr; c += kWtThreads) {
        const int hh = c / cpr, col = (c % cpr) * 8;
        const bool ok = hh < gn && col < d;
        cp_async16(smem_addr(q_s + hh * QP + col),
                   qrow + (ok ? hh * d + col : 0), ok);
      }
    }
    for (int i = 0; i < kWtStages - 1; ++i) issue();
  }

  float o[kWtVChunks][4];
#pragma unroll
  for (int j = 0; j < kWtVChunks; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // heads g and g + 8, log2 units
  float l[2] = {0.f, 0.f};              // this thread's part of the sums
  // ldmatrix lane offsets: Q rows lane % 16, column half lane / 16 (in
  // shared Q or an entry's rows past the tokens); K rows (tokens) lane %
  // 8, column eighth lane / 8 (two k-steps an x4); P rows lane % 16,
  // column half lane / 16; V^T tokens lane (four k-halves an x4), the
  // warp's 8 columns of the chunk
  const int q_off = plan.q_resident
      ? (lane % 16) * QP + (lane / 16) * 8
      : (kWtTile + lane % 16) * kWtPitch + (lane / 16) * 8;
  const int k_off = (warp * 8 + lane % 8) * kWtPitch + (lane / 8) * 8;
  const int p_off = (lane % 16) * kWtPitch + (lane / 16) * 8;
  const int v_off = lane * kWtPitch + warp * 8;

  for (int tile = 0; tile < n_tiles; ++tile) {
    // S: the 16 heads x this warp's 8 tokens, over d's chunks
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kc = 0; kc < nk; ++kc) {
      const __nv_bfloat16* e = step();
      const __nv_bfloat16* qa = plan.q_resident ? q_s + q_off + kc * kWtChunk
                                                : e + q_off;
#pragma unroll
      for (int kk = 0; kk < kWtChunk / 16; kk += 2) {
        uint32_t a0[4], a1[4], bk[4];
        ldsm_x4(bk, smem_addr(e + k_off + kk * 16));
        ldsm_x4(a0, smem_addr(qa + kk * 16));
        ldsm_x4(a1, smem_addr(qa + kk * 16 + 16));
        mma_bf16(s, a0, bk[0], bk[1]);
        mma_bf16(s, a1, bk[2], bk[3]);
      }
    }
    const int t0 = t_begin + tile * kWtTile + warp * 8;
    if (t0 + 8 > t_end) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (t0 + tig * 2 + (e & 1) >= t_end) s[e] = -INFINITY;
    }
    // the tile's maximum of each head over the warps
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(s[2 * r], s[2 * r + 1]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      if (tig == 0) red_s[warp * kHeads + g + 8 * r] = mx;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int hh = g + 8 * r;
      float mx = red_s[hh];
#pragma unroll
      for (int w = 1; w < kWtWarps; ++w)
        mx = fmaxf(mx, red_s[w * kHeads + hh]);
      const float m_new = fmaxf(m[r], mx * sl2);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[r] - m_use);
      m[r] = m_new;
      const float p0 = exp2f(fmaf(s[2 * r], sl2, -m_use));
      const float p1 = exp2f(fmaf(s[2 * r + 1], sl2, -m_use));
      l[r] = l[r] * alpha + p0 + p1;
      *reinterpret_cast<uint32_t*>(p_s + hh * kWtPitch + warp * 8
                                   + tig * 2) = pack_bf16(p0, p1);
#pragma unroll
      for (int j = 0; j < kWtVChunks; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }
    __syncthreads();                   // P of all the tile's tokens
    uint32_t pa[kWtTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kWtTile / 16; ++kk)
      ldsm_x4(pa[kk], smem_addr(p_s + p_off + kk * 16));
    // O[:, this warp's columns of each chunk] += P V
#pragma unroll
    for (int j = 0; j < kWtVChunks; ++j) {
      if (j >= nv) break;              // uniform in the block
      const __nv_bfloat16* e = step();
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t bv[4];
        ldsm_x4_t(bv, smem_addr(e + v_off + half * 32 * kWtPitch));
        mma_bf16(o[j], pa[2 * half], bv[0], bv[1]);
        mma_bf16(o[j], pa[2 * half + 1], bv[2], bv[3]);
      }
    }
  }

  // the sums: over the quad, then over the warps (all share the max)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __syncthreads();                     // the last maxima have been read
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (tig == 0) red_s[warp * kHeads + g + 8 * r] = l[r];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int hh = g + 8 * r;
    if (hh >= gn) continue;
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < kWtWarps; ++w) L += red_s[w * kHeads + hh];
    const int64_t rh = (int64_t)row * H + h0 + hh;
    const float inv = 1.f / fmaxf(L, 1e-30f);
    float* acc = out != nullptr ? nullptr
                                : part_acc + (rh * n_splits + split) * dv;
#pragma unroll
    for (int j = 0; j < kWtVChunks; ++j) {
      const int c = j * kWtChunk + warp * 8 + tig * 2;
      if (j >= nv || c >= cols) continue;
      if (out != nullptr) {
        *reinterpret_cast<__nv_bfloat162*>(out + rh * dv + v0 + c) =
            __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
      } else {
        acc[v0 + c] = o[j][2 * r];
        acc[v0 + c + 1] = o[j][2 * r + 1];
      }
    }
    if (out == nullptr && v0 == 0 && warp == 0 && tig == 0) {
      part_m[rh * n_splits + split] =  // the max in natural-log units
          m[r] == -INFINITY ? kNegInf : m[r] * 0.6931471805599453f;
      part_l[rh * n_splits + split] = L;
    }
  }
}

// Pass 1 for bfloat16 at MLA's latent widths (route 5): rows of whole
// 16-byte chunks with d in (256, 576] or dv in (256, 512], any head count,
// on Hopper's wgmma (m64n64k16, bf16 in, fp32 sums), the 64 rows of a
// product the 64 query heads of one sequence row.  At 128 heads a latent
// row does ~128 flops a byte of K and V, just under the card's ~295, so
// the design reads each K and V byte once a (row, 64 heads) and multiplies
// at the wgmma rate.  A block per (row, 64 heads, split), numbered so that
// a (row, split)'s head blocks are neighbours and the second finds the
// row's tokens in the L2; three warpgroups: the producer group (setmaxnreg
// 40) copies and two consumer groups (232) multiply.  Shared memory holds
// Q of the 64 heads as k_boxes boxes of 64 rows x 64 columns in the
// 128-byte swizzle (hopper.cuh), resident for the block's life, and one
// ring of 8 KB stages, each a box of 64 tokens x 64 columns of K or V, a
// tile's boxes in order (K's, then V's), and at least a whole tile of them
// (19 stages at (576, 512)), so that the next tile's copies start as its
// stages free.  Paged rows are not one tensor map's box, so every producer
// thread copies 16-byte chunks by cp.async straight into the swizzled
// layout (8 threads a token's 128 bytes, 4 tokens a box a thread, the
// token's pool row from the page table, read a tile ahead) and arrives on
// the stage's full mbarrier when its copies land
// (cp.async.mbarrier.arrive.noinc, 128 arrivals a phase); chunks past d or
// dv, tokens past the split's end, slots outside the pool and heads past H
// are zero-filled, never read.  Both groups wait for every stage in order
// and release each once (8 arrivals), a box they do not read as soon as it
// has landed, so neither runs two phases ahead of a stage; after a wait a
// consumer orders the copies before its wgmma reads (fence.proxy.async:
// cp.async writes through the generic proxy, wgmma reads through the async
// one).  Each group forms the whole S = Q K^T of a tile over d's boxes
// (both operands K-major), the same products in the same order, so S, the
// online softmax (log2 units, 2^x by ex2.approx, tokens past the split's
// end masked to -inf) and its max and sum are bit-equal in the two groups,
// which never wait for each other; P is rounded to bf16 in registers (the
// row sum l takes P unrounded) and each group adds P V into its own value
// boxes (alternate boxes, at most four a group, 256 columns, V MN-major),
// each box's products issued as soon as it lands.  The block's (max, sum,
// accumulator) go to the split partials of pass 2, or with one split its
// normalised output to out.  At (576, 512): Q 72 KB and 19 stages (152
// KB), 230,912 bytes: one block an SM.
constexpr int kWgThreads = 384;
constexpr int kWgProducerRegs = 40, kWgConsumerRegs = 232;
constexpr int kWgHeads = 64;                 // query heads a block
constexpr int kWgTile = 64;                  // tokens a tile
constexpr int kWgBox = 64 * 64;              // bf16 of a box
constexpr int kWgBoxBytes = 2 * kWgBox;      // 8 KB
constexpr int kWgFixed = 1024 + 512;         // alignment slack, mbarriers
constexpr int kWgMaxStages = 24;             // 2 * 24 + 1 mbarriers in 512 B
constexpr int kWgGroupBoxes = 4;             // a group's value boxes
constexpr int kWgMaxD = 576, kWgMaxDv = 512;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// the shared-memory plan of (d, dv): Q's boxes, then the ring's stages, as
// many as fit up to kWgMaxStages (at least a tile's k_boxes + v_boxes up
// to (576, 512)), and the mbarriers
struct WgPlan {
  int k_boxes, v_boxes, stages, smem_bytes;
};

__host__ __device__ inline WgPlan wg_plan(int d, int dv) {
  WgPlan p;
  p.k_boxes = (d + 63) / 64;
  p.v_boxes = (dv + 63) / 64;
  const int fixed = kWgFixed + p.k_boxes * kWgBoxBytes;
  const int avail = (kSmemLimit - fixed) / kWgBoxBytes;
  p.stages = avail < kWgMaxStages ? avail : kWgMaxStages;
  p.smem_bytes = fixed + p.stages * kWgBoxBytes;
  return p;
}

// arrive on `bar` once this thread's earlier cp.async copies have landed
// (the barrier's count includes this arrival)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The ring: entry i (counted from the block's first) sits in stage i % n,
// in that stage's phase i / n, both from a float reciprocal and one
// correction (exact for i < 2^24)
struct WgRing {
  __nv_bfloat16* base;
  uint64_t* full;
  uint64_t* empty;
  int n;
  float inv;
  __device__ WgRing(__nv_bfloat16* b, uint64_t* f, uint64_t* e, int stages)
      : base(b), full(f), empty(e), n(stages), inv(1.f / stages) {}
  __device__ __forceinline__ int2 at(int i) const {
    int q = __float2int_rz((float)i * inv);
    int r = i - q * n;
    if (r < 0) --q, r += n;
    else if (r >= n) ++q, r -= n;
    return make_int2(q, r);
  }
  __device__ __forceinline__ __nv_bfloat16* box(int i) const {
    return base + at(i).y * kWgBox;
  }
  // entry i has landed, its copies ordered before this thread's wgmma
  __device__ __forceinline__ void wait(int i) const {
    const int2 a = at(i);
    mbar_wait(&full[a.y], a.x & 1);
    fence_proxy_async();
  }
  // this warp's arrival on entry i's stage
  __device__ __forceinline__ void release(int i) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&empty[at(i).y]);
  }
  // the producer: this thread's 4 tokens' 16-byte chunk c8 of columns
  // col0 .. col0 + 63 of `src` (rows `width` wide) into entry i, then its
  // arrival on the stage once they land
  __device__ __forceinline__ void load(int i, const __nv_bfloat16* src,
                                       int width, int col0, const int* tok,
                                       int r0, int c8) const {
    const int2 a = at(i);
    if (a.x > 0) mbar_wait(&empty[a.y], (a.x - 1) & 1);
    const uint32_t dst = smem_addr(base + a.y * kWgBox)
                         + ((c8 ^ (r0 & 7)) << 4);
    const int col = col0 + 8 * c8;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const bool ok = tok[k] >= 0 && col < width;
      cp_async16_l2(dst + (r0 + 16 * k) * 128,
                    src + (ok ? (int64_t)tok[k] * width + col : 0),
                    ok ? 16 : 0);
    }
    cp_async_arrive(&full[a.y]);
  }
};

// a value the same in every lane of the warp, broadcast from lane 0, so
// that the compiler sees it so (a wgmma on a path it cannot prove uniform
// is serialised)
__device__ __forceinline__ int uniform(int x) {
  return __shfl_sync(0xffffffffu, x, 0);
}

// x (+)= A B^T over one 64-column box, A and B K-major boxes; one group
__device__ __forceinline__ void wg_box_scores(float (&x)[32],
                                              const __nv_bfloat16* a,
                                              const __nv_bfloat16* b,
                                              bool acc) {
  const uint64_t da = kmajor_desc(a), db = kmajor_desc(b);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)      // 32 bytes a k-step within the box
    wgmma_ss(x, da + 2 * kk, db + 2 * kk, acc || kk > 0);
  wgmma_commit();
}

// o += a B: a the A fragments of P, B the MN-major box at `b`; one group
__device__ __forceinline__ void wg_box_sum(float (&o)[32],
                                           const uint32_t (&a)[4][4],
                                           const __nv_bfloat16* b) {
  const uint64_t db = mnmajor_desc(b);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)      // 16 rows of 128 bytes a k-step
    wgmma_rs(o, a[kk], db + kk * 128, 1);
  wgmma_commit();
}

__global__ void __launch_bounds__(kWgThreads, 1)
decode_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k_pages,
                    const __nv_bfloat16* __restrict__ v_pages,
                    const int32_t* __restrict__ table,
                    const int32_t* __restrict__ seq_lens,
                    __nv_bfloat16* __restrict__ out,
                    float* __restrict__ part_m, float* __restrict__ part_l,
                    float* __restrict__ part_acc, int H, int P, int page,
                    int n_slots, int split_pages, int n_splits, int d,
                    int dv, float inv_scale, const WgPlan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sbase =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(sbase);
  __nv_bfloat16* ring_s = q_s + p.k_boxes * kWgBox;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_s + p.stages * kWgBox);
  uint64_t* empty = full + p.stages;
  uint64_t* q_full = empty + p.stages;
  const WgRing ring(ring_s, full, empty, p.stages);
  const int na = p.k_boxes, nb = p.v_boxes, E = na + nb;  // entries a tile

  const int n_hb = (H + kWgHeads - 1) / kWgHeads;
  const int hb = blockIdx.x % n_hb;
  const int split = blockIdx.x / n_hb % n_splits;
  const int row = blockIdx.x / n_hb / n_splits;
  const int h0 = hb * kWgHeads;
  const int len = seq_lens[row];
  const int32_t* trow = table + (int64_t)row * P;
  const int n_pages = len <= 0 ? 0 : min(P, (len + page - 1) / page);
  const int t_begin = split * split_pages * page;
  const int t_end = min(min(n_pages, (split + 1) * split_pages) * page, len);
  const int n_tiles = t_end > t_begin
      ? (t_end - t_begin + kWgTile - 1) / kWgTile : 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 128);        // each producer thread's copies
      mbar_init(&empty[s], 8);         // a lane of each consumer warp
    }
    mbar_init(q_full, 128);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {                     // ------------------------ producer
    reg_dealloc<kWgProducerRegs>();
    if (n_tiles == 0) return;
    const int pt = threadIdx.x - 256;
    const int c8 = pt % 8, r0 = pt / 8;  // chunk c8 of rows r0 + 16 k
    {                                  // Q's 64 heads, resident
      int hrow[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int hh = h0 + r0 + 16 * k;
        hrow[k] = hh < H ? row * H + hh : -1;
      }
      const uint32_t dst = smem_addr(q_s) + ((c8 ^ (r0 & 7)) << 4);
      for (int j = 0; j < na; ++j) {
        const int col = 64 * j + 8 * c8;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool ok = hrow[k] >= 0 && col < d;
          cp_async16(dst + j * kWgBoxBytes + (r0 + 16 * k) * 128,
                     q + (ok ? (int64_t)hrow[k] * d + col : 0), ok);
        }
      }
      cp_async_arrive(q_full);
    }
    // the page-table entries of my tokens of the next tile, read a tile
    // ahead; pool rows fit 32 bits (n_slots * page < 2^31)
    int slot[4];
    auto fetch = [&](int kt) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = t_begin + kt * kWgTile + r0 + 16 * k;
        slot[k] = kt < n_tiles && t < t_end ? trow[t / page] : -1;
      }
    };
    fetch(0);
    int e = 0;                         // the next entry of the ring
    for (int kt = 0; kt < n_tiles; ++kt) {
      int tok[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = t_begin + kt * kWgTile + r0 + 16 * k;
        tok[k] = slot[k] >= 0 && slot[k] < n_slots
            ? slot[k] * page + t % page : -1;
      }
      fetch(kt + 1);
      for (int j = 0; j < na; ++j)
        ring.load(e++, k_pages, d, 64 * j, tok, r0, c8);
      for (int c = 0; c < nb; ++c)
        ring.load(e++, v_pages, dv, 64 * c, tok, r0, c8);
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  reg_alloc<kWgConsumerRegs>();
  const int g = uniform(warp / 4);     // the consumer group
  const int tid = threadIdx.x % 128, w = tid / 32, gq = lane / 4,
            t = lane % 4;
  const float sl2 = inv_scale * kLog2e;
  const int mine = (nb - g + 1) / 2;   // my value boxes g + 2 c
  float o[kWgGroupBoxes][32];
#pragma unroll
  for (int c = 0; c < kWgGroupBoxes; ++c)
#pragma unroll
    for (int v = 0; v < 32; ++v) o[c][v] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if (n_tiles > 0) {
    mbar_wait(q_full, 0);
    fence_proxy_async();
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int t0 = t_begin + kt * kWgTile, base = kt * E;
    // S over d's boxes, each stage released when the next product is
    // issued (a tile's entries fit the ring: no wait needs a held stage)
    float x[32];
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
    ring.release(base + na - 1);
    if (t0 + kWgTile > t_end) {        // tokens past the split's end
#pragma unroll
      for (int v = 0; v < 32; ++v)
        if (t0 + 8 * (v >> 2) + 2 * t + (v & 1) >= t_end) x[v] = -INFINITY;
    }
    // the online softmax, heads 16 w + gq (hh 0) and + 8 (hh 1), each on
    // the quad of threads t
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int v = 0; v < 32; ++v)
        if (((v >> 1) & 1) == hh) mx = fmaxf(mx, x[v]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[hh], mx * sl2);
      const float mu = mn == -INFINITY ? 0.f : mn;
      const float alpha = ex2_approx(m[hh] - mu);
      m[hh] = mn;
      float sum = 0.f;
#pragma unroll
      for (int v = 0; v < 32; ++v)
        if (((v >> 1) & 1) == hh) {
          x[v] = ex2_approx(fmaf(x[v], sl2, -mu));
          sum += x[v];
        }
      l[hh] = l[hh] * alpha + sum;
#pragma unroll
      for (int c = 0; c < kWgGroupBoxes; ++c)
#pragma unroll
        for (int v = 0; v < 32; ++v)
          if (((v >> 1) & 1) == hh) o[c][v] *= alpha;
    }
    uint32_t a[4][4];
    acc_to_a(x, a);                    // P rounded to bf16
    // O += P V over my value boxes g + 2 c, each issued as it lands; the
    // other group's boxes released as they land
#pragma unroll
    for (int c = 0; c < kWgGroupBoxes; ++c) fence_acc(o[c]);
#pragma unroll
    for (int c = 0; c < kWgGroupBoxes; ++c) {
      const int other = base + na + 2 * c + 1 - g, my = base + na + 2 * c + g;
      if (g == 1 && 2 * c < nb) {
        ring.wait(other);
        ring.release(other);
      }
      if (c < mine) {
        ring.wait(my);
        wg_box_sum(o[c], a, ring.box(my));
      }
      if (g == 0 && 2 * c + 1 < nb) {
        ring.wait(other);
        ring.release(other);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < kWgGroupBoxes; ++c) fence_acc(o[c]);
    for (int c = 0; c < mine; ++c) ring.release(base + na + 2 * c + g);
  }

  // the sums over the quad; out = O / l, or the split's partials (the max
  // in natural-log units) for pass 2
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int head = h0 + 16 * w + gq + 8 * hh;
    if (head >= H) continue;
    const int64_t rh = (int64_t)row * H + head;
    const float inv = 1.f / fmaxf(l[hh], 1e-30f);
    if (out == nullptr && g == 0 && t == 0) {
      part_m[rh * n_splits + split] =
          m[hh] == -INFINITY ? kNegInf : m[hh] * kLn2;
      part_l[rh * n_splits + split] = l[hh];
    }
#pragma unroll
    for (int c = 0; c < kWgGroupBoxes; ++c) {
      if (c >= mine) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {    // values 4 j + 2 hh, 4 j + 2 hh + 1
        const int v = 4 * j + 2 * hh;
        const int col = 64 * (g + 2 * c) + 8 * j + 2 * t;
        if (col >= dv) continue;
        if (out != nullptr)
          *reinterpret_cast<__nv_bfloat162*>(out + rh * dv + col) =
              __floats2bfloat162_rn(o[c][v] * inv, o[c][v + 1] * inv);
        else
          *reinterpret_cast<float2*>(
              part_acc + (rh * n_splits + split) * dv + col) =
              make_float2(o[c][v], o[c][v + 1]);
      }
    }
  }
}

// Pass 1 past the lanes kernel's widths for float32, and for bfloat16 rows
// that are not whole 16-byte chunks (route 3: d past 576 or dv past 512),
// on the tensor cores in TF32 with fp32 sums: route 4's plan on rows of
// any alignment.  Bound: bytes, as every route (2 flops a K or V element
// and head: 8 a byte of fp32 at 16 heads).  One block of 8 warps per
// (row, chunk of up to 16 query heads, group of up to kWkCols value
// columns, split), a (row, split)'s blocks neighbours in the grid, so each
// K and V byte of a (row, head chunk) is read by one block, K once a
// group; two blocks an SM (128 registers, and the
// plan keeps a block's shared memory within half the SM's), since one
// block a SM leaves the copies and the products in turn.  The split's
// tokens go in tiles of kWkTile through a ring of WalkOf<T>::kStages
// entries, each kWkTile tokens x kWkChunk columns of K or V, filled by
// cp.async kStages - 1 entries ahead: a tile walks d's chunks of K, then
// the group's chunks of V.  A row chunk whose first byte is not on a
// 16-byte boundary is copied as the 16-byte windows that cover it, from
// the boundary at or below it (the pool's base is 16-byte aligned), into a
// shared row of kWkChunk + one window of elements; the element sits at the
// row's offset in its window (its shift, < one window), the same for every
// chunk of the token's row, kept in shared memory in plan.shift_tiles
// slots, one a tile, so that the copier running ahead does not overwrite
// a tile's shifts before they are read.  The window at
// the pool's last bytes copies only the bytes that remain (cp.async's
// source size) and zero-fills the rest, so nothing past n_slots * page * d
// elements is read; a token past the split's end or a slot outside the
// pool is zero-filled.  Fragments are built from shared memory one element
// a register at the row's shift (a TF32 fragment register holds one
// element), columns past d masked to 0.  Four threads a token copy its
// windows, every fourth each, in 32-bit arithmetic from the row's start;
// its pool row comes from the page table, read a tile ahead.  Q sits in
// shared memory for the whole split, copied the same way, where it fits
// beside the ring (plan.q_resident), else its 16 rows ride in each K entry
// (from the L2).  Warp w scores tokens 8 w .. 8 w + 7 of a tile for the 16
// heads (S = Q K^T on mma.sync.m16n8k8 TF32, the heads as the 16 rows, a
// fresh sum each entry added to S in fp32); the tile's maximum of each
// head is taken across the warps through shared memory, so all warps keep
// one running max; P goes to shared memory as the A fragments of P V, one
// 16-byte load a thread a k-step, and each warp adds P V for columns 8 w
// .. 8 w + 7 of every V chunk, a fresh sum each entry added to its [16, 8]
// accumulator in fp32 (16 n-tiles a thread at most: [16, kWkCols] over
// the block).  float32 splits every operand, hi = tf32(x), lo = tf32(x -
// hi), and sums hi.hi + hi.lo + lo.hi (an error near 2^-21 relative,
// inside the 2e-5 tolerance; one TF32 product would leave 2^-11);
// bfloat16 values are exact in TF32, so S takes one product and P is
// rounded once to TF32 for P V.  A group past the first recomputes the
// scores (reads K again), so K is read ceil(dv / kWkCols) times, V once.
constexpr int kWkThreads = 256;
constexpr int kWkWarps = kWkThreads / 32;
constexpr int kWkTile = 64;                  // tokens a tile, 8 a warp
constexpr int kWkChunk = 64;                 // columns an entry
constexpr int kWkCols = 1024;                // value columns a block
constexpr int kWkVChunks = kWkCols / kWkChunk;   // a warp's n-tiles
constexpr int kWkPFrag = kWkTile / 8 * 32 * 4;   // P's fragments, uint32
// two blocks an SM: half its 233,472 bytes of shared memory less the 1,024
// each block reserves
constexpr int kWkBlockSmem = 115712;

// The ring of each type: stages, and the shared row pitches (elements) of
// K and V entries, kWkChunk + one window and more, so that the fragments'
// reads of 8 rows x 4 columns (K) and 4 rows x 8 columns (V) fall in
// distinct banks at shift 0; a float32 entry takes twice the bytes of a
// bfloat16 one, so it has half the stages (the ring 74 and 82 KB, 92 and
// 102 KB with Q's rows)
template <typename T>
struct WalkOf;
template <>
struct WalkOf<float> {
  static constexpr int kStages = 4, kKPitch = 68, kVPitch = 72;
};
template <>
struct WalkOf<__nv_bfloat16> {
  static constexpr int kStages = 8, kKPitch = 72, kVPitch = 80;
};

// the shared-memory plan of (d, dv) in a type, within two blocks an SM:
// the ring, then resident Q [16][q_pitch] of the type, then P's A
// fragments, TF32 hi and lo [kWkTile / 8][32 lanes][4], the warps' maxima
// (then sums) [8][16] fp32 and the tiles' shifts [shift_tiles][2][kWkTile]
// bytes (K's, then V's).  The copier runs stages - 1 entries ahead and
// writes a tile's shifts as it enters it; a tile's are read up to its K
// entries' end; so with tiles of k_chunks + v_chunks entries (fewest in the
// last group) it can enter (stages - 1 + k_chunks) / tile more tiles
// first, each into a slot of its own: one slot where that is none, else
// stages / 2 + 1, the most it can be (tiles of two entries), so that the
// kernel indexes the slots by a constant
struct WalkPlan {
  int window, stages, k_chunks, groups, group_cols, v_chunks, q_resident,
      entry_rows, k_pitch, v_pitch, q_pitch, shift_tiles, smem_bytes;
};

__host__ __device__ inline WalkPlan walk_plan(int d, int dv, int bf16) {
  WalkPlan p;
  const int elem = bf16 ? 2 : 4;
  p.window = 16 / elem;
  p.stages = bf16 ? WalkOf<__nv_bfloat16>::kStages : WalkOf<float>::kStages;
  p.k_pitch = bf16 ? WalkOf<__nv_bfloat16>::kKPitch : WalkOf<float>::kKPitch;
  p.v_pitch = bf16 ? WalkOf<__nv_bfloat16>::kVPitch : WalkOf<float>::kVPitch;
  p.k_chunks = (d + kWkChunk - 1) / kWkChunk;
  p.groups = (dv + kWkCols - 1) / kWkCols;
  p.group_cols = dv < kWkCols ? dv : kWkCols;
  p.v_chunks = (p.group_cols + kWkChunk - 1) / kWkChunk;
  p.q_pitch = p.k_chunks * kWkChunk + p.window;
  const int row = p.k_pitch > p.v_pitch ? p.k_pitch : p.v_pitch;
  const int last_cols = dv - (p.groups - 1) * kWkCols;
  const int fewest = p.k_chunks + (last_cols + kWkChunk - 1) / kWkChunk;
  p.shift_tiles =
      (p.stages - 1 + p.k_chunks) / fewest > 0 ? p.stages / 2 + 1 : 1;
  const int fixed = 2 * kWkPFrag * 4 + kWkWarps * kHeads * 4
                    + 2 * kWkTile * p.shift_tiles;
  const int q_bytes = kHeads * p.q_pitch * elem;
  p.q_resident =
      fixed + q_bytes + p.stages * kWkTile * row * elem <= kWkBlockSmem;
  p.entry_rows = kWkTile + (p.q_resident ? 0 : kHeads);
  p.smem_bytes = fixed + (p.q_resident ? q_bytes : 0)
                 + p.stages * p.entry_rows * row * elem;
  return p;
}

// A pool row as the copier walks it: the first element of the 16-byte
// window at or below the row's first element (-1: zero-fill the row), the
// row's offset in that window (its shift, the same for every chunk, whose
// first columns are multiples of the window), and the pool's elements from
// there on (at most 2^28), so that each entry's windows take 32-bit
// arithmetic
struct WindowRow {
  int64_t base;
  int sh, left;
};

template <typename T>
__host__ __device__ __forceinline__ WindowRow window_row(int64_t e0,
                                                         int64_t total) {
  constexpr int W = 16 / sizeof(T);
  WindowRow r{-1, 0, 0};
  if (e0 >= 0) {
    r.sh = (int)(e0 & (W - 1));
    r.base = e0 - r.sh;
    const int64_t left = total - r.base;
    r.left = left < (1 << 28) ? (int)left : 1 << 28;
  }
  return r;
}

// The windows of columns col0 .. col0 + n - 1 (col0 a multiple of the
// window, n <= kWkChunk) of row r: their number (a row with base -1: every
// window of a shared row), and the bytes window w reads, 16 but past the
// pool's last element only what remains (0: nothing read)
template <typename T>
__host__ __device__ __forceinline__ int window_count(const WindowRow& r,
                                                     int n) {
  constexpr int W = 16 / sizeof(T);
  return r.base < 0 ? kWkChunk / W + 1 : (r.sh + n + W - 1) / W;
}

template <typename T>
__host__ __device__ __forceinline__ int window_bytes(const WindowRow& r,
                                                     int col0, int w) {
  constexpr int W = 16 / sizeof(T);
  const int rem = (r.left - col0 - w * W) * (int)sizeof(T);
  return rem >= 16 ? 16 : (rem > 0 ? rem : 0);
}

// Columns col0 .. col0 + n - 1 of row r of `src` into the shared row `dst`,
// as the 16-byte windows from the boundary at or below the first, column
// col0 at dst[r.sh]; this thread copies windows `first`, first + 4, ...
// Past the pool's last element a window reads only the bytes that remain
// (cp.async's source size) and zero-fills the rest; a row with base -1 is
// zero-filled, nothing read.  (decode_walk_windows exports the windows.)
template <typename T>
__device__ __forceinline__ void copy_windows(T* dst, const T* src,
                                             const WindowRow& r, int col0,
                                             int n, int first) {
  constexpr int W = 16 / sizeof(T), NW = kWkChunk / W + 1;
  const int nwin = window_count<T>(r, n);
  const T* s0 = src + (r.base < 0 ? 0 : r.base + col0);
#pragma unroll
  for (int i = 0; i < (NW + 3) / 4; ++i) {
    const int w = first + 4 * i;
    if (w < nwin) {
      const int bytes = window_bytes<T>(r, col0, w);
      cp_async16_l2(smem_addr(dst + w * W), bytes > 0 ? s0 + w * W : src,
                      bytes);
    }
  }
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// c[4] += a[4] (16 x 8, row) * b[2] (8 x 8, col), TF32 in, fp32 sums; an A
// fragment holds rows g, g + 8, g, g + 8 at columns t, t, t + 4, t + 4, a B
// fragment column g at rows t and t + 4 (g = lane / 4, t = lane % 4)
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x as TF32 operands: float32 as hi = tf32(x) and lo = tf32(x - hi);
// bfloat16 values as they are (exact in TF32), lo unused
template <typename T>
__device__ __forceinline__ void operand(float x, uint32_t& hi, uint32_t& lo) {
  if (sizeof(T) == 4) {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

// one k-step: big += a_hi.b_hi; float32 also small += a_hi.b_lo + a_lo.b_hi
template <typename T>
__device__ __forceinline__ void mma_split(float* big, float* small,
                                          const uint32_t* ah,
                                          const uint32_t* al,
                                          const uint32_t* bh,
                                          const uint32_t* bl) {
  if (sizeof(T) == 4) {
    mma_tf32(small, al, bh[0], bh[1]);
    mma_tf32(small, ah, bl[0], bl[1]);
  }
  mma_tf32(big, ah, bh[0], bh[1]);
}

template <typename T>
__global__ void __launch_bounds__(kWkThreads, 2)
decode_walk_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                   const T* __restrict__ v_pages,
                   const int32_t* __restrict__ table,
                   const int32_t* __restrict__ seq_lens, T* __restrict__ out,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, int H, int P, int page,
                   int n_slots, int split_pages, int n_splits, int d, int dv,
                   float inv_scale) {
  constexpr int S = WalkOf<T>::kStages;
  constexpr int KP = WalkOf<T>::kKPitch, VP = WalkOf<T>::kVPitch;
  constexpr int W = 16 / sizeof(T);          // elements a window
  constexpr bool kSplit = sizeof(T) == 4;    // float32: hi and lo
  const WalkPlan plan = walk_plan(d, dv, sizeof(T) == 2);
  const int nk = plan.k_chunks;
  const int QP = plan.q_pitch;
  const int entry = plan.entry_rows * (KP > VP ? KP : VP);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* q_s = ring + S * entry;
  uint32_t* ph_s = reinterpret_cast<uint32_t*>(
      q_s + (plan.q_resident ? kHeads * QP : 0));
  uint32_t* pl_s = ph_s + kWkPFrag;
  float* red_s = reinterpret_cast<float*>(pl_s + kWkPFrag);
  unsigned char* sh_s = reinterpret_cast<unsigned char*>(
      red_s + kWkWarps * kHeads);   // [slot][K, V][token]

  // a (row, split)'s blocks (head chunks x value groups) are neighbours,
  // so that the row's tokens a block reads are in the L2 for the next
  const int per_split = (H + kHeads - 1) / kHeads * plan.groups;
  const int cg = blockIdx.x % per_split;
  const int split = blockIdx.x / per_split % n_splits;
  const int row = blockIdx.x / per_split / n_splits;
  const int h0 = cg / plan.groups * kHeads;
  const int v0 = cg % plan.groups * kWkCols;
  const int cols = min(kWkCols, dv - v0);
  const int nv = (cols + kWkChunk - 1) / kWkChunk;
  const int per_tile = nk + nv;
  const int gn = min(kHeads, H - h0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
  const float sl2 = 1.4426950408889634f * inv_scale;
  // rows of K (V) start off their windows only where d (dv) is not a whole
  // number of windows; elsewhere every shift is 0
  const bool k_shifted = d % W != 0, v_shifted = dv % W != 0;

  const int len = seq_lens[row];
  const int32_t* trow = table + (int64_t)row * P;
  const int n_pages = len <= 0 ? 0 : min(P, (len + page - 1) / page);
  const int t_begin = split * split_pages * page;
  const int t_end = min(min(n_pages, (split + 1) * split_pages) * page, len);
  const int n_tiles = t_end > t_begin
      ? (t_end - t_begin + kWkTile - 1) / kWkTile : 0;
  const int64_t q0 = ((int64_t)row * H + h0) * d;   // the chunk's Q rows
  const int64_t k_total = (int64_t)n_slots * page * d;
  const int64_t v_total = (int64_t)n_slots * page * dv;
  const int64_t q_total =
      (int64_t)(gridDim.x / per_split / n_splits) * H * d;

  // the copier: token my_tok of every entry, windows my_w, my_w + 4, ...
  const int my_tok = threadIdx.x / 4, my_w = threadIdx.x % 4;
  auto pool_row = [&](int tile) -> int64_t {
    const int t = t_begin + tile * kWkTile + my_tok;
    if (tile >= n_tiles || t >= t_end) return -1;
    const int pi = t / page;
    const int slot = trow[pi];
    return slot >= 0 && slot < n_slots
        ? (int64_t)slot * page + (t - pi * page) : -1;
  };
  int is_tile = 0, is_part = 0, is_stage = 0;
  int64_t off = pool_row(0), off_next = pool_row(1);
  auto shifts = [&]() {                // the readers' shifts of my token
    if (is_tile < n_tiles && my_w == 0 && (k_shifted || v_shifted)) {
      unsigned char* sh = sh_s + my_tok + 2 * kWkTile
          * (plan.shift_tiles > 1 ? is_tile % (S / 2 + 1) : 0);
      sh[0] = off >= 0 ? (unsigned char)((off * d) & (W - 1)) : 0;
      sh[kWkTile] = off >= 0 ? (unsigned char)((off * dv) & (W - 1)) : 0;
    }
  };
  shifts();
  auto issue = [&]() {                 // the next entry, into its stage
    if (is_tile < n_tiles) {
      T* dst = ring + is_stage * entry;
      const bool key = is_part < nk;
      const int width = key ? d : dv;
      const int col0 = key ? is_part * kWkChunk
                           : v0 + (is_part - nk) * kWkChunk;
      const int n = min(kWkChunk, (key ? d : v0 + cols) - col0);
      copy_windows(dst + my_tok * (key ? KP : VP), key ? k_pages : v_pages,
                   window_row<T>(off >= 0 ? off * width : -1,
                                 key ? k_total : v_total),
                   col0, n, my_w);
      if (key && !plan.q_resident && threadIdx.x < kHeads * 4) {
        const int hh = threadIdx.x / 4;
        copy_windows(dst + (kWkTile + hh) * KP, q,
                     window_row<T>(hh < gn ? q0 + (int64_t)hh * d : -1,
                                   q_total),
                     col0, n, my_w);
      }
    }
    cp_async_commit();
    is_stage = is_stage + 1 == S ? 0 : is_stage + 1;
    if (++is_part == per_tile) {
      is_part = 0;
      ++is_tile;
      off = off_next;
      off_next = pool_row(is_tile + 1);
      shifts();
    }
  };
  // the next entry has landed, every thread is done with the one before,
  // whose stage the entry S - 1 ahead then takes
  int cs_stage = 0;
  auto step = [&]() -> const T* {
    cp_async_wait<S - 2>();
    __syncthreads();
    issue();
    const T* e = ring + cs_stage * entry;
    cs_stage = cs_stage + 1 == S ? 0 : cs_stage + 1;
    return e;
  };

  if (n_tiles > 0) {
    if (plan.q_resident) {             // Q joins the first entry's group:
      const int hh = threadIdx.x / 16;   // 16 threads a head, its row as
      const WindowRow r = window_row<T>(   // windows (zero past the chunk)
          hh < gn ? q0 + (int64_t)hh * d : -1, q_total);
      const int nwin = r.base < 0 ? QP / W : (r.sh + d + W - 1) / W;
      for (int w = threadIdx.x % 16; w < nwin; w += 16) {
        const int bytes = window_bytes<T>(r, 0, w);
        cp_async16_l2(smem_addr(q_s + hh * QP + w * W),
                        bytes > 0 ? q + r.base + w * W : q, bytes);
      }
    }
    for (int i = 0; i < S - 1; ++i) issue();
  }

  float o[kWkVChunks][4];
#pragma unroll
  for (int j = 0; j < kWkVChunks; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // heads g and g + 8, log2 units
  float l[2] = {0.f, 0.f};              // this thread's part of the sums
  // Q's rows g and g + 8 (resident, or in each K entry past its tokens)
  // at their shifts (rows past the chunk's heads are zero)
  const int qs0 = g < gn ? (int)((q0 + (int64_t)g * d) % W) : 0;
  const int qs1 = g + 8 < gn ? (int)((q0 + (int64_t)(g + 8) * d) % W) : 0;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const unsigned char* sh =
        sh_s + 2 * kWkTile * (plan.shift_tiles > 1 ? tile % (S / 2 + 1) : 0);
    // S: the 16 heads x this warp's 8 tokens, over d's chunks
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int kc = 0; kc < nk; ++kc) {
      const T* e = step();
      const int lim = d - kc * kWkChunk;     // columns of the chunk below d
      const T* kb = e + (warp * 8 + g) * KP
                    + (k_shifted ? sh[warp * 8 + g] : 0) + tig;
      const T* qa0 = (plan.q_resident ? q_s + g * QP + kc * kWkChunk
                                      : e + (kWkTile + g) * KP) + qs0 + tig;
      const T* qa1 = (plan.q_resident ? q_s + (g + 8) * QP + kc * kWkChunk
                                      : e + (kWkTile + g + 8) * KP) + qs1
                     + tig;
      float big[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int k0 = 0; k0 < kWkChunk; k0 += 8) {
        const bool in0 = k0 + tig < lim, in1 = k0 + tig + 4 < lim;
        const float a[4] = {in0 ? to_f32(qa0[k0]) : 0.f,
                            in0 ? to_f32(qa1[k0]) : 0.f,
                            in1 ? to_f32(qa0[k0 + 4]) : 0.f,
                            in1 ? to_f32(qa1[k0 + 4]) : 0.f};
        const float b[2] = {in0 ? to_f32(kb[k0]) : 0.f,
                            in1 ? to_f32(kb[k0 + 4]) : 0.f};
        uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) operand<T>(a[i], ah[i], al[i]);
        operand<T>(b[0], bh[0], bl[0]);
        operand<T>(b[1], bh[1], bl[1]);
        mma_split<T>(big, small, ah, al, bh, bl);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] += big[i] + small[i];
    }
    const int t0 = t_begin + tile * kWkTile + warp * 8;
    if (t0 + 8 > t_end) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (t0 + tig * 2 + (e & 1) >= t_end) s[e] = -INFINITY;
    }
    // the tile's maximum of each head over the warps
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = fmaxf(s[2 * r], s[2 * r + 1]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      if (tig == 0) red_s[warp * kHeads + g + 8 * r] = mx;
    }
    __syncthreads();
    // P as the A fragments of P V, k-step w (this warp's tokens): token
    // 8 w + t' of head g + 8 r goes to lane 4 g + t' % 4, slot r + 2 (t' /
    // 4); float32 split into TF32 hi and lo, bfloat16 rounded to TF32 once
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int hh = g + 8 * r;
      float mx = red_s[hh];
#pragma unroll
      for (int w = 1; w < kWkWarps; ++w)
        mx = fmaxf(mx, red_s[w * kHeads + hh]);
      const float m_new = fmaxf(m[r], mx * sl2);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[r] - m_use);
      m[r] = m_new;
      const float p[2] = {exp2f(fmaf(s[2 * r], sl2, -m_use)),
                          exp2f(fmaf(s[2 * r + 1], sl2, -m_use))};
      l[r] = l[r] * alpha + p[0] + p[1];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tp = 2 * tig + e;
        const int at = (warp * 32 + g * 4 + (tp & 3)) * 4 + r + 2 * (tp >> 2);
        const uint32_t hi = tf32(p[e]);
        ph_s[at] = hi;
        if (kSplit) pl_s[at] = tf32(p[e] - __uint_as_float(hi));
      }
#pragma unroll
      for (int j = 0; j < kWkVChunks; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }
    // V's shifts of rows t and t + 4 of each k-step, 4 bits each
    uint32_t vsh0 = 0u, vsh1 = 0u;
    if (v_shifted) {
#pragma unroll
      for (int kk = 0; kk < kWkTile / 8; ++kk) {
        vsh0 |= (uint32_t)sh[kWkTile + kk * 8 + tig] << (4 * kk);
        vsh1 |= (uint32_t)sh[kWkTile + kk * 8 + tig + 4] << (4 * kk);
      }
    }
    __syncthreads();                   // P of all the tile's tokens
    // O[:, this warp's columns of each chunk] += P V
#pragma unroll
    for (int j = 0; j < kWkVChunks; ++j) {
      if (j >= nv) break;              // uniform in the block
      const T* e = step() + warp * 8 + g;
      float big[4] = {0.f, 0.f, 0.f, 0.f}, small[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kWkTile / 8; ++kk) {
        const uint4 h4 = *reinterpret_cast<const uint4*>(
            ph_s + (kk * 32 + lane) * 4);
        const uint4 l4 = kSplit ? *reinterpret_cast<const uint4*>(
                                      pl_s + (kk * 32 + lane) * 4)
                                : make_uint4(0u, 0u, 0u, 0u);
        const uint32_t ah[4] = {h4.x, h4.y, h4.z, h4.w};
        const uint32_t al[4] = {l4.x, l4.y, l4.z, l4.w};
        const int r0 = kk * 8 + tig;
        uint32_t bh[2], bl[2];
        operand<T>(to_f32(e[r0 * VP + ((vsh0 >> (4 * kk)) & 15u)]), bh[0],
                   bl[0]);
        operand<T>(to_f32(e[(r0 + 4) * VP + ((vsh1 >> (4 * kk)) & 15u)]),
                   bh[1], bl[1]);
        mma_split<T>(big, small, ah, al, bh, bl);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) o[j][i] += big[i] + small[i];
    }
  }

  // the sums: over the quad, then over the warps (all share the max)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __syncthreads();                     // the last maxima have been read
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (tig == 0) red_s[warp * kHeads + g + 8 * r] = l[r];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int hh = g + 8 * r;
    if (hh >= gn) continue;
    float L = 0.f;
#pragma unroll
    for (int w = 0; w < kWkWarps; ++w) L += red_s[w * kHeads + hh];
    const int64_t rh = (int64_t)row * H + h0 + hh;
    const float inv = 1.f / fmaxf(L, 1e-30f);
    float* acc = out != nullptr ? nullptr
                                : part_acc + (rh * n_splits + split) * dv;
#pragma unroll
    for (int j = 0; j < kWkVChunks; ++j) {
      const int c = j * kWkChunk + warp * 8 + tig * 2;
      if (j >= nv) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (c + e >= cols) continue;
        if (out != nullptr)
          store(out + rh * dv + v0 + c + e, o[j][2 * r + e] * inv);
        else
          acc[v0 + c + e] = o[j][2 * r + e];
      }
    }
    if (out == nullptr && v0 == 0 && warp == 0 && tig == 0) {
      part_m[rh * n_splits + split] =  // the max in natural-log units
          m[r] == -INFINITY ? kNegInf : m[r] * 0.6931471805599453f;
      part_l[rh * n_splits + split] = L;
    }
  }
}

// Pass 2: one block per (row, head, kThreads columns), a thread per
// column; the splits are combined in order, so the sum is the same from
// run to run.  The loads of kMergeBatch splits are issued before their
// sums, so that their latencies overlap (left to the compiler, each load
// waits on the sums before it)
constexpr int kMergeBatch = 8;
template <typename T>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ part_m,
             const float* __restrict__ part_l,
             const float* __restrict__ part_acc, T* __restrict__ out, int D,
             int n_splits) {
  const int64_t rh = blockIdx.x;
  const int c = blockIdx.y * kThreads + threadIdx.x;
  if (c >= D) return;
  const float* pm = part_m + rh * n_splits;
  const float* pl = part_l + rh * n_splits;
  float M = kNegInf;
  for (int i = 0; i < n_splits; ++i) M = fmaxf(M, pm[i]);
  const float* acc = part_acc + rh * n_splits * D + c;
  float L = 0.f, A = 0.f;
  int i = 0;
  for (; i + kMergeBatch <= n_splits; i += kMergeBatch) {
    float mb[kMergeBatch], lb[kMergeBatch], ab[kMergeBatch];
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) {
      mb[j] = pm[i + j];
      lb[j] = pl[i + j];
      ab[j] = acc[(int64_t)(i + j) * D];
    }
#pragma unroll
    for (int j = 0; j < kMergeBatch; ++j) {
      const float sc = expf(mb[j] - M);
      L = fmaf(lb[j], sc, L);
      A = fmaf(ab[j], sc, A);
    }
  }
  for (; i < n_splits; ++i) {
    const float sc = expf(pm[i] - M);
    L = fmaf(pl[i], sc, L);
    A = fmaf(acc[(int64_t)i * D], sc, A);
  }
  store(out + rh * D + c, A / fmaxf(L, 1e-30f));
}

// scratch [B, H, n_splits] max, then sum, then [B, H, n_splits, dv] sums
struct Parts {
  float *m, *l, *acc;
  Parts(float* scratch, int B, int H, int n_splits) {
    const int64_t n = (int64_t)B * H * n_splits;
    m = n_splits > 1 ? scratch : nullptr;
    l = n_splits > 1 ? scratch + n : nullptr;
    acc = n_splits > 1 ? scratch + 2 * n : nullptr;
  }
};

// the arguments of one launch; n_splits as the wrapper asked, then as the
// ranges of ceil(P / n_splits) pages make it (none empty); d and dv the
// pool's row widths, inv_scale 1/sqrt(d)
struct Args {
  const void *q, *k, *v, *table, *lens;
  void* out;
  float* scratch;
  int B, H, P, page, n_slots, n_splits, d, dv;
  float inv_scale;
  cudaStream_t stream;
  int split_pages() const { return (P + n_splits - 1) / n_splits; }
  int splits() const {
    return n_splits > 1 ? (P + split_pages() - 1) / split_pages() : 1;
  }
};

// pass 2 after pass 1 when there is more than one split
template <typename T>
int merge(const Args& a, const Parts& parts) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits() == 1) return (int)err;
  const dim3 grid(a.B * a.H, (a.dv + kThreads - 1) / kThreads);
  merge_kernel<T><<<grid, kThreads, 0, a.stream>>>(
      parts.m, parts.l, parts.acc, (T*)a.out, a.dv, a.splits());
  return (int)cudaGetLastError();
}

// the entry points' bodies for one instance: heads a block, resident
// blocks per SM at the instance's widths (d, dv; only route 4's shared
// memory depends on them), and the launch
template <typename T, int D, int G>
struct Workers {                       // route 0: float32 on the CUDA cores
  static int heads() { return G; }
  static int blocks_per_sm(int* n, int, int) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        n, decode_kernel<T, D, G>, kThreads, 0);
  }
  static int launch(const Args& a) {
    const int n = a.splits();
    const Parts parts(a.scratch, a.B, a.H, n);
    decode_kernel<T, D, G><<<dim3(a.B, (a.H + G - 1) / G, n), kThreads, 0,
                             a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const int32_t*)a.table,
        (const int32_t*)a.lens, n > 1 ? nullptr : (T*)a.out, parts.m,
        parts.l, parts.acc, a.H, a.P, a.page, a.n_slots, a.split_pages());
    return merge<T>(a, parts);
  }
};

template <typename K>
int configure(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// route 1: bfloat16 on the tensor cores, up to 128 in registers
template <int D>
struct TensorCores {
  static constexpr int kBytes = bf16_smem_bytes<D>();
  static int heads() { return kHeads; }
  static int configured() {
    static const int err = configure(decode_bf16_kernel<D>, kBytes);
    return err;
  }
  static int blocks_per_sm(int* n, int, int) {
    const int err = configured();
    if (err != 0) return err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        n, decode_bf16_kernel<D>, kThreads, kBytes);
  }
  static int launch(const Args& a) {
    const int err = configured();
    if (err != 0) return err;
    const int n = a.splits();
    const Parts parts(a.scratch, a.B, a.H, n);
    decode_bf16_kernel<D><<<dim3(a.B, (a.H + kHeads - 1) / kHeads, n),
                            kThreads, kBytes, a.stream>>>(
        (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.k,
        (const __nv_bfloat16*)a.v, (const int32_t*)a.table,
        (const int32_t*)a.lens, n > 1 ? nullptr : (__nv_bfloat16*)a.out,
        parts.m, parts.l, parts.acc, a.H, a.P, a.page, a.n_slots,
        a.split_pages(), a.d, a.dv, a.inv_scale);
    return merge<__nv_bfloat16>(a, parts);
  }
};

// route 1 at wide rows: Q in shared memory, columns split over the warps
template <int DK, int DV>
struct Wide {
  static constexpr int kBytes = wide_smem_bytes<DK, DV>();
  static int heads() { return kHeads; }
  static int configured() {
    static const int err = configure(decode_wide_kernel<DK, DV>, kBytes);
    return err;
  }
  static int blocks_per_sm(int* n, int, int) {
    const int err = configured();
    if (err != 0) return err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        n, decode_wide_kernel<DK, DV>, kThreads, kBytes);
  }
  static int launch(const Args& a) {
    const int err = configured();
    if (err != 0) return err;
    const int n = a.splits();
    const Parts parts(a.scratch, a.B, a.H, n);
    decode_wide_kernel<DK, DV><<<dim3(a.B, (a.H + kHeads - 1) / kHeads, n),
                                 kThreads, kBytes, a.stream>>>(
        (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.k,
        (const __nv_bfloat16*)a.v, (const int32_t*)a.table,
        (const int32_t*)a.lens, n > 1 ? nullptr : (__nv_bfloat16*)a.out,
        parts.m, parts.l, parts.acc, a.H, a.P, a.page, a.n_slots,
        a.split_pages(), a.d, a.dv, a.inv_scale);
    return merge<__nv_bfloat16>(a, parts);
  }
};

// route 5: bfloat16 at MLA's latent widths on wgmma, 64 heads a block; the
// shared memory depends on (d, dv) (wg_plan), so the kernel may take up to
// an H100 block's most.  The blocks of a (row, split) are neighbours.
struct Wg {
  static int heads() { return kWgHeads; }
  static int configured() {
    static const int err = configure(decode_wgmma_kernel, kSmemLimit);
    return err;
  }
  static int blocks_per_sm(int* n, int d, int dv) {
    const int err = configured();
    if (err != 0) return err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        n, decode_wgmma_kernel, kWgThreads, wg_plan(d, dv).smem_bytes);
  }
  static int launch(const Args& a) {
    const int err = configured();
    if (err != 0) return err;
    const WgPlan plan = wg_plan(a.d, a.dv);
    const int n = a.splits();
    const Parts parts(a.scratch, a.B, a.H, n);
    const int64_t blocks = (int64_t)a.B * n * ((a.H + kWgHeads - 1) / kWgHeads);
    decode_wgmma_kernel<<<(unsigned)blocks, kWgThreads, plan.smem_bytes,
                          a.stream>>>(
        (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.k,
        (const __nv_bfloat16*)a.v, (const int32_t*)a.table,
        (const int32_t*)a.lens, n > 1 ? nullptr : (__nv_bfloat16*)a.out,
        parts.m, parts.l, parts.acc, a.H, a.P, a.page, a.n_slots,
        a.split_pages(), n, a.d, a.dv, a.inv_scale, plan);
    return merge<__nv_bfloat16>(a, parts);
  }
};

template <typename T, int KC, int VC>
struct Lanes {                         // route 2: any width, CUDA cores
  static int heads() { return kLaneHeads; }
  static int blocks_per_sm(int* n, int, int) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        n, decode_lanes_kernel<T, KC, VC>, kThreads, 0);
  }
  static int launch(const Args& a) {
    const int n = a.splits();
    const Parts parts(a.scratch, a.B, a.H, n);
    decode_lanes_kernel<T, KC, VC>
        <<<dim3(a.B, (a.H + kLaneHeads - 1) / kLaneHeads, n), kThreads, 0,
           a.stream>>>(
            (const T*)a.q, (const T*)a.k, (const T*)a.v,
            (const int32_t*)a.table, (const int32_t*)a.lens,
            n > 1 ? nullptr : (T*)a.out, parts.m, parts.l, parts.acc, a.H,
            a.P, a.page, a.n_slots, a.split_pages(), a.d, a.dv, a.inv_scale);
    return merge<T>(a, parts);
  }
};

// route 3: float32 and ragged bfloat16 past the lanes' widths on the
// tensor cores in TF32; the shared memory depends on (d, dv) and the type
// (walk_plan), so the kernel may take up to an H100 block's most
template <typename T>
struct Walk {
  static constexpr int kBf16 = sizeof(T) == 2;
  static int heads() { return kHeads; }
  static int configured() {
    static const int err = configure(decode_walk_kernel<T>, kSmemLimit);
    return err;
  }
  static int blocks_per_sm(int* n, int d, int dv) {
    const int err = configured();
    if (err != 0) return err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        n, decode_walk_kernel<T>, kWkThreads,
        walk_plan(d, dv, kBf16).smem_bytes);
  }
  static int launch(const Args& a) {
    const int err = configured();
    if (err != 0) return err;
    const WalkPlan plan = walk_plan(a.d, a.dv, kBf16);
    const int n = a.splits();
    const Parts parts(a.scratch, a.B, a.H, n);
    const int64_t blocks =
        (int64_t)a.B * n * ((a.H + kHeads - 1) / kHeads) * plan.groups;
    decode_walk_kernel<T><<<(unsigned)blocks, kWkThreads, plan.smem_bytes,
                            a.stream>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const int32_t*)a.table,
        (const int32_t*)a.lens, n > 1 ? nullptr : (T*)a.out, parts.m,
        parts.l, parts.acc, a.H, a.P, a.page, a.n_slots, a.split_pages(), n,
        a.d, a.dv, a.inv_scale);
    return merge<T>(a, parts);
  }
};

// route 4: bfloat16 past the lanes' widths on the tensor cores; the
// shared memory depends on (d, dv) (walk_tc_plan), so the kernel may take
// up to an H100 block's most
struct WalkTc {
  static int heads() { return kHeads; }
  static int configured() {
    static const int err = configure(decode_walk_tc_kernel, kSmemLimit);
    return err;
  }
  static int blocks_per_sm(int* n, int d, int dv) {
    const int err = configured();
    if (err != 0) return err;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        n, decode_walk_tc_kernel, kWtThreads, walk_tc_plan(d, dv).smem_bytes);
  }
  static int launch(const Args& a) {
    const int err = configured();
    if (err != 0) return err;
    const WalkTcPlan plan = walk_tc_plan(a.d, a.dv);
    const int n = a.splits();
    const Parts parts(a.scratch, a.B, a.H, n);
    decode_walk_tc_kernel<<<dim3(a.B, (a.H + kHeads - 1) / kHeads
                                          * plan.groups, n),
                            kWtThreads, plan.smem_bytes, a.stream>>>(
        (const __nv_bfloat16*)a.q, (const __nv_bfloat16*)a.k,
        (const __nv_bfloat16*)a.v, (const int32_t*)a.table,
        (const int32_t*)a.lens, n > 1 ? nullptr : (__nv_bfloat16*)a.out,
        parts.m, parts.l, parts.acc, a.H, a.P, a.page, a.n_slots,
        a.split_pages(), a.d, a.dv, a.inv_scale);
    return merge<__nv_bfloat16>(a, parts);
  }
};

// route 0, float32: up to 8 query heads a block, 4 when there are few
template <int D, typename F>
int dispatch_f32(int H, const F& f) {
  if (H > 4) return f.template run<Workers<float, D, 8>>();
  return f.template run<Workers<float, D, 4>>();
}

// the instances (route, DK, DV) that the wrapper's decode_attention.instance
// picks
template <typename F>
int dispatch(int route, int bf16, int DK, int DV, int H, const F& f) {
  if (route == 0 && !bf16 && DK == DV) {
    switch (DK) {
      case 16: return dispatch_f32<16>(H, f);
      case 32: return dispatch_f32<32>(H, f);
      case 64: return dispatch_f32<64>(H, f);
      case 128: return dispatch_f32<128>(H, f);
    }
  }
  if (route == 1 && bf16) {
    if (DK == DV) {
      switch (DK) {
        case 16: return f.template run<TensorCores<16>>();
        case 32: return f.template run<TensorCores<32>>();
        case 64: return f.template run<TensorCores<64>>();
        case 128: return f.template run<TensorCores<128>>();
        case 256: return f.template run<Wide<256, 256>>();
      }
    }
  }
  if (route == 2 && DK == 576 && DV == 512)
    return bf16 ? f.template run<Lanes<__nv_bfloat16, 576 / 32, 512 / 32>>()
                : f.template run<Lanes<float, 576 / 32, 512 / 32>>();
  if (route == 3)
    return bf16 ? f.template run<Walk<__nv_bfloat16>>()
                : f.template run<Walk<float>>();
  if (route == 4 && bf16) return f.template run<WalkTc>();
  if (route == 5 && bf16 && DK <= kWgMaxD && DV <= kWgMaxDv)
    return f.template run<Wg>();
  return (int)cudaErrorInvalidValue;
}

struct Launch {
  Args a;
  template <typename K>
  int run() const { return K::launch(a); }
};

struct Plan {
  int* heads;
  int* blocks_per_sm;
  int d, dv;
  template <typename K>
  int run() const {
    *heads = K::heads();
    return K::blocks_per_sm(blocks_per_sm, d, dv);
  }
};

}  // namespace

extern "C" {

// q [B, H, d] (route 1: zero-padded to [B, H, DK]), k pages [n_slots,
// page, d], v pages [n_slots, page, dv] and out [B, H, dv] of one type
// (bf16 != 0: bfloat16, else float32), page_table [B, P] and seq_lens [B]
// int32, all contiguous; scratch fp32 of (dv + 2) * B * H * n_splits
// floats when n_splits > 1 (unused otherwise).  The instance is (route,
// DK, DV): route 0 float32 at d = dv = DK = DV in {16, 32, 64, 128};
// route 1 bfloat16 at d <= DK, dv <= DV, both multiples of 8, (DK, DV) in
// {(16, 16), (32, 32), (64, 64), (128, 128), (256, 256)}; route 2 either
// type at d <= DK = 576, dv <= DV = 512; route 3 either type at d = DK,
// dv = DV; route 4 bfloat16 at d = DK, dv = DV, both multiples of 8; route
// 5 bfloat16 at d = DK <= 576, dv = DV <= 512, both multiples of 8.
// Scores are q.k * inv_scale.  Returns a CUDA error code;
// cudaErrorInvalidValue for an instance that is not built or widths it
// does not take.
int decode_attention(const void* q, const void* k_pages, const void* v_pages,
                     const void* page_table, const void* seq_lens, void* out,
                     void* scratch, int B, int H, int d, int dv, int P,
                     int page, int n_slots, int n_splits, int route, int DK,
                     int DV, float inv_scale, int bf16, void* stream) {
  if (n_splits < 1 || (n_splits > 1 && n_splits > P) || d < 1 || dv < 1
      || d > DK || dv > DV || (route == 0 && (d != DK || dv != DV))
      || ((route == 1 || route >= 4) && (d % 8 != 0 || dv % 8 != 0))
      || (route >= 3 && (d != DK || dv != DV)))
    return (int)cudaErrorInvalidValue;
  const Launch f{{q, k_pages, v_pages, page_table, seq_lens, out,
                  (float*)scratch, B, H, P, page, n_slots, n_splits, d, dv,
                  inv_scale, (cudaStream_t)stream}};
  return dispatch(route, bf16, DK, DV, H, f);
}

// What the wrapper's split planner reads: the query heads a pass-1 block
// of the instance (route, DK, DV) takes and how many such blocks an SM
// holds at once.  Returns a CUDA error code.
int decode_attention_plan(int route, int DK, int DV, int H, int bf16,
                          int* heads, int* blocks_per_sm) {
  return dispatch(route, bf16, DK, DV, H,
                  Plan{heads, blocks_per_sm, DK, DV});
}

// Route 5's plan at (d, dv) as the kernel computes it, into fields[7]:
// heads, tile, k_boxes, v_boxes, q_resident (Q's boxes stay in shared
// memory for the block's life: always), stages, smem_bytes (the
// wrapper's wg_plan).
void decode_wg_plan(int d, int dv, int* fields) {
  const WgPlan p = wg_plan(d, dv);
  const int f[7] = {kWgHeads, kWgTile, p.k_boxes, p.v_boxes, 1, p.stages,
                    p.smem_bytes};
  for (int i = 0; i < 7; ++i) fields[i] = f[i];
}

// Route 4's plan at (d, dv) as the kernel computes it, into fields[10]:
// tile, chunk, k_chunks, groups, group_cols, v_chunks, q_resident,
// entry_rows, stages, smem_bytes (the wrapper's walk_tc_plan).
void decode_walk_tc_plan(int d, int dv, int* fields) {
  const WalkTcPlan p = walk_tc_plan(d, dv);
  const int f[10] = {kWtTile, kWtChunk, p.k_chunks, p.groups, p.group_cols,
                     p.v_chunks, p.q_resident, p.entry_rows, kWtStages,
                     p.smem_bytes};
  for (int i = 0; i < 10; ++i) fields[i] = f[i];
}

// Route 3's plan at (d, dv) in a type (bf16 != 0: bfloat16, else
// float32) as the kernel computes it, into fields[15]: tile, chunk,
// window, stages, k_chunks, groups, group_cols, v_chunks, q_resident,
// entry_rows, k_pitch, v_pitch, q_pitch, shift_tiles, smem_bytes (the
// wrapper's walk_plan).
void decode_walk_plan(int d, int dv, int bf16, int* fields) {
  const WalkPlan p = walk_plan(d, dv, bf16);
  const int f[15] = {kWkTile, kWkChunk, p.window, p.stages, p.k_chunks,
                     p.groups, p.group_cols, p.v_chunks, p.q_resident,
                     p.entry_rows, p.k_pitch, p.v_pitch, p.q_pitch,
                     p.shift_tiles, p.smem_bytes};
  for (int i = 0; i < 15; ++i) fields[i] = f[i];
}

// The TF32 walk's windows (copy_windows) for columns col0 .. col0 + n - 1
// of the pool rows that start at elements row_e0[i] (-1: zero-filled) of a
// pool of `total` elements: the first element of the first window (-1
// where nothing is read), their number and the bytes they read (the
// wrapper's walk_windows).
void decode_walk_windows(const int64_t* row_e0, int count, int col0, int n,
                         int64_t total, int bf16, int64_t* base, int* nwin,
                         int* bytes) {
  for (int i = 0; i < count; ++i) {
    const WindowRow r = bf16 ? window_row<__nv_bfloat16>(row_e0[i], total)
                             : window_row<float>(row_e0[i], total);
    nwin[i] = bf16 ? window_count<__nv_bfloat16>(r, n)
                   : window_count<float>(r, n);
    base[i] = r.base < 0 ? -1 : r.base + col0;
    bytes[i] = 0;
    for (int w = 0; w < nwin[i]; ++w)
      bytes[i] += bf16 ? window_bytes<__nv_bfloat16>(r, col0, w)
                       : window_bytes<float>(r, col0, w);
  }
}

}  // extern "C"
