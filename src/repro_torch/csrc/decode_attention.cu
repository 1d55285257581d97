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
//   1  bfloat16 with rows of whole 16-byte chunks (d, dv multiples of 8):
//      decode_bf16_kernel<D> for d, dv <= D in {16, 32, 64, 128}, and
//      decode_wide_kernel<DK, DV> at (256, 256) and (576, 512), whose Q
//      and accumulator do not fit registers at those widths;
//   2  any other width up to (576, 512), either type: decode_lanes_kernel,
//      a warp a token and a column of 32 a lane, scalar loads;
//   3  past (576, 512), float32 and bfloat16 rows that are not whole
//      16-byte chunks: decode_walk_kernel, the lanes' scheme with the key
//      width walked and value columns in groups of kWalkCols;
//   4  past (576, 512), bfloat16 at d, dv multiples of 8:
//      decode_walk_tc_kernel, 16 heads a block on the tensor cores, K and
//      V walked through a ring of cp.async entries, each byte read once
//      up to dv = kWtCols.
// Columns of an instance past d (or dv) are zero in shared memory and
// registers, never read from the pool; q is zero-padded to DK by the
// wrapper for route 1 (a copy of q only).
//
// bfloat16 runs pass 1 on the tensor cores (decode_bf16_kernel: 16 heads a
// block as the rows of mma.sync, K/V tiles staged by cp.async).  float32
// stays on the CUDA cores, since its 2e-5 tolerance rules out TF32
// (decode_kernel: up to 8 heads a block; a "worker" of D / 4 lanes owns one
// token at a time, each lane loading one 16-byte vector of the token's K
// row and one of its V row, the group summing its partial dots with
// shuffles; every worker keeps its own softmax state in registers over
// the tokens it owns, four tokens a step so that eight 16-byte loads are
// in flight per lane, and the workers' states are merged through shared
// memory).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

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

// Pass 1 for bfloat16 at wide rows, on the tensor cores: (256, 256) and
// MLA's latent (576, 512).  Q fragments of 16 heads at d 576 would take
// 144 registers a thread and the [16, dv] accumulator 256, so here Q sits
// in shared memory (read by ldmatrix each k-step) and the four warps split
// the accumulator's columns instead of the tokens: warp w scores tokens
// 8 w .. 8 w + 7 of each tile of kWideTile for all 16 heads (S = Q K^T on
// mma.sync.m16n8k16), the tile's per-head maximum is taken across the
// warps through shared memory, so that all warps keep one running max;
// each warp writes its probabilities to shared memory as bf16 and then
// adds P V for its DV / 4 value columns over all the tile's tokens.  The
// running sum is kept per warp (of its tokens) and summed at the end.  K
// and V tiles are double-buffered with cp.async as in decode_bf16_kernel.
// Per block at (576, 512): Q 16 x 584, K 2 x 32 x 584, V 2 x 32 x 520 and
// P 16 x 40 bf16, 162,048 bytes of shared memory with the offsets and
// sums, so an SM holds one block; 78,080 bytes at (256, 256), two.
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

// Pass 1 past the lanes kernel's widths (route 3: d past 576 or dv past
// 512, either type), on the CUDA cores: decode_lanes_kernel's scheme, a
// warp a token and lane l holding columns l, l + 32, ..., with two
// changes.  The key width is walked at run time, 32 columns a step, q
// read in place (each lane its columns of the block's kLaneHeads heads,
// from the L1) instead of from registers; so any d runs.  The value
// columns are cut into groups of kWalkCols, a block each (grid y: head
// chunk x value group), whose accumulators stay in registers as the
// lanes kernel's; each group's block recomputes the scores, so values
// dv wide cost ceil(dv / kWalkCols) times the q.k work.  Group 0 writes
// the split's max and sum (every group computes the same ones).
constexpr int kWalkCols = 512;

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_walk_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                   const T* __restrict__ v_pages,
                   const int32_t* __restrict__ table,
                   const int32_t* __restrict__ seq_lens, T* __restrict__ out,
                   float* __restrict__ part_m, float* __restrict__ part_l,
                   float* __restrict__ part_acc, int H, int P, int page,
                   int n_slots, int split_pages, int d, int dv,
                   float inv_scale) {
  constexpr int G = kLaneHeads, U = kLaneUnroll, NW = kThreads / 32;
  constexpr int STEP = NW * U;          // tokens a block step
  constexpr int VC = kWalkCols / 32;
  __shared__ float m_s[NW * G];
  __shared__ float l_s[NW * G];
  __shared__ float acc_s[NW * G * 32 * VC];

  const int groups = (dv + kWalkCols - 1) / kWalkCols;
  const int row = blockIdx.x;
  const int h0 = blockIdx.y / groups * G;
  const int v0 = blockIdx.y % groups * kWalkCols;
  const int cols = min(kWalkCols, dv - v0);
  const int split = blockIdx.z;
  const int n_splits = gridDim.z;
  const int gn = min(G, H - h0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qh[G];
#pragma unroll
  for (int g = 0; g < G; ++g)           // heads past H read head h0
    qh[g] = q + ((int64_t)row * H + h0 + (g < gn ? g : 0)) * d;

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
      bool ok[U];
      const T* kr[U];
      float s[U][G];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = base + warp * U + u;
        ok[u] = t < n_valid;
        kr[u] = k_pages + (tok0 + (ok[u] ? t : 0)) * d;
#pragma unroll
        for (int g = 0; g < G; ++g) s[u][g] = 0.f;
      }
      for (int c0 = 0; c0 < d; c0 += 32) {
        const int col = c0 + lane;
        if (col >= d) continue;
        float qv[G];
#pragma unroll
        for (int g = 0; g < G; ++g) qv[g] = to_f32(qh[g][col]);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float kv = ok[u] ? to_f32(kr[u][col]) : 0.f;
#pragma unroll
          for (int g = 0; g < G; ++g) s[u][g] = fmaf(qv[g], kv, s[u][g]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float part = s[u][g];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, off);
          s[u][g] = part * inv_scale;
        }
      float vx[U][VC];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const T* vr = v_pages + (tok0 + base + warp * U + u) * dv + v0;
#pragma unroll
        for (int c = 0; c < VC; ++c) {
          const int col = lane + 32 * c;
          vx[u][c] = ok[u] && col < cols ? to_f32(vr[col]) : 0.f;
        }
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
  for (int i = threadIdx.x; i < gn * cols; i += kThreads) {
    const int g = i / cols, c = i % cols;
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
      store(out + rh * dv + v0 + c, A / fmaxf(L, 1e-30f));
    } else {
      part_acc[(rh * n_splits + split) * dv + v0 + c] = A;
      if (c == 0 && v0 == 0) {
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

// cp_async16 that also asks the L2 to fetch the 256 bytes around the
// source: the next chunk of a token's row then comes from the L2
__device__ __forceinline__ void cp_async16_l2(uint32_t dst, const void* src,
                                              bool ok) {
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0) : "memory");
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
                   src + (ok ? off * width + col0 + c : 0), ok);
      }
      if (key && !plan.q_resident && threadIdx.x < kHeads * 8) {
        const int hh = threadIdx.x / 8, c = (threadIdx.x % 8) * 8;
        const bool ok = hh < gn && col0 + c < d;
        cp_async16_l2(smem_addr(dst + (kWtTile + hh) * kWtPitch + c),
                   qrow + (ok ? hh * d + col0 + c : 0), ok);
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

template <typename T>
struct Walk {                          // route 3: past the lanes' widths
  static int heads() { return kLaneHeads; }
  static int blocks_per_sm(int* n, int, int) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        n, decode_walk_kernel<T>, kThreads, 0);
  }
  static int launch(const Args& a) {
    const int n = a.splits();
    const Parts parts(a.scratch, a.B, a.H, n);
    const int groups = (a.dv + kWalkCols - 1) / kWalkCols;
    decode_walk_kernel<T>
        <<<dim3(a.B, (a.H + kLaneHeads - 1) / kLaneHeads * groups, n),
           kThreads, 0, a.stream>>>(
            (const T*)a.q, (const T*)a.k, (const T*)a.v,
            (const int32_t*)a.table, (const int32_t*)a.lens,
            n > 1 ? nullptr : (T*)a.out, parts.m, parts.l, parts.acc, a.H,
            a.P, a.page, a.n_slots, a.split_pages(), a.d, a.dv, a.inv_scale);
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
    if (DK == 576 && DV == 512)
      return f.template run<Wide<576, 512>>();
  }
  if (route == 2 && DK == 576 && DV == 512)
    return bf16 ? f.template run<Lanes<__nv_bfloat16, 576 / 32, 512 / 32>>()
                : f.template run<Lanes<float, 576 / 32, 512 / 32>>();
  if (route == 3)
    return bf16 ? f.template run<Walk<__nv_bfloat16>>()
                : f.template run<Walk<float>>();
  if (route == 4 && bf16) return f.template run<WalkTc>();
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
// {(16, 16), (32, 32), (64, 64), (128, 128), (256, 256), (576, 512)};
// route 2 either type at d <= DK = 576, dv <= DV = 512; route 3 either
// type at any d <= DK, dv <= DV (the wrapper passes its d and dv); route
// 4 bfloat16 at d = DK, dv = DV, both multiples of 8.
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
      || ((route == 1 || route == 4) && (d % 8 != 0 || dv % 8 != 0))
      || (route == 4 && (d != DK || dv != DV)))
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

}  // extern "C"
