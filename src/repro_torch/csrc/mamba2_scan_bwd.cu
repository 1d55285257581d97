// Backward of the chunked Mamba2 SSD scan for Hopper (sm_90a), plain C
// interface.
//
// Differentiates: src/repro/kernels/mamba2_scan/mamba2_scan.py:
// mamba2_scan_kernel, whose forward csrc/mamba2_scan.cu computes.  The
// Pallas kernel has no backward of its own: the reference differentiates
// its pure-jnp chunked scan (models/ssm.py: ssd_chunked), as the port's
// plain backward differentiates mamba2_scan_plain.
//
// Forward, per batch row b, head h (group g) and chunk of Q positions,
// with a = dt A, cum its inclusive sum within the chunk, L[i][j] =
// exp(cum_i - cum_j) for j <= i, dtx = dt x and s_prev the state entering
// the chunk:
//   y_i   = sum_{j <= i} (C_i . B_j) L[i][j] dtx_j + exp(cum_i) C_i s_prev
//   s_new = exp(cum_{Q-1}) s_prev + sum_j exp(cum_{Q-1} - cum_j) B_j dtx_j^T
// Backward, with g = dy, dS the gradient of s_new and E_j =
// exp(cum_{Q-1} - cum_j):
//   ds_prev   = sum_i exp(cum_i) C_i g_i^T + exp(cum_{Q-1}) dS
//   d dtx_j   = sum_{i >= j} (C_i . B_j) L[i][j] g_i + E_j dS^T B_j
//   dx_j      = dt_j d dtx_j
//   dC_i      = sum_{j <= i} L[i][j] (g_i . dtx_j) B_j + exp(cum_i) s_prev g_i
//   dB_j      = sum_{i >= j} L[i][j] (g_i . dtx_j) C_i + E_j dS dtx_j
//   dcum_i    = sum_j W[i][j] - sum_k W[k][i] + exp(cum_i) C_i . (s_prev g_i)
//               - V_i + [i = Q-1] (exp(cum_{Q-1}) <s_prev, dS> + sum_j V_j)
//     with W[i][j] = (C_i . B_j) L[i][j] (g_i . dtx_j), V_j = E_j B_j . (dS dtx_j)
//   da_k      = sum_{i >= k} dcum_i
//   ddt_k     = A da_k + x_k . d dtx_k,   dA = sum_k dt_k da_k
// B and C belong to a group of H / G heads, so dB and dC are sums over
// the group's heads, and dA over the chunks.
//
// Layout: x, dy, dx [B, S, H, P] and Bm, Cm, dB, dC [B, S, G, N] in x's
// type; dt, ddt [B, S, H], A, dA [B * H], dstate (or null: zeros) and
// dinit [B, H, N, P] fp32; s_prev, the state entering each chunk, as bf16
// hi and lo halves [B, chunks, H, 2, N, P] (the bf16 forward's scratch; the
// fp32 forward's fp32 states split so); all contiguous.  fp32 inputs reach
// the kernels split, each value as its bf16 rounding hi and the rounding
// of the rest lo, interleaved a row at a time (x, dy [B, S, H, 2, P], Bm,
// Cm [B, S, G, 2, N]; ssd_bwd_split).  A last chunk shorter than Q is
// padded with zeros, as in the forward.
//
// Bound: bytes.  At zamba2-2.7b's training shape (4 x 80 heads, S 2048,
// Q 128, N = P = 64, bf16) the inputs (x, dt, A, Bm, Cm, init, dy,
// dstate) and their gradients once are 277 MB, 0.083 ms at 3.35 TB/s
// (the saved states this design reads add 84 MB); the chunk products
// (g dtx^T, M^T g, LG B, LG^T C a head, 2 Q^2 64 flops each, and C B^T a
// group) and the state terms (4 x 2 Q N P a head) are 64.5 GFLOP, 0.065
// ms at the bf16 tensor-core peak.  At mamba2-2.7b's (N 128, the same
// heads, tokens and chunk) the operations bound it: 108 GFLOP, 0.109 ms,
// against 0.089 ms for its 297 MB.
//
// Design, both types: five kernels of independent blocks on
// mma.sync.m16n8k16 (bf16 in, fp32 sums), no atomics, so two runs are
// bit-equal.  A block of kernels (a), (c1) and (c2) takes (b, chunk, a
// tile of `heads` heads of one group), planned as the forward plans its
// heads (the wrapper's plan_heads, from the blocks of (c2) an SM holds):
// dB and dC, which belong to the group, are summed over the block's heads
// before they leave, not written a head.  C B^T is formed again for each
// head, a 16 x 16 tile at a time (8 mma of the 32 (c1) or 48 (c2) a tile
// takes): holding it across heads, as the forward does, would cost (c1)
// and (c2) 72 more registers a thread, at 254 and 255 already, or 36 KB
// of shared memory and so their second block an SM.  mma.sync and not
// wgmma: each warp walks its own 16-row tiles of the triangle, which a
// 64-row warpgroup product would pad or cut.
//   (a) ssd_state_kernel<true> (csrc/ssd_tc.cuh, the forward's pass (a)
//       with C for B, dy for x and exp(cum) for its weights): each head's
//       sum_i exp(cum_i) C_i g_i^T [N, P] and the chunk's decay.
//   (b) ssd_bwd_pass_split: a thread per state element of each (b, h)
//       walks the chunks from the last in fp32 and writes the gradient of
//       the state leaving each chunk as bf16 hi and lo halves (what the
//       mma reads); dinit leaves here.  Reading and writing separate
//       arrays lets its loads run ahead of the chain: 0.07 ms at zamba2's
//       training shape, where the same walk in place took 0.42.
//   (c1) ssd_bwd_rows, 4 warps to a tile of 64 state rows: warp w owns the
//       row tiles w and RT - 1 - w (the same share of the triangle for
//       every warp, as the forward's output pass).  Each head: g s_prev^T
//       (the state part of dC and the inter term), then, tile by tile on
//       and below the diagonal, C B^T and g x^T on the tensor cores, M =
//       C B^T L, W's row sums and LG = L (g . dtx) in registers, and dC +=
//       LG B.  dC of the block's heads is summed in registers and leaves
//       once a tile of heads; W's row sums plus the inter term leave a head.
//   (c2) ssd_bwd_cols, the transposed products, a warp owning column
//       tiles: each head x dS^T (V and the state part of dB) and B dS
//       (that of d dtx), then tile by tile (B C^T and x g^T, so that M^T
//       and LG^T come out in the accumulator layout that an A operand
//       takes) d dtx += M^T g and dB += LG^T C, W's column sums; then dx,
//       x . d dtx, and a warp scan for dcum, da, ddt and the chunk's part
//       of dA.  dB of the block's heads is summed in registers.
//   (d) ssd_bwd_reduce: dB and dC as the sums over each group's tiles of
//       heads and dA over the chunks, in order, in the inputs' type.
// Every operand that is not an input (M, LG, dS, the exp-scaled C^T of
// (a), s_prev) is split into a bf16 hi and a bf16 remainder lo and
// multiplied twice, as the forward does (csrc/mamba2_scan.cu explains
// why): the sums stay fp32 and the mma's error stays near 2^-17 of each
// product.  The triangle above the diagonal is skipped.
//
// State sizes past 64 (N up to 128, mamba2's d_state): the block takes a
// second group of 4 warps (two when the chunk has at most 4 row tiles,
// where 2 warps cover them), one group a tile of 64 state rows, so that
// no warp holds more accumulators than at N 64 (dC and dB a tile of N,
// C's and B's fragments of it).  The SSD is separable over the state's
// rows: C B^T, W, V, the inter term, <s_prev, dS> and d dtx are sums over
// n, so each group forms its tile's part; (c1) leaves W's row sums plus
// the inter term a tile of N (rsi [.., N tiles, Qp], summed by (c2)), and
// in (c2) the second group hands its d dtx, W's column sums and V to the
// first through shared memory before dx and the scan.  g x^T, which does
// not depend on n, is formed by both groups, in parallel.
//
// fp32 (the agreement checks, held to 1e-4): the same kernels.  Each input
// (x, Bm, Cm, dy and the forward's fp32 s_prev) is split into bf16 hi + lo
// by ssd_bwd_split before the kernels, and every product with an input
// takes its third mma (hi hi, hi lo, lo hi; lo lo, 2^-16 of the product,
// is left out); scalars read from an input sum its two planes; the sums
// stay fp32.  Shared memory holds both planes of B or C and of x and dy.
//
// Shared memory: C (in c1) and B (in c2) enter the products as A operands
// loaded from global memory once a column tile, so shared memory holds B
// or C, two buffers of x and dy (the next head's staged by cp.async while
// the current one computes) and one of s_prev or dS, which is used first
// and refilled for the next head during the triangle: 113,168 bytes at Q
// 128, N = P = 64 in bf16, two blocks an SM.  Q, N and P are padded to
// multiples of 16 with zeros.  Scratch from the wrapper: the chunks' own
// state gradients [B, chunks, H, N, P] fp32, the state gradients at the
// chunks' ends [B, chunks, H, 2, N, P] bf16, the decays, W's row sums
// plus the inter term [B, chunks, H, N tiles, Qp] fp32, dB and dC a tile
// of heads [B, S, G tiles, N] fp32 and dA a chunk.
//
// Wider states (N past 128, P past 64) never reach these kernels: the
// wrapper runs them as groups of state rows and columns, as the forward,
// and sums the groups' parts in fp32: dB and dC over column groups, for
// which a bfloat16 launch can write them in float32 (ssd_bwd_reduce<float>
// after the bf16 chunk kernels), and dx over row groups, which a bf16
// input takes through the fp32 design on its exact fp32 values and on the
// bf16 forward's s_prev as the fp32 sum of its halves (mamba2_scan.py).
// Each sum is rounded to bf16 once.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ssd_tc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 128;
constexpr int kMaxN = 128;             // state rows (d_state) a launch
constexpr int kMaxP = 64;              // state columns (head dim) a launch
constexpr int kTileN = 64;             // state rows a group of warps takes
constexpr int kMaxHeads = 16;          // heads a block of (a), (c1), (c2)

template <typename T>
struct IsF32 {
  static constexpr bool value = false;
};
template <>
struct IsF32<float> {
  static constexpr bool value = true;
};

__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// tiles of 64 state rows (1 or 2), and the warps a tile takes in (c1) and
// (c2): 4, or 2 with two tiles when the chunk has at most 4 row tiles
__host__ __device__ constexpr int n_tiles(int N) {
  return (N + kTileN - 1) / kTileN;
}
__host__ __device__ constexpr int tc_threads(int Q, int N) {
  return n_tiles(N) > 1 && pad16(Q) <= 64 ? 2 * 2 * 32 : n_tiles(N) * 4 * 32;
}

// (c1) and (c2) shared memory: B (c1) or C (c2) [R][Qp][Np + 8]; two
// buffers of x and dy [2][2][R][Qp][Pp + 8]; s_prev (c1) or dS (c2), hi
// and lo [2][Np][Pp + 8]; all bf16 (R = 2 planes of a split fp32 input);
// dt, cum, W's column sums, V, x . d dtx [Qp] and a warp's part of
// <s_prev, dS> [4], fp32; with two tiles of N, (c2)'s exchange of d dtx
// [Qp][Pp], W's column sums and V [Qp], fp32
__host__ __device__ constexpr int tc_chunk_smem_bytes(int Q, int N, int P,
                                                      int R) {
  return 2 * (R * pad16(Q) * (pad16(N) + 8) + 4 * R * pad16(Q) * (pad16(P) + 8)
              + 2 * pad16(N) * (pad16(P) + 8))
         + 4 * (5 * pad16(Q) + 4)
         + (n_tiles(N) > 1 ? 4 * (pad16(Q) * pad16(P) + 2 * pad16(Q)) : 0);
}

// (b): the gradient of the state leaving each chunk, from the last, as
// bf16 hi and lo halves ds [B, chunks, H, 2, N, P]; dinit in fp32
__global__ void __launch_bounds__(kThreads)
ssd_bwd_pass_split(const float* __restrict__ ds_loc,
                   const float* __restrict__ dec,
                   const float* __restrict__ dstate, bf16* __restrict__ ds,
                   float* __restrict__ dinit, int nc, int H, int NP) {
  const int per = (NP + kThreads - 1) / kThreads;
  const int bh = blockIdx.x / per;
  const int e = (blockIdx.x % per) * kThreads + threadIdx.x;
  if (e >= NP) return;
  const int b = bh / H, h = bh % H;
  float cur = dstate ? dstate[(int64_t)bh * NP + e] : 0.f;
#pragma unroll 4
  for (int c = nc - 1; c >= 0; --c) {
    const int64_t u = ((int64_t)b * nc + c) * H + h;
    const bf16 hi = __float2bfloat16(cur);
    ds[2 * u * NP + e] = hi;
    ds[(2 * u + 1) * NP + e] = __float2bfloat16(cur - __bfloat162float(hi));
    cur = fmaf(dec[u], cur, ds_loc[u * NP + e]);
  }
  dinit[(int64_t)bh * NP + e] = cur;
}

// an fp32 input [rows][W] as bf16 [rows][2][W]: each value's rounding hi
// and the rounding of the rest lo
__global__ void __launch_bounds__(kThreads)
ssd_bwd_split(const float* __restrict__ src, bf16* __restrict__ dst,
              int64_t n, int W) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    const int64_t r = e / W;
    const int w = (int)(e % W);
    const float v = src[e];
    const bf16 hi = __float2bfloat16(v);
    dst[2 * r * W + w] = hi;
    dst[(2 * r + 1) * W + w] = __float2bfloat16(v - __bfloat162float(hi));
  }
}

// two bf16 as the packed pair an mma fragment holds (the first low)
__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
__device__ __forceinline__ float2 add2(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

// the A fragment of rows r0 .. r0 + 15, columns 16 ks .. 16 ks + 15 of a
// row-major bf16 matrix in global memory (row stride ld, n_rows rows and
// cols columns that hold data, zero past them; pairs: every pair of
// columns 4-byte aligned, as N even makes them).  Its registers also hold
// the accumulator layout's entries of the n-tiles 2 ks (regs 0, 1) and
// 2 ks + 1 (regs 2, 3): rows g (regs 0, 2) and g + 8, columns 2t, 2t + 1
__device__ __forceinline__ void a_frag_global(uint32_t* a, const bf16* m,
                                              int64_t ld, int r0, int n_rows,
                                              int cols, int ks, bool pairs) {
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + g + 8 * (r & 1), col = ks * 16 + 2 * t4 + 8 * (r >> 1);
    const bf16* p = m + row * ld;
    const bf16 z = __float2bfloat16(0.f);
    if (row >= n_rows)
      a[r] = 0u;
    else if (col + 1 < cols && pairs)
      a[r] = *reinterpret_cast<const uint32_t*>(p + col);
    else
      a[r] = pack2(col < cols ? p[col] : z, col + 1 < cols ? p[col + 1] : z);
  }
}

// acc[j] (n-tiles j < NTL <= 8) += a @ B for B [k = 16][n] held as the
// row-major [n][k] rows at b (shared address of this lane's b_lane row,
// ld16 bytes between the 16-row pairs of n): plain ldmatrix
__device__ __forceinline__ void mma_nt(float (*acc)[4], const uint32_t* a,
                                       uint32_t b, int ld16, int NTL) {
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    if (j < NTL) {
      uint32_t bx[4];
      ldsm_x4(bx, b + (j / 2) * ld16);
      mma_bf16(acc[j], a, bx[0], bx[1]);
      mma_bf16(acc[j + 1], a, bx[2], bx[3]);
    }
  }
}

// c[8] (a 16 x 16 tile, n-tiles 0 and 1) += a @ the [n][k] tile whose
// b_lane row is at shared address b
__device__ __forceinline__ void mma_16(float* c, const uint32_t* a,
                                       uint32_t b) {
  uint32_t bk[4];
  ldsm_x4(bk, b);
  mma_bf16(c, a, bk[0], bk[1]);
  mma_bf16(c + 4, a, bk[2], bk[3]);
}

// v summed over the 4 lanes of a quad (the lanes of one accumulator row)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// a 16 x 16 accumulator tile (n-tiles 0 and 1) as hi and lo A fragments
__device__ __forceinline__ void split_tile(const float* v, uint32_t* ah,
                                           uint32_t* al) {
  split2(v[0], v[1], ah[0], al[0]);
  split2(v[2], v[3], ah[1], al[1]);
  split2(v[4], v[5], ah[2], al[2]);
  split2(v[6], v[7], ah[3], al[3]);
}

// the warp's two row (c1) or column (c2) tiles: w and RT - 1 - w, or one
// where they meet, or none past the middle
__device__ __forceinline__ int owned_tiles(int warp, int RT) {
  const int mirror = RT - 1 - warp;
  return warp < mirror ? 2 : warp == mirror ? 1 : 0;
}

// (c1): dC of the block's heads [B, S, G tiles, N] and, a head and a tile
// of N, W's row sums plus exp(cum_i) C_i . (s_prev g_i) into rsi [B,
// chunks, H, NW, Qp].  T: the inputs' type (float: split, R = 2 planes)
template <typename T, int NW>
__global__ void __launch_bounds__(kTcThreads * NW, 2 / NW)
ssd_bwd_rows(const bf16* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const bf16* __restrict__ Bm,
             const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
             const bf16* __restrict__ s_prev, float* __restrict__ dC_part,
             float* __restrict__ rsi, int S, int H, int G, int N, int P,
             int Q, int heads) {
  constexpr bool F32 = IsF32<T>::value;
  constexpr int R = F32 ? 2 : 1;
  const int Qp = pad16(Q), Np = pad16(N), Pp = pad16(P);
  const int NL = Np + 8, PL = Pp + 8;
  const int nc = (S + Q - 1) / Q, rep = H / G;
  const int tiles = (rep + heads - 1) / heads;
  const Tile tl = tile_of(blockIdx.x, nc, G, rep, heads);
  const int s0 = tl.c * Q, n_valid = min(Q, S - s0);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* b_s = reinterpret_cast<bf16*>(smem_raw);   // [R][Qp][NL]
  bf16* buf0 = b_s + R * Qp * NL;                   // x, dy [R][Qp][PL] each
  bf16* buf1 = buf0 + 2 * R * Qp * PL;
  bf16* sp_s = buf1 + 2 * R * Qp * PL;              // hi, lo [Np][PL]
  float* dt_s = reinterpret_cast<float*>(sp_s + 2 * Np * PL);
  float* cum_s = dt_s + Qp;

  const int64_t xld = (int64_t)H * P * R, bcld = (int64_t)G * N * R;
  const int64_t bc0 = (((int64_t)tl.b * S + s0) * G + tl.g) * N * R;
  const bf16* xb = x + ((int64_t)tl.b * S + s0) * xld;
  const bf16* gb = dy + ((int64_t)tl.b * S + s0) * xld;
  const int64_t unit = ((int64_t)tl.b * nc + tl.c) * H + tl.h0;
  auto stage_xg = [&](int hi, bf16* dst) {
    const int64_t off = (int64_t)(tl.h0 + hi) * P * R;
    stage_planes<R>(dst, PL, Qp, xb + off, xld, n_valid, P, Pp);
    stage_planes<R>(dst + R * Qp * PL, PL, Qp, gb + off, xld, n_valid, P, Pp);
    cp_async_commit();
  };
  auto stage_sp = [&](int hi) {
    stage_state(sp_s, s_prev + 2 * (unit + hi) * N * P, N, P);
    cp_async_commit();
  };
  stage_planes<R>(b_s, NL, Qp, Bm + bc0, bcld, n_valid, N, Np);
  stage_xg(0, buf0);
  stage_sp(0);

  // warp w: the row tiles of lw = w % wpt in the tile of N w / wpt
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wpt = NW > 1 ? blockDim.x / 32 / NW : 4;
  const int lw = NW > 1 ? warp % wpt : warp, nt = NW > 1 ? warp / wpt : 0;
  const int n0 = nt * kTileN, Nt = min(kTileN, N - n0);
  const int g8 = lane / 4, t4 = lane % 4;
  const int RT = Qp / 16, PT = Pp / 8, NT = pad16(Nt) / 8,
            NK = pad16(Nt) / 16, PK = Pp / 16;
  const int nrow = owned_tiles(lw, RT);
  const int rowt[2] = {lw, RT - 1 - lw};
  const int a_off = a_lane(lane, PL), b_offx = b_lane(lane, PL);
  const int b_offb = b_lane(lane, NL) + n0, bt_offb = bt_lane(lane, NL) + n0;
  const bf16* cm = Cm + bc0 + n0;      // C's columns of the tile; lo: + N
  const bool pairs = (N & 1) == 0;     // C's column pairs 4-byte aligned

  uint32_t cf[2][4][4];                // C's A fragments of the row tiles
  float dC[2][8][4];                   // dC of the row tiles, all heads
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      if (q < nrow && ks < NK)
        a_frag_global(cf[q][ks], cm, bcld, rowt[q] * 16, n_valid, Nt, ks,
                      pairs);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dC[q][j][0] = dC[q][j][1] = dC[q][j][2] = dC[q][j][3] = 0.f;
  }

  for (int hi = 0; hi < tl.nh; ++hi) {
    bf16* xs = (hi & 1) ? buf1 : buf0;
    bf16* gs = xs + R * Qp * PL;
    if (hi + 1 < tl.nh) stage_xg(hi + 1, (hi & 1) ? buf0 : buf1);
    chunk_cumsum(dt_s, cum_s, dt, A, Tile{tl.b, tl.c, tl.g, tl.h0 + hi, 1},
                 s0, n_valid, S, H, Qp);
    if (hi + 1 < tl.nh)
      cp_async_wait<1>();              // x, dy and s_prev of head hi
    else
      cp_async_wait<0>();
    __syncthreads();

    // g s_prev^T: the state part of dC and the inter term
    float inter[2][2];
    const bf16* spt = sp_s + n0 * PL;  // the tile's rows of s_prev
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (q >= nrow) continue;
      const int r = rowt[q];
      float tmp[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) tmp[j][0] = tmp[j][1] = tmp[j][2] = tmp[j][3] = 0.f;
      for (int ks = 0; ks < PK; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, smem_addr(gs + r * 16 * PL + a_off + ks * 16));
        mma_nt(tmp, a, smem_addr(spt + b_offx + ks * 16), 32 * PL, NT);
        mma_nt(tmp, a, smem_addr(spt + Np * PL + b_offx + ks * 16), 32 * PL,
               NT);
        if constexpr (F32) {           // dy's lo plane times s_prev's hi
          ldsm_x4(a, smem_addr(gs + (Qp + r * 16) * PL + a_off + ks * 16));
          mma_nt(tmp, a, smem_addr(spt + b_offx + ks * 16), 32 * PL, NT);
        }
      }
      const int i0 = r * 16 + g8, i1 = i0 + 8;
      const float e0 = __expf(cum_s[i0]), e1 = __expf(cum_s[i1]);
      float c0s = 0.f, c1s = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (ks >= NK) continue;
        uint32_t cl[4];                // C's lo plane (fp32 inputs)
        if constexpr (F32)
          a_frag_global(cl, cm + N, bcld, r * 16, n_valid, Nt, ks, pairs);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * ks + jj;
          float2 c0 = unpack2(cf[q][ks][jj ? 2 : 0]);
          float2 c1 = unpack2(cf[q][ks][jj ? 3 : 1]);
          if constexpr (F32) {
            c0 = add2(c0, unpack2(cl[jj ? 2 : 0]));
            c1 = add2(c1, unpack2(cl[jj ? 3 : 1]));
          }
          c0s = fmaf(c0.x, tmp[j][0], fmaf(c0.y, tmp[j][1], c0s));
          c1s = fmaf(c1.x, tmp[j][2], fmaf(c1.y, tmp[j][3], c1s));
          dC[q][j][0] = fmaf(e0, tmp[j][0], dC[q][j][0]);
          dC[q][j][1] = fmaf(e0, tmp[j][1], dC[q][j][1]);
          dC[q][j][2] = fmaf(e1, tmp[j][2], dC[q][j][2]);
          dC[q][j][3] = fmaf(e1, tmp[j][3], dC[q][j][3]);
        }
      }
      inter[q][0] = e0 * quad_sum(c0s);
      inter[q][1] = e1 * quad_sum(c1s);
    }
    __syncthreads();                   // s_prev is read: the next head's
    if (hi + 1 < tl.nh) stage_sp(hi + 1);

    // the triangle, tile (r, kt <= r) by tile
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (q >= nrow) continue;
      const int r = rowt[q];
      const int i0 = r * 16 + g8, i1 = i0 + 8;
      const float ci0 = cum_s[i0], ci1 = cum_s[i1];
      float rs0 = 0.f, rs1 = 0.f;
      for (int kt = 0; kt <= r; ++kt) {
        float cb[8], gd[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) cb[e] = gd[e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (ks >= NK) continue;
          const bf16* bk = b_s + kt * 16 * NL + b_offb + ks * 16;
          mma_16(cb, cf[q][ks], smem_addr(bk));
          if constexpr (F32) {         // C hi B lo, C lo B hi
            uint32_t cl[4];
            a_frag_global(cl, cm + N, bcld, r * 16, n_valid, Nt, ks, pairs);
            mma_16(cb, cf[q][ks], smem_addr(bk + Qp * NL));
            mma_16(cb, cl, smem_addr(bk));
          }
        }
        for (int ks = 0; ks < PK; ++ks) {
          uint32_t a[4];
          const bf16* ga = gs + r * 16 * PL + a_off + ks * 16;
          const bf16* xk = xs + kt * 16 * PL + b_offx + ks * 16;
          ldsm_x4(a, smem_addr(ga));
          mma_16(gd, a, smem_addr(xk));
          if constexpr (F32) {         // dy hi x lo, dy lo x hi
            mma_16(gd, a, smem_addr(xk + Qp * PL));
            ldsm_x4(a, smem_addr(ga + Qp * PL));
            mma_16(gd, a, smem_addr(xk));
          }
        }
        // entries e: rows i0 (e = 0, 1, 4, 5) and i1, columns j0 + (e & 1)
        // + 8 (e / 4), j0 = 16 kt + 2 t4
        float lg[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int i = (e & 2) ? i1 : i0;
          const int j = kt * 16 + 2 * t4 + (e & 1) + 8 * (e / 4);
          const float L = j <= i ? __expf(((e & 2) ? ci1 : ci0) - cum_s[j])
                                 : 0.f;
          const float gdv = gd[e] * dt_s[j];
          const float w = cb[e] * L * gdv;
          if (e & 2) rs1 += w; else rs0 += w;
          lg[e] = L * gdv;
        }
        uint32_t ah[4], al[4];
        split_tile(lg, ah, al);
        const bf16* bt = b_s + kt * 16 * NL + bt_offb;
        mma_split(dC[q], ah, al, smem_addr(bt), NT);
        if constexpr (F32)             // LG hi times B's lo plane
          mma_row(dC[q], ah, smem_addr(bt + Qp * NL), NT);
      }
      rs0 = quad_sum(rs0);
      rs1 = quad_sum(rs1);
      if (t4 == 0) {
        float* out = rsi + ((unit + hi) * NW + nt) * Qp;
        out[i0] = rs0 + inter[q][0];
        out[i1] = rs1 + inter[q][1];
      }
    }
    __syncthreads();                   // this head's buffers are refilled
  }
  // the block's dC: rows i0, i1 of each row tile, columns n0 + 8 j + 2 t4
  // (+ 1)
  const int64_t plane = (int64_t)G * tiles;
  const int ht = (tl.h0 - tl.g * rep) / heads;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (q >= nrow) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = rowt[q] * 16 + g8 + 8 * half;
      if (i >= n_valid) continue;
      float* out = dC_part + (((int64_t)tl.b * S + s0 + i) * plane
                              + (int64_t)tl.g * tiles + ht) * N + n0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = j * 8 + 2 * t4;
        if (j >= NT) continue;
        if (n < Nt) out[n] = dC[q][j][2 * half];
        if (n + 1 < Nt) out[n + 1] = dC[q][j][2 * half + 1];
      }
    }
  }
}

// (c2)'s column tile J done for a head: dx (rows j0 = 16 J + g8 and j0 +
// 8 of dxh, dx_ld apart), x . d dtx, and W's column sums, V and x . d dtx
// of those rows into shared memory; x from its R planes in xs
template <typename T, int R>
__device__ __forceinline__ void finish_cols(
    const float (&dd)[8][4], const float* cs, const float* vv, int J, int g8,
    int t4, const bf16* xs, const float* dt_s, T* dxh, int64_t dx_ld,
    int n_valid, int P, int PT, int Qp, int PL, float* cs_s, float* v_s,
    float* xd_s) {
  const int j0 = J * 16 + g8, j1 = j0 + 8;
  float xd0 = 0.f, xd1 = 0.f;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = half ? j1 : j0;
    const float dtj = dt_s[j];
    const bool row_ok = j < n_valid;
    T* dxr = dxh + j * dx_ld;
    float xd = 0.f;
#pragma unroll
    for (int pt = 0; pt < 8; ++pt) {
      const int p = pt * 8 + 2 * t4;
      if (pt >= PT) continue;
      const float d0 = dd[pt][2 * half], d1 = dd[pt][2 * half + 1];
      float2 xv = unpack2(*reinterpret_cast<const uint32_t*>(xs + j * PL + p));
      if constexpr (R == 2)
        xv = add2(xv, unpack2(*reinterpret_cast<const uint32_t*>(
                          xs + (Qp + j) * PL + p)));
      xd = fmaf(xv.x, d0, fmaf(xv.y, d1, xd));
      if (!row_ok) continue;
      if constexpr (R == 2) {
        if (p < P) dxr[p] = dtj * d0;
        if (p + 1 < P) dxr[p + 1] = dtj * d1;
      } else if (p + 1 < P && (P & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(dxr + p) =
            __floats2bfloat162_rn(dtj * d0, dtj * d1);
      } else {
        if (p < P) dxr[p] = __float2bfloat16(dtj * d0);
        if (p + 1 < P) dxr[p + 1] = __float2bfloat16(dtj * d1);
      }
    }
    if (half) xd1 = xd; else xd0 = xd;
  }
  xd0 = quad_sum(xd0);
  xd1 = quad_sum(xd1);
  if (t4 == 0) {
    cs_s[j0] = cs[0];
    cs_s[j1] = cs[1];
    v_s[j0] = vv[0];
    v_s[j1] = vv[1];
    xd_s[j0] = xd0;
    xd_s[j1] = xd1;
  }
}

// (c2): dx, ddt and the chunk's part of dA a head, dB of the block's heads
// [B, S, G tiles, N]
template <typename T, int NW>
__global__ void __launch_bounds__(kTcThreads * NW, 2 / NW)
ssd_bwd_cols(const bf16* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const bf16* __restrict__ Bm,
             const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
             const bf16* __restrict__ s_prev, const bf16* __restrict__ ds,
             const float* __restrict__ rsi, T* __restrict__ dx,
             float* __restrict__ ddt, float* __restrict__ dB_part,
             float* __restrict__ dA_part, int S, int H, int G, int N, int P,
             int Q, int heads) {
  constexpr bool F32 = IsF32<T>::value;
  constexpr int R = F32 ? 2 : 1;
  const int Qp = pad16(Q), Np = pad16(N), Pp = pad16(P);
  const int NL = Np + 8, PL = Pp + 8;
  const int nc = (S + Q - 1) / Q, rep = H / G;
  const int tiles = (rep + heads - 1) / heads;
  const Tile tl = tile_of(blockIdx.x, nc, G, rep, heads);
  const int s0 = tl.c * Q, n_valid = min(Q, S - s0);
  const int NP = N * P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* c_s = reinterpret_cast<bf16*>(smem_raw);   // [R][Qp][NL]
  bf16* buf0 = c_s + R * Qp * NL;                   // x, dy [R][Qp][PL] each
  bf16* buf1 = buf0 + 2 * R * Qp * PL;
  bf16* ds_s = buf1 + 2 * R * Qp * PL;              // hi, lo [Np][PL]
  float* dt_s = reinterpret_cast<float*>(ds_s + 2 * Np * PL);
  float* cum_s = dt_s + Qp;
  float* cs_s = cum_s + Qp;                         // W's column sums
  float* v_s = cs_s + Qp;                           // V
  float* xd_s = v_s + Qp;                           // x . d dtx
  float* red_s = xd_s + Qp;                         // [4]
  float* dd_x = red_s + 4;                          // [Qp][Pp] (NW > 1)
  float* cs_x = dd_x + Qp * Pp;                     // [Qp]
  float* v_x = cs_x + Qp;                           // [Qp]

  const int64_t xld = (int64_t)H * P * R, bcld = (int64_t)G * N * R;
  const int64_t bc0 = (((int64_t)tl.b * S + s0) * G + tl.g) * N * R;
  const bf16* xb = x + ((int64_t)tl.b * S + s0) * xld;
  const bf16* gb = dy + ((int64_t)tl.b * S + s0) * xld;
  const int64_t unit = ((int64_t)tl.b * nc + tl.c) * H + tl.h0;
  auto stage_xg = [&](int hi, bf16* dst) {
    const int64_t off = (int64_t)(tl.h0 + hi) * P * R;
    stage_planes<R>(dst, PL, Qp, xb + off, xld, n_valid, P, Pp);
    stage_planes<R>(dst + R * Qp * PL, PL, Qp, gb + off, xld, n_valid, P, Pp);
    cp_async_commit();
  };
  auto stage_ds = [&](int hi) {
    stage_state(ds_s, ds + 2 * (unit + hi) * NP, N, P);
    cp_async_commit();
  };
  stage_planes<R>(c_s, NL, Qp, Cm + bc0, bcld, n_valid, N, Np);
  stage_xg(0, buf0);
  stage_ds(0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wpt = NW > 1 ? blockDim.x / 32 / NW : 4;
  const int lw = NW > 1 ? warp % wpt : warp, nt = NW > 1 ? warp / wpt : 0;
  const int n0 = nt * kTileN, Nt = min(kTileN, N - n0);
  const int g8 = lane / 4, t4 = lane % 4;
  const int RT = Qp / 16, PT = Pp / 8, NT = pad16(Nt) / 8,
            NK = pad16(Nt) / 16, PK = Pp / 16;
  const int ncol = owned_tiles(lw, RT);
  const int colt[2] = {lw, RT - 1 - lw};
  const int a_off = a_lane(lane, PL), b_offx = b_lane(lane, PL);
  const int bt_offx = bt_lane(lane, PL);
  const int b_offc = b_lane(lane, NL) + n0, bt_offc = bt_lane(lane, NL) + n0;
  const bf16* bm = Bm + bc0 + n0;      // B's columns of the tile; lo: + N
  const bool pairs = (N & 1) == 0;     // B's column pairs 4-byte aligned
  const bf16* dst_t = ds_s + n0 * PL;  // the tile's rows of dS

  float dB[2][8][4];                   // dB of the column tiles, all heads
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dB[q][j][0] = dB[q][j][1] = dB[q][j][2] = dB[q][j][3] = 0.f;

  for (int hi = 0; hi < tl.nh; ++hi) {
    bf16* xs = (hi & 1) ? buf1 : buf0;
    bf16* gs = xs + R * Qp * PL;
    const int h = tl.h0 + hi;
    if (hi + 1 < tl.nh) stage_xg(hi + 1, (hi & 1) ? buf0 : buf1);
    chunk_cumsum(dt_s, cum_s, dt, A, Tile{tl.b, tl.c, tl.g, h, 1}, s0,
                 n_valid, S, H, Qp);
    if (hi + 1 < tl.nh)
      cp_async_wait<1>();              // x, dy and dS of head hi
    else
      cp_async_wait<0>();
    __syncthreads();
    const float clast = cum_s[Qp - 1];

    // <s_prev, dS>, a warp's part (of the first 4 warps: the stride a
    // constant, so the loads of several elements are in flight at once)
    if (threadIdx.x < kTcThreads) {
      const bf16* sp = s_prev + 2 * (unit + hi) * NP;
      float acc = 0.f;
      for (int e = threadIdx.x; e < NP; e += kTcThreads) {
        const int n = e / P, p = e % P;
        acc = fmaf(__bfloat162float(sp[e]) + __bfloat162float(sp[NP + e]),
                   __bfloat162float(ds_s[n * PL + p])
                       + __bfloat162float(ds_s[(Np + n) * PL + p]),
                   acc);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) red_s[warp] = acc;
    }

    // x dS^T (V and the state part of dB) and B dS (that of d dtx)
    float dd[2][8][4], vv[2][2], cs[2][2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (q >= ncol) continue;
      const int J = colt[q];
      const int j0 = J * 16 + g8, j1 = j0 + 8;
      const float E0 = __expf(clast - cum_s[j0]), E1 = __expf(clast - cum_s[j1]);
      const float w0 = E0 * dt_s[j0], w1 = E1 * dt_s[j1];
      uint32_t bq[4][4];               // B's A fragments of the tile
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        if (ks < NK)
          a_frag_global(bq[ks], bm, bcld, J * 16, n_valid, Nt, ks, pairs);
      float tmp[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        tmp[j][0] = tmp[j][1] = tmp[j][2] = tmp[j][3] = 0.f;
        dd[q][j][0] = dd[q][j][1] = dd[q][j][2] = dd[q][j][3] = 0.f;
      }
      for (int ks = 0; ks < PK; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, smem_addr(xs + J * 16 * PL + a_off + ks * 16));
        mma_nt(tmp, a, smem_addr(dst_t + b_offx + ks * 16), 32 * PL, NT);
        mma_nt(tmp, a, smem_addr(dst_t + Np * PL + b_offx + ks * 16), 32 * PL,
               NT);
        if constexpr (F32) {           // x's lo plane times dS's hi
          ldsm_x4(a, smem_addr(xs + (Qp + J * 16) * PL + a_off + ks * 16));
          mma_nt(tmp, a, smem_addr(dst_t + b_offx + ks * 16), 32 * PL, NT);
        }
      }
      float v0 = 0.f, v1 = 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (ks >= NK) continue;
        uint32_t bl[4];                // B's lo plane (fp32 inputs)
        if constexpr (F32)
          a_frag_global(bl, bm + N, bcld, J * 16, n_valid, Nt, ks, pairs);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int j = 2 * ks + jj;
          float2 b0 = unpack2(bq[ks][jj ? 2 : 0]);
          float2 b1 = unpack2(bq[ks][jj ? 3 : 1]);
          if constexpr (F32) {
            b0 = add2(b0, unpack2(bl[jj ? 2 : 0]));
            b1 = add2(b1, unpack2(bl[jj ? 3 : 1]));
          }
          v0 = fmaf(b0.x, tmp[j][0], fmaf(b0.y, tmp[j][1], v0));
          v1 = fmaf(b1.x, tmp[j][2], fmaf(b1.y, tmp[j][3], v1));
          dB[q][j][0] = fmaf(w0, tmp[j][0], dB[q][j][0]);
          dB[q][j][1] = fmaf(w0, tmp[j][1], dB[q][j][1]);
          dB[q][j][2] = fmaf(w1, tmp[j][2], dB[q][j][2]);
          dB[q][j][3] = fmaf(w1, tmp[j][3], dB[q][j][3]);
        }
      }
      vv[q][0] = w0 * quad_sum(v0);
      vv[q][1] = w1 * quad_sum(v1);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (ks >= NK) continue;
        const bf16* dk = dst_t + ks * 16 * PL + bt_offx;
        mma_row(dd[q], bq[ks], smem_addr(dk), PT);
        mma_row(dd[q], bq[ks], smem_addr(dk + Np * PL), PT);
        if constexpr (F32) {           // B's lo plane times dS's hi
          uint32_t bl[4];
          a_frag_global(bl, bm + N, bcld, J * 16, n_valid, Nt, ks, pairs);
          mma_row(dd[q], bl, smem_addr(dk), PT);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        dd[q][j][0] *= E0;
        dd[q][j][1] *= E0;
        dd[q][j][2] *= E1;
        dd[q][j][3] *= E1;
      }
    }
    __syncthreads();                   // dS is read: the next head's
    if (hi + 1 < tl.nh) stage_ds(hi + 1);
    const float spd = red_s[0] + red_s[1] + red_s[2] + red_s[3];


    // the triangle, tile (J, I >= J) by tile, transposed
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (q >= ncol) continue;
      const int J = colt[q];
      const int j0 = J * 16 + g8, j1 = j0 + 8;
      const float cj0 = cum_s[j0], cj1 = cum_s[j1];
      const float dt0 = dt_s[j0], dt1 = dt_s[j1];
      uint32_t bq[4][4];
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        if (ks < NK)
          a_frag_global(bq[ks], bm, bcld, J * 16, n_valid, Nt, ks, pairs);
      float cs0 = 0.f, cs1 = 0.f;
      for (int I = J; I < RT; ++I) {
        float cbt[8], gdt[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) cbt[e] = gdt[e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (ks >= NK) continue;
          const bf16* ck = c_s + I * 16 * NL + b_offc + ks * 16;
          mma_16(cbt, bq[ks], smem_addr(ck));
          if constexpr (F32) {         // B hi C lo, B lo C hi
            uint32_t bl[4];
            a_frag_global(bl, bm + N, bcld, J * 16, n_valid, Nt, ks, pairs);
            mma_16(cbt, bq[ks], smem_addr(ck + Qp * NL));
            mma_16(cbt, bl, smem_addr(ck));
          }
        }
        for (int ks = 0; ks < PK; ++ks) {
          uint32_t a[4];
          const bf16* xa = xs + J * 16 * PL + a_off + ks * 16;
          const bf16* gk = gs + I * 16 * PL + b_offx + ks * 16;
          ldsm_x4(a, smem_addr(xa));
          mma_16(gdt, a, smem_addr(gk));
          if constexpr (F32) {         // x hi dy lo, x lo dy hi
            mma_16(gdt, a, smem_addr(gk + Qp * PL));
            ldsm_x4(a, smem_addr(xa + Qp * PL));
            mma_16(gdt, a, smem_addr(gk));
          }
        }
        // entries e: rows j0 (e = 0, 1, 4, 5) and j1, columns i0 + (e & 1)
        // + 8 (e / 4), i0 = 16 I + 2 t4
        float mt[8], lgt[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int j = (e & 2) ? j1 : j0;
          const int i = I * 16 + 2 * t4 + (e & 1) + 8 * (e / 4);
          const float L = i >= j ? __expf(cum_s[i] - ((e & 2) ? cj1 : cj0))
                                 : 0.f;
          const float gdv = gdt[e] * ((e & 2) ? dt1 : dt0);
          mt[e] = cbt[e] * L;
          if (e & 2) cs1 = fmaf(mt[e], gdv, cs1); else cs0 = fmaf(mt[e], gdv, cs0);
          lgt[e] = L * gdv;
        }
        uint32_t ah[4], al[4];
        const bf16* gt = gs + I * 16 * PL + bt_offx;
        split_tile(mt, ah, al);
        mma_split(dd[q], ah, al, smem_addr(gt), PT);
        if constexpr (F32) mma_row(dd[q], ah, smem_addr(gt + Qp * PL), PT);
        const bf16* ct = c_s + I * 16 * NL + bt_offc;
        split_tile(lgt, ah, al);
        mma_split(dB[q], ah, al, smem_addr(ct), NT);
        if constexpr (F32) mma_row(dB[q], ah, smem_addr(ct + Qp * NL), NT);
      }
      cs[q][0] = quad_sum(cs0);
      cs[q][1] = quad_sum(cs1);
      if constexpr (NW == 1)
        finish_cols<T, R>(dd[q], cs[q], vv[q], colt[q], g8, t4, xs, dt_s,
                          dx + (((int64_t)tl.b * S + s0) * H + h) * P,
                          (int64_t)H * P, n_valid, P, PT, Qp, PL, cs_s, v_s,
                          xd_s);
    }
    if constexpr (NW > 1) {
      // the second tile of N hands its parts of d dtx, W's column sums and
      // V to the first tile's warp of the same column tiles
      if (nt == 1) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (q >= ncol) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int j = colt[q] * 16 + g8 + 8 * half;
#pragma unroll
            for (int pt = 0; pt < 8; ++pt) {
              if (pt >= PT) continue;
              float* o = dd_x + j * Pp + pt * 8 + 2 * t4;
              o[0] = dd[q][pt][2 * half];
              o[1] = dd[q][pt][2 * half + 1];
            }
            if (t4 == 0) {
              cs_x[j] = cs[q][half];
              v_x[j] = vv[q][half];
            }
          }
        }
      }
      __syncthreads();
      if (nt == 0) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          if (q >= ncol) continue;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int j = colt[q] * 16 + g8 + 8 * half;
#pragma unroll
            for (int pt = 0; pt < 8; ++pt) {
              if (pt >= PT) continue;
              const float* o = dd_x + j * Pp + pt * 8 + 2 * t4;
              dd[q][pt][2 * half] += o[0];
              dd[q][pt][2 * half + 1] += o[1];
            }
            cs[q][half] += cs_x[j];
            vv[q][half] += v_x[j];
          }
          finish_cols<T, R>(dd[q], cs[q], vv[q], colt[q], g8, t4, xs,
                            dt_s, dx + (((int64_t)tl.b * S + s0) * H + h) * P,
                            (int64_t)H * P, n_valid, P, PT, Qp, PL, cs_s,
                            v_s, xd_s);
        }
      }
    }
    __syncthreads();

    // dcum_k = W's row sum + inter - W's column sum - V (+ the last
    // position's terms), da = its sum from k on, ddt and dA's part: a warp,
    // four positions a lane
    if (warp == 0) {
      const float* rs = rsi + (unit + hi) * NW * Qp;
      float dc[4], vsum = 0.f;
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const int k = 4 * lane + qq;
        float r = 0.f;
#pragma unroll
        for (int t = 0; t < NW; ++t) r += k < Qp ? rs[t * Qp + k] : 0.f;
        dc[qq] = k < Qp ? r - cs_s[k] - v_s[k] : 0.f;
        vsum += k < Qp ? v_s[k] : 0.f;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        vsum += __shfl_xor_sync(0xffffffffu, vsum, off);
#pragma unroll
      for (int qq = 0; qq < 4; ++qq)
        if (4 * lane + qq == Qp - 1) dc[qq] += __expf(clast) * spd + vsum;
      float v[4];
      v[3] = dc[3];
      v[2] = dc[2] + v[3];
      v[1] = dc[1] + v[2];
      v[0] = dc[0] + v[1];
      float incl = v[0];               // the sum over this lane and later
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float n = __shfl_down_sync(0xffffffffu, incl, off);
        if (lane + off < 32) incl += n;
      }
      const float later = incl - v[0];
      const float a = A[(int64_t)tl.b * H + h];
      float dA = 0.f;
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const int k = 4 * lane + qq;
        if (k >= Qp) continue;
        const float da = v[qq] + later;
        dA = fmaf(dt_s[k], da, dA);
        if (k < n_valid)
          ddt[((int64_t)tl.b * S + s0 + k) * H + h] = fmaf(a, da, xd_s[k]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dA += __shfl_xor_sync(0xffffffffu, dA, off);
      if (lane == 0) dA_part[unit + hi] = dA;
    }
    __syncthreads();                   // this head's buffers are refilled
  }
  const int64_t plane = (int64_t)G * tiles;
  const int ht = (tl.h0 - tl.g * rep) / heads;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (q >= ncol) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = colt[q] * 16 + g8 + 8 * half;
      if (j >= n_valid) continue;
      float* out = dB_part + (((int64_t)tl.b * S + s0 + j) * plane
                              + (int64_t)tl.g * tiles + ht) * N + n0;
#pragma unroll
      for (int j8 = 0; j8 < 8; ++j8) {
        const int n = j8 * 8 + 2 * t4;
        if (j8 >= NT) continue;
        if (n < Nt) out[n] = dB[q][j8][2 * half];
        if (n + 1 < Nt) out[n + 1] = dB[q][j8][2 * half + 1];
      }
    }
  }
}

// (d): dB, dC [B, S, G, N] = the sums over each group's `tiles` planes of
// dB_part, dC_part [B, S, G tiles, N] (a plane a tile of heads);
// dA [B * H] = the sum over the chunks
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce(const float* __restrict__ dB_part,
               const float* __restrict__ dC_part,
               const float* __restrict__ dA_part, T* __restrict__ dB,
               T* __restrict__ dC, float* __restrict__ dA, int64_t n_bc,
               int nc, int B, int H, int G, int N, int tiles) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n_bc;
       e += stride) {
    const int n = (int)(e % N);
    const int64_t bsg = e / N;           // (b, s) * G + g
    const int g = (int)(bsg % G);
    const int64_t src = ((bsg / G) * G * tiles + (int64_t)g * tiles) * N + n;
    float sb = 0.f, sc = 0.f;
    for (int r = 0; r < tiles; ++r) {
      sb += dB_part[src + (int64_t)r * N];
      sc += dC_part[src + (int64_t)r * N];
    }
    st(dB + e, sb);
    st(dC + e, sc);
  }
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       e < (int64_t)B * H; e += stride) {
    const int64_t b = e / H, h = e % H;
    float s = 0.f;
    for (int c = 0; c < nc; ++c) s += dA_part[(b * nc + c) * H + h];
    dA[e] = s;
  }
}

template <typename K>
int configure(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int grid_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return (int)(blocks < 1056 ? (blocks > 0 ? blocks : 1) : 1056);
}

// the most dynamic shared memory a launch of the chunk kernels takes
// with nw tiles of N and R planes of an input: at Q 128, or in fp32 past
// N 64 at Q 64 (the wrapper's chunk there; Q 128 would pass the card's)
constexpr int chunk_smem_cap(int nw, int R) {
  return tc_chunk_smem_bytes(R == 2 && nw == 2 ? kTileN : kMaxQ, nw * kTileN,
                             kMaxP, R);
}

// every kernel instance allowed that much dynamic shared memory (no
// more: the card sets its split of L1 and shared memory from it), once
int configure_all() {
  static const int configured =
      configure(ssd_state_kernel<true, false>,
                state_smem_bytes(kMaxQ, kMaxN, kMaxP, kMaxHeads))
      | configure(ssd_state_kernel<true, true>,
                  state_smem_bytes(kMaxQ, kTileN, kMaxP, kMaxHeads, 2))
      | configure(ssd_bwd_rows<bf16, 1>, chunk_smem_cap(1, 1))
      | configure(ssd_bwd_cols<bf16, 1>, chunk_smem_cap(1, 1))
      | configure(ssd_bwd_rows<bf16, 2>, chunk_smem_cap(2, 1))
      | configure(ssd_bwd_cols<bf16, 2>, chunk_smem_cap(2, 1))
      | configure(ssd_bwd_rows<float, 1>, chunk_smem_cap(1, 2))
      | configure(ssd_bwd_cols<float, 1>, chunk_smem_cap(1, 2))
      | configure(ssd_bwd_rows<float, 2>, chunk_smem_cap(2, 2))
      | configure(ssd_bwd_cols<float, 2>, chunk_smem_cap(2, 2));
  return configured;
}

int tc_blocks(int B, int S, int H, int G, int Q, int heads) {
  const int nc = (S + Q - 1) / Q, rep = H / G;
  return B * nc * G * ((rep + heads - 1) / heads);
}

int dstates(const void* dt, const void* A, const void* Cm, const void* dy,
            const void* dstate, void* ds, void* ds_loc, void* dec,
            void* dinit, int B, int S, int H, int G, int N, int P, int Q,
            int heads, int f32, cudaStream_t stream) {
  const int configured = configure_all();
  if (configured != 0) return configured;
  const int nc = (S + Q - 1) / Q, NP = N * P;
  const int blocks = tc_blocks(B, S, H, G, Q, heads);
  const int bytes = state_smem_bytes(Q, N, P, heads, f32 ? 2 : 1);
  auto kernel = f32 ? ssd_state_kernel<true, true>
                    : ssd_state_kernel<true, false>;
  kernel<<<blocks, kTcThreads, bytes, stream>>>(
      (const bf16*)dy, (const float*)dt, (const float*)A, (const bf16*)Cm,
      (float*)ds_loc, (float*)dec, S, H, G, N, P, Q, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_pass_split<<<B * H * ((NP + kThreads - 1) / kThreads), kThreads, 0,
                       stream>>>((const float*)ds_loc, (const float*)dec,
                                 (const float*)dstate, (bf16*)ds,
                                 (float*)dinit, nc, H, NP);
  return (int)cudaGetLastError();
}

// DBC, the type of dB and dC: T, or float for a bf16 launch whose dB and
// dC the wrapper sums over groups of state columns
template <typename T, int NW, typename DBC = T>
int chunks(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* dy, const void* s_prev,
           const void* ds, void* dx, void* ddt, void* dA, void* dB, void* dC,
           void* dB_part, void* dC_part, void* dA_part, void* rsi, int B,
           int S, int H, int G, int N, int P, int Q, int heads,
           cudaStream_t stream) {
  const int configured = configure_all();
  if (configured != 0) return configured;
  const int blocks = tc_blocks(B, S, H, G, Q, heads);
  const int threads = tc_threads(Q, N);
  const int bytes = tc_chunk_smem_bytes(Q, N, P, IsF32<T>::value ? 2 : 1);
  ssd_bwd_rows<T, NW><<<blocks, threads, bytes, stream>>>(
      (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)Bm,
      (const bf16*)Cm, (const bf16*)dy, (const bf16*)s_prev,
      (float*)dC_part, (float*)rsi, S, H, G, N, P, Q, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_cols<T, NW><<<blocks, threads, bytes, stream>>>(
      (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)Bm,
      (const bf16*)Cm, (const bf16*)dy, (const bf16*)s_prev,
      (const bf16*)ds, (const float*)rsi, (T*)dx, (float*)ddt,
      (float*)dB_part, (float*)dA_part, S, H, G, N, P, Q, heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rep = H / G;
  const int64_t n_bc = (int64_t)B * S * G * N;
  ssd_bwd_reduce<DBC><<<grid_for(n_bc > (int64_t)B * H ? n_bc
                                                         : (int64_t)B * H),
                        kThreads, 0, stream>>>(
      (const float*)dB_part, (const float*)dC_part, (const float*)dA_part,
      (DBC*)dB, (DBC*)dC, (float*)dA, n_bc, (S + Q - 1) / Q, B, H, G, N,
      (rep + heads - 1) / heads);
  return (int)cudaGetLastError();
}

bool valid(int B, int S, int H, int G, int N, int P, int Q, int heads,
           int f32) {
  return B >= 1 && S >= 1 && H >= 1 && G >= 1 && H % G == 0 && Q >= 1
         && Q <= kMaxQ && N >= 1 && N <= kMaxN && P >= 1 && P <= kMaxP
         && heads >= 1 && heads <= kMaxHeads
         && tc_chunk_smem_bytes(Q, N, P, f32 ? 2 : 1)
                <= chunk_smem_cap(n_tiles(N), f32 ? 2 : 1);
}

}  // namespace

extern "C" {

// fp32 [rows][W] as the kernels' split input, bf16 [rows][2][W]: hi, the
// rounding of each value, and lo, the rounding of the rest.  Returns a
// CUDA error code.
int mamba2_scan_bwd_split(const void* src, void* dst, int64_t rows, int W,
                          void* stream) {
  const int64_t n = rows * W;
  if (n == 0) return 0;
  ssd_bwd_split<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)src, (bf16*)dst, n, W);
  return (int)cudaGetLastError();
}

// The gradient of the state leaving each chunk, ds [B, chunks, H, 2, N, P]
// as bf16 hi and lo halves, and dinit [B, H, N, P] float32, from dt [B, S,
// H] and A [B * H] float32, Cm [B, S, G, N] and dy [B, S, H, P] in bf16
// (f32 != 0: fp32 split, [B, S, G, 2, N] and [B, S, H, 2, P]) and dstate
// (or null: zeros) [B, H, N, P] float32, with `heads` heads a block of
// kernel (a).  ds_loc [B, chunks, H, N, P] and dec [B, chunks, H] float32
// are scratch.  Kernels (a) and (b).  Returns a CUDA error code;
// cudaErrorInvalidValue outside 1 <= Q <= 128, 1 <= N <= 128, 1 <= P <=
// 64, 1 <= heads <= 16, for H not a multiple of G or for fp32 at Q past
// 64 with N past 64 (whose shared memory would pass the card's).
int mamba2_scan_bwd_dstates(const void* dt, const void* A, const void* Cm,
                            const void* dy, const void* dstate, void* ds,
                            void* ds_loc, void* dec, void* dinit, int B,
                            int S, int H, int G, int N, int P, int Q,
                            int heads, int f32, void* stream) {
  if (!valid(B, S, H, G, N, P, Q, heads, f32))
    return (int)cudaErrorInvalidValue;
  return dstates(dt, A, Cm, dy, dstate, ds, ds_loc, dec, dinit, B, S, H, G,
                 N, P, Q, heads, f32, (cudaStream_t)stream);
}

// The gradients dx [B, S, H, P] and dB, dC [B, S, G, N] (bfloat16, or
// float32 with f32 != 0), ddt [B, S, H] and dA [B * H] float32, from the
// forward's inputs (bf16, or fp32 split as above), dy, s_prev [B, chunks,
// H, 2, N, P] bf16 hi and lo and ds from mamba2_scan_bwd_dstates; scratch,
// float32: dB_part, dC_part [B, S, G tiles, N] (tiles = ceil(H / G /
// heads)), dA_part [B, chunks, H] and rsi [B, chunks, H, ceil(N / 64),
// pad16(Q)].  Kernels (c1), (c2) and (d).  With dbc_f32 != 0 a bfloat16
// launch writes dB and dC in float32 (the wrapper's parts of sums over
// groups of state columns).  Returns a CUDA error code, as above.
int mamba2_scan_bwd_chunks(const void* x, const void* dt, const void* A,
                           const void* Bm, const void* Cm, const void* dy,
                           const void* s_prev, const void* ds, void* dx,
                           void* ddt, void* dA, void* dB, void* dC,
                           void* dB_part, void* dC_part, void* dA_part,
                           void* rsi, int B, int S, int H, int G, int N,
                           int P, int Q, int heads, int f32, int dbc_f32,
                           void* stream) {
  if (!valid(B, S, H, G, N, P, Q, heads, f32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const bool two = n_tiles(N) > 1;
  auto run = f32 ? (two ? chunks<float, 2> : chunks<float, 1>)
             : dbc_f32 ? (two ? chunks<bf16, 2, float> : chunks<bf16, 1, float>)
                       : (two ? chunks<bf16, 2> : chunks<bf16, 1>);
  return run(x, dt, A, Bm, Cm, dy, s_prev, ds, dx, ddt, dA, dB, dC, dB_part,
             dC_part, dA_part, rsi, B, S, H, G, N, P, Q, heads, st);
}

// How many blocks of kernel (c2), the longest, an SM holds at once at
// these sizes in bfloat16 (f32 0) or float32, as the occupancy calculator
// reports it (what the wrapper's head planner reads).  Returns a CUDA
// error code.
int mamba2_scan_bwd_blocks_per_sm(int Q, int N, int P, int f32,
                                  int* blocks) {
  const int configured = configure_all();
  if (configured != 0) return configured;
  const int threads = tc_threads(Q, N);
  const int bytes = tc_chunk_smem_bytes(Q, N, P, f32 ? 2 : 1);
  const bool two = n_tiles(N) > 1;
  auto per_sm = [&](auto kernel) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, kernel, threads, bytes);
  };
  if (f32)
    return two ? per_sm(ssd_bwd_cols<float, 2>)
               : per_sm(ssd_bwd_cols<float, 1>);
  return two ? per_sm(ssd_bwd_cols<bf16, 2>) : per_sm(ssd_bwd_cols<bf16, 1>);
}

// The dynamic shared memory of a block of kernel (a) (which 0) or of the
// chunk kernels (which 1) at these sizes.
int mamba2_scan_bwd_smem_bytes(int Q, int N, int P, int heads, int f32,
                               int which) {
  const int R = f32 ? 2 : 1;
  return which ? tc_chunk_smem_bytes(Q, N, P, R)
               : state_smem_bytes(Q, N, P, heads, R);
}

// The threads of a block of the chunk kernels at these sizes.
int mamba2_scan_bwd_threads(int Q, int N) { return tc_threads(Q, N); }

}  // extern "C"
