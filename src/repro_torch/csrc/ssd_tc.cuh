// The bf16 tensor-core pieces of the chunked Mamba2 SSD scan shared by its
// forward (csrc/mamba2_scan.cu) and its backward (csrc/mamba2_scan_bwd.cu):
// staging by cp.async with zero padding to the mma tile, the tiles of heads
// a block takes, each head's dt and cumulative decay within a chunk, the
// bf16 hi + lo split of computed operands, ldmatrix lane offsets and the
// chunk-state kernel (the forward's pass (a), the backward's kernel (a)).
// An fp32 input reaches the backward's kernels split in two bf16 planes,
// hi (its rounding) and lo (the rounding of the rest), interleaved a row
// at a time: x [B, S, H, 2, P], B and C [B, S, G, 2, N].
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTcThreads = 128;        // 4 warps a block

__host__ __device__ constexpr int pad16(int n) { return (n + 15) / 16 * 16; }

// shared memory of passes (a) and (c): bf16 rows padded by 16 bytes so
// that ldmatrix meets no bank conflict
__host__ __device__ constexpr int state_smem_bytes(int Q, int N, int P,
                                                   int heads, int R = 1) {
  // B [R][Qp][Np + 8], x [2][R][Qp][Pp + 8] bf16 (R planes of an input:
  // 2 for a split fp32 one); dt, cum, weights [heads][Qp]
  return 2 * R * (pad16(Q) * (pad16(N) + 8) + 2 * pad16(Q) * (pad16(P) + 8))
         + 4 * 3 * heads * pad16(Q);
}
// rows x cols of a bf16 matrix (row stride ld) into shared memory (row
// stride dld) as rows_p x cols_p, zero past n_rows rows and cols columns:
// 16-byte cp.async where the rows allow it, else element copies
__device__ __forceinline__ void stage(bf16* dst, int dld, const bf16* src,
                                      int64_t ld, int n_rows, int rows_p,
                                      int cols, int cols_p) {
  if (cols % 8 == 0 && ld % 8 == 0 && ((uintptr_t)src & 15) == 0) {
    const int cpr = cols_p / 8;        // 16-byte pieces a row, <= 8
    const int per = blockDim.x / cpr;  // rows a pass of the block
    const int col = (threadIdx.x % cpr) * 8;
    if (threadIdx.x >= per * cpr) return;
    for (int r = threadIdx.x / cpr; r < rows_p; r += per) {
      const bool ok = r < n_rows && col < cols;
      cp_async16(smem_addr(dst + r * dld + col), src + (ok ? r * ld + col : 0),
                 ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows_p * cols_p; e += blockDim.x) {
      const int r = e / cols_p, col = e % cols_p;
      dst[r * dld + col] = (r < n_rows && col < cols) ? src[r * ld + col]
                                                      : __float2bfloat16(0.f);
    }
  }
}

// s_prev's hi and lo halves [2][N][P] into [2][Np][Pp + 8]
__device__ __forceinline__ void stage_state(bf16* dst, const bf16* src,
                                            int N, int P) {
  const int Np = pad16(N), Pp = pad16(P);
  stage(dst, Pp + 8, src, P, N, Np, P, Pp);
  stage(dst + Np * (Pp + 8), Pp + 8, src + N * P, P, N, Np, P, Pp);
}

// the block's (b, chunk, group) and its heads h0 .. h0 + nh - 1
struct Tile {
  int b, c, g, h0, nh;
};
__device__ __forceinline__ Tile tile_of(int idx, int nc, int G, int rep,
                                        int heads) {
  const int tiles = (rep + heads - 1) / heads;
  Tile t;
  const int ht = idx % tiles;
  idx /= tiles;
  t.g = idx % G;
  idx /= G;
  t.c = idx % nc;
  t.b = idx / nc;
  t.h0 = t.g * rep + ht * heads;
  t.nh = min(heads, rep - ht * heads);
  return t;
}

// dt_s[hi][j] = dt (0 past the chunk's n_valid rows) and cum_s[hi][j] its
// inclusive cumulative sum of dt * A within the chunk, for the block's
// heads: a warp a head, four positions a lane and a warp scan (Qp <= 128)
__device__ __forceinline__ void chunk_cumsum(float* dt_s, float* cum_s,
                                             const float* dt, const float* A,
                                             const Tile& tl, int s0,
                                             int n_valid, int S, int H,
                                             int Qp) {
  for (int e = threadIdx.x; e < tl.nh * Qp; e += blockDim.x) {
    const int j = e / tl.nh, hi = e % tl.nh;
    dt_s[hi * Qp + j] =
        j < n_valid ? dt[((int64_t)tl.b * S + s0 + j) * H + tl.h0 + hi] : 0.f;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int hi = warp; hi < tl.nh; hi += blockDim.x / 32) {
    const float a = A[tl.b * H + tl.h0 + hi];
    float v[4], run = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 4 * lane + q;
      run += j < Qp ? dt_s[hi * Qp + j] * a : 0.f;
      v[q] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += n;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 4 * lane + q;
      if (j < Qp) cum_s[hi * Qp + j] = v[q] + incl - run;
    }
  }
  __syncthreads();
}

// (a, b) as a pair of bf16 (hi) and the pair of bf16 remainders (lo): hi
// + lo carries 16 bits of each value, so two mma of bf16 operands keep
// the products to about 2^-17 of their size
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - f.x, b - f.y);
}

// a packed pair of bf16 times (s.x, s.y), split as split2 does
__device__ __forceinline__ void scale_split(uint32_t v, float2 s,
                                            uint32_t& hi, uint32_t& lo) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
  split2(f.x * s.x, f.y * s.y, hi, lo);
}
// the pair held as packed hi and lo planes (a split fp32 input), summed in
// fp32, times (s.x, s.y) and split again
__device__ __forceinline__ void scale_split(uint32_t v, uint32_t l, float2 s,
                                            uint32_t& hi, uint32_t& lo) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
  const float2 e = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&l));
  split2((f.x + e.x) * s.x, (f.y + e.y) * s.y, hi, lo);
}

// acc[j] (n-tiles j < PT <= 8) += a @ the [16][8 PT] bf16 tile at b (by
// ldmatrix.trans from this lane's address).  mma.sync is volatile asm,
// issued in program order: each call runs the n-tiles back to back, so no
// product waits on the one before it
__device__ __forceinline__ void mma_row(float (*acc)[4], const uint32_t* a,
                                        uint32_t b, int PT) {
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    if (j < PT) {
      uint32_t bx[4];
      ldsm_x4_t(bx, b + j * 16);
      mma_bf16(acc[j], a, bx[0], bx[1]);
      mma_bf16(acc[j + 1], a, bx[2], bx[3]);
    }
  }
}

// acc += (ah + al) @ the tile at b: the hi products of all n-tiles, then
// the lo ones
__device__ __forceinline__ void mma_split(float (*acc)[4], const uint32_t* ah,
                                          const uint32_t* al, uint32_t b,
                                          int PT) {
  uint32_t bx[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (2 * j < PT) ldsm_x4_t(bx[j], b + j * 32);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (2 * j < PT) {
        mma_bf16(acc[2 * j], h ? al : ah, bx[j][0], bx[j][1]);
        mma_bf16(acc[2 * j + 1], h ? al : ah, bx[j][2], bx[j][3]);
      }
    }
}

// ldmatrix lane offsets (in elements, rows of ld): an A fragment from a
// row-major [m][k] tile; an A fragment from a [k][m] tile by .trans; a B
// fragment pair (n-tiles j, j + 1) from an [n][k] tile; a B fragment pair
// from a [k][n] tile by .trans
__device__ __forceinline__ int a_lane(int lane, int ld) {
  return (lane % 16) * ld + (lane / 16) * 8;
}
__device__ __forceinline__ int at_lane(int lane, int ld) {
  return (lane % 8 + 8 * (lane / 16)) * ld + 8 * ((lane / 8) % 2);
}
__device__ __forceinline__ int b_lane(int lane, int ld) {
  return (lane % 8 + 8 * (lane / 16)) * ld + 8 * ((lane / 8) % 2);
}
__device__ __forceinline__ int bt_lane(int lane, int ld) {
  return (lane % 8 + 8 * ((lane / 8) % 2)) * ld + 8 * (lane / 16);
}

// x's R planes of head h (hi, then lo when R is 2) into dst [R][Qp][PL]
template <int R>
__device__ __forceinline__ void stage_planes(bf16* dst, int dld, int rows_p,
                                             const bf16* src, int64_t ld,
                                             int n_valid, int cols,
                                             int cols_p) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    stage(dst + r * rows_p * dld, dld, src + r * cols, ld, n_valid, rows_p,
          cols, cols_p);
}

// The forward's pass (a), GRAD false: S_loc[b, c, h] = sum_j B[j]^T
// exp(cum_last - cum[j]) dt[j] x[j].  The backward's kernel (a), GRAD true,
// with C in B's place and dy in x's: the chunk's own part of the gradient
// of the state entering it, sum_i C[i]^T exp(cum[i]) dy[i].  Both write
// dec[b, c, h] = exp(cum_last).  F32 (the backward's fp32 inputs, split):
// the scaled B^T is formed from hi + lo, and the lo plane of x adds the
// third product
template <bool GRAD, bool F32 = false>
__global__ void __launch_bounds__(kTcThreads)
ssd_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const bf16* __restrict__ Bm,
                 float* __restrict__ s_loc, float* __restrict__ dec, int S,
                 int H, int G, int N, int P, int Q, int heads) {
  constexpr int R = F32 ? 2 : 1;       // planes of an input
  const int Qp = pad16(Q), Np = pad16(N), Pp = pad16(P);
  const int NL = Np + 8, PL = Pp + 8;
  const int nc = (S + Q - 1) / Q;
  const Tile tl = tile_of(blockIdx.x, nc, G, H / G, heads);
  const int s0 = tl.c * Q, n_valid = min(Q, S - s0);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* b_s = reinterpret_cast<bf16*>(smem_raw);   // [R][Qp][NL]
  bf16* x_s = b_s + R * Qp * NL;                    // [2][R][Qp][PL]
  float* dt_s = reinterpret_cast<float*>(x_s + 2 * R * Qp * PL);
  float* cum_s = dt_s + heads * Qp;                 // [heads][Qp]
  float* w_s = cum_s + heads * Qp;                  // [heads][Qp]

  const int64_t xld = (int64_t)H * P * R;
  const bf16* xb = x + ((int64_t)tl.b * S + s0) * xld;
  stage_planes<R>(b_s, NL, Qp,
                  Bm + (((int64_t)tl.b * S + s0) * G + tl.g) * N * R,
                  (int64_t)G * N * R, n_valid, N, Np);
  stage_planes<R>(x_s, PL, Qp, xb + (int64_t)tl.h0 * P * R, xld, n_valid, P,
                  Pp);
  cp_async_commit();
  chunk_cumsum(dt_s, cum_s, dt, A, tl, s0, n_valid, S, H, Qp);
  for (int e = threadIdx.x; e < tl.nh * Qp; e += blockDim.x) {
    const int hi = e / Qp;
    w_s[e] = GRAD ? __expf(cum_s[e])
                  : __expf(cum_s[hi * Qp + Qp - 1] - cum_s[e]) * dt_s[e];
  }
  const int64_t unit = ((int64_t)tl.b * nc + tl.c) * H + tl.h0;
  if (threadIdx.x < tl.nh)
    dec[unit + threadIdx.x] = __expf(cum_s[threadIdx.x * Qp + Qp - 1]);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int PT = Pp / 8, KT = Qp / 16;
  const int x_off = bt_lane(lane, PL);

  for (int hi = 0; hi < tl.nh; ++hi) {
    const int st = hi & 1;
    if (hi + 1 < tl.nh) {
      stage_planes<R>(x_s + (st ^ 1) * R * Qp * PL, PL, Qp,
                      xb + (int64_t)(tl.h0 + hi + 1) * P * R, xld, n_valid,
                      P, Pp);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // warp w: state row tiles w, w + 4, ... (rows 16 w .. 16 w + 15, ...)
    for (int rt = warp; rt * 16 < Np; rt += 4) {
      const uint32_t b_addr = smem_addr(b_s + at_lane(lane, NL) + rt * 16);
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      const float* wh = w_s + hi * Qp;
      const bf16* xt = x_s + st * R * Qp * PL;
      for (int kt = 0; kt < KT; ++kt) {
        uint32_t a[4];
        ldsm_x4_t(a, b_addr + kt * 16 * NL * 2);
        const float2 w0 = *reinterpret_cast<const float2*>(wh + kt * 16 + 2 * t4);
        const float2 w1 =
            *reinterpret_cast<const float2*>(wh + kt * 16 + 8 + 2 * t4);
        uint32_t ah[4], al[4];
        if constexpr (F32) {
          uint32_t l[4];               // B's lo plane, the same entries
          ldsm_x4_t(l, b_addr + (Qp + kt * 16) * NL * 2);
          scale_split(a[0], l[0], w0, ah[0], al[0]);
          scale_split(a[1], l[1], w0, ah[1], al[1]);
          scale_split(a[2], l[2], w1, ah[2], al[2]);
          scale_split(a[3], l[3], w1, ah[3], al[3]);
        } else {
          scale_split(a[0], w0, ah[0], al[0]);
          scale_split(a[1], w0, ah[1], al[1]);
          scale_split(a[2], w1, ah[2], al[2]);
          scale_split(a[3], w1, ah[3], al[3]);
        }
        mma_split(acc, ah, al, smem_addr(xt + kt * 16 * PL + x_off), PT);
        if constexpr (F32)             // hi times x's lo plane
          mma_row(acc, ah, smem_addr(xt + (Qp + kt * 16) * PL + x_off), PT);
      }
      float* out = s_loc + (unit + hi) * N * P;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= PT) continue;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int n = rt * 16 + g + 8 * r, p = j * 8 + 2 * t4;
          if (n >= N || p >= P) continue;
          if (p + 1 < P && (P & 1) == 0) {
            *reinterpret_cast<float2*>(out + n * P + p) =
                make_float2(acc[j][2 * r], acc[j][2 * r + 1]);
          } else {
            out[n * P + p] = acc[j][2 * r];
            if (p + 1 < P) out[n * P + p + 1] = acc[j][2 * r + 1];
          }
        }
      }
    }
    __syncthreads();                   // x_s[st] is refilled next
  }
}

}  // namespace
