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
// dinit [B, H, N, P] fp32; s_prev, the state entering each chunk as the
// forward left it: [B, chunks, H, N, P] fp32 (the fp32 kernel's output)
// or [B, chunks, H, 2, N, P] bf16 hi and lo halves (the bf16 kernel's
// scratch); all contiguous.  A last chunk shorter than Q is padded with
// zeros, as in the forward.
//
// Bound: bytes.  At zamba2-2.7b's training shape (4 x 80 heads, S 2048,
// Q 128, N = P = 64, bf16) the inputs (x, dt, A, Bm, Cm, init, dy,
// dstate) and their gradients once are 277 MB, 0.083 ms at 3.35 TB/s
// (the saved states this design reads add 84 MB); the chunk products
// (g dtx^T, M^T g, LG B, LG^T C a head, 2 Q^2 64 flops each, and C B^T a
// group) and the state terms (4 x 2 Q N P a head) are 64.5 GFLOP, 0.065
// ms at the bf16 tensor-core peak.
//
// Design, bfloat16 (the type zamba2 trains in): five kernels of
// independent blocks on mma.sync.m16n8k16 (bf16 in, fp32 sums), no
// atomics, so two runs are bit-equal.  A block of kernels (a), (c1) and
// (c2) takes (b, chunk, a tile of `heads` heads of one group), planned as
// the forward plans its heads (the wrapper's plan_heads, from the blocks
// of (c2) an SM holds): dB and dC, which belong to the group, are summed
// over the block's heads before they leave, not written a head.  C B^T
// is formed again for each head, a 16 x 16 tile at a time (8 mma of the
// 32 (c1) or 48 (c2) a tile takes): holding it across heads, as the
// forward does, would cost (c1) and (c2) 72 more registers a thread, at
// 254 and 255 already, or 36 KB of shared memory and so their second
// block an SM.  mma.sync and not wgmma: each warp walks its own 16-row
// tiles of the triangle, which a 64-row warpgroup product would pad or
// cut.
//   (a) ssd_state_kernel<true> (csrc/ssd_tc.cuh, the forward's pass (a)
//       with C for B, dy for x and exp(cum) for its weights): each head's
//       sum_i exp(cum_i) C_i g_i^T [N, P] and the chunk's decay.
//   (b) ssd_bwd_pass_split: a thread per state element of each (b, h)
//       walks the chunks from the last in fp32 and writes the gradient of
//       the state leaving each chunk as bf16 hi and lo halves (what the
//       mma reads); dinit leaves here.  Reading and writing separate
//       arrays lets its loads run ahead of the chain: 0.07 ms at zamba2's
//       training shape, where the fp32 design's pass, in place, takes
//       0.42 (its 168 MB move in 0.05 at 3.35 TB/s).
//   (c1) ssd_bwd_rows, a block of 4 warps: warp w owns the row tiles w and
//       RT - 1 - w (the same share of the triangle for every warp, as the
//       forward's output pass).  Each head: g s_prev^T (the state part of
//       dC and the inter term), then, tile by tile on and below the
//       diagonal, C B^T and g x^T on the tensor cores, M = C B^T L, W's row
//       sums and LG = L (g . dtx) in registers, and dC += LG B.  dC of the
//       block's heads is summed in registers and leaves once a tile of
//       heads; W's row sums plus the inter term leave a head.
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
// product.  The triangle above the diagonal is skipped.  The state
// entering a chunk comes from the forward's scratch as hi and lo halves.
// Q, N and P are padded to multiples of 16 with zeros in shared memory.
// C (in c1) and B (in c2) enter the products as A operands loaded from
// global memory once a column tile, so shared memory holds B or C, two
// buffers of x and dy (the next head's staged by cp.async while the
// current one computes) and one of s_prev or dS, which is used first and
// refilled for the next head during the triangle: 113,168 bytes at Q 128,
// N = P = 64, two blocks an SM.  Scratch from the wrapper: the chunks'
// own state gradients [B, chunks, H, N, P] fp32, the state gradients at
// the chunks' ends [B, chunks, H, 2, N, P] bf16, the decays, W's row
// sums plus the inter term [B, chunks, H, Qp] fp32, dB and dC a tile of
// heads [B, S, G tiles, N] fp32 and dA a chunk.
//
// Design, float32 (the agreement checks, held to 1e-4, which rules out
// TF32): fp32 on the CUDA cores, four kernels of independent blocks:
//   (a) ssd_bwd_dstate_local: a block per (b, chunk, h) forms the chunk's
//       own part of ds_prev, sum_i exp(cum_i) C_i g_i^T [N, P], and its
//       decay exp(cum_{Q-1});
//   (b) ssd_bwd_pass: a thread per state element of each (b, h) walks
//       the chunks from the last, leaving dS (the gradient of the state
//       leaving each chunk) in place of (a)'s part; dinit leaves here;
//   (c) ssd_bwd_chunk: a block of 256 threads per (b, chunk, h) stages
//       the chunk (B, C, dtx, g, dS, later s_prev) in shared memory and
//       forms C B^T L, d dtx (dx, x . d dtx), L (g . dtx) with W's row and
//       column sums, dB, dC and dcum in register tiles (a thread 8 x 8
//       or 8 x 4 interleaved entries, as the fp32 forward does; the
//       entries and the 16-row blocks of the sums that lie above the
//       diagonal, where M and L are 0, are skipped at compile time), then
//       da, ddt and the chunk's part of dA; dB and dC per head go to
//       scratch;
//   (d) ssd_bwd_reduce, as above with a tile a head.
// It is held by the CUDA cores and shared memory: ~4.3 M FMA a block at
// one block an SM (224 KB of shared memory and 174 registers a thread at
// Q 128).  Run on bf16 inputs it took 8.32 ms at zamba2's training shape
// (NVIDIA H100 80GB HBM3 at 700 W); the design above takes 1.18 ms.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "ssd_tc.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 128;
constexpr int kMaxNP = 64;

__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// (a) shared memory: exp(cum) C [Q][N], g [Q][P], dt and cum [Q]
__host__ __device__ constexpr int local_floats(int Q, int N, int P) {
  return Q * N + Q * P + 2 * Q;
}
// (c) shared memory: B, C [Q][N + 1]; dtx, g [Q][P + 1]; dS, later
// s_prev [N][P + 1]; M [Q][Q + 1]; dt, cum, E, x . d dtx, W's row and
// column sums, the inter and state terms of dcum [8][Q]; column-sum
// partials [8 warps][Q]
__host__ __device__ constexpr int chunk_floats(int Q, int N, int P) {
  return 2 * Q * (N + 1) + 2 * Q * (P + 1) + N * (P + 1) + Q * (Q + 1)
         + 16 * Q;
}

// dt_s[i] = dt (0 past n_valid) and cum_s[i] its inclusive sum of dt * a
// over the chunk, in order
__device__ __forceinline__ void chunk_cum(float* dt_s, float* cum_s,
                                          const float* dt, int64_t off,
                                          int H, float a, int n_valid,
                                          int Q) {
  for (int i = threadIdx.x; i < Q; i += blockDim.x)
    dt_s[i] = i < n_valid ? dt[off + (int64_t)i * H] : 0.f;
  __syncthreads();
  if (threadIdx.x == 0) {
    float c = 0.f;
    for (int i = 0; i < Q; ++i) {
      c += dt_s[i] * a;
      cum_s[i] = c;
    }
  }
  __syncthreads();
}

// (a): dS_loc[u] = sum_i exp(cum_i) C_i g_i^T, dec[u] = exp(cum_{Q-1}),
// u = (b, chunk, h); thread tile rows n = t16 + 16 a (a < 4), columns
// p = l16 + 16 c (c < 4)
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dstate_local(const float* __restrict__ dt, const float* __restrict__ A,
                     const float* __restrict__ Cm, const float* __restrict__ dy,
                     float* __restrict__ ds, float* __restrict__ dec, int S,
                     int H, int G, int N, int P, int Q) {
  extern __shared__ float smem[];
  float* c_s = smem;                     // [Q][N]  exp(cum) C
  float* g_s = c_s + Q * N;              // [Q][P]
  float* dt_s = g_s + Q * P;             // [Q]
  float* cum_s = dt_s + Q;               // [Q]
  const int nc = (S + Q - 1) / Q;
  const int64_t u = blockIdx.x;
  const int h = (int)(u % H), c = (int)((u / H) % nc), b = (int)(u / H / nc);
  const int g = h / (H / G), s0 = c * Q, n_valid = min(Q, S - s0);
  const int tid = threadIdx.x, t16 = tid / 16, l16 = tid % 16;
  chunk_cum(dt_s, cum_s, dt, ((int64_t)b * S + s0) * H + h, H,
            A[(int64_t)b * H + h], n_valid, Q);
  for (int e = tid; e < Q * N; e += kThreads) {
    const int i = e / N, n = e % N;
    c_s[e] = i < n_valid
        ? Cm[(((int64_t)b * S + s0 + i) * G + g) * N + n] * expf(cum_s[i])
        : 0.f;
  }
  for (int e = tid; e < Q * P; e += kThreads) {
    const int i = e / P, p = e % P;
    g_s[e] = i < n_valid ? dy[(((int64_t)b * S + s0 + i) * H + h) * P + p]
                         : 0.f;
  }
  __syncthreads();
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int w = 0; w < 4; ++w) acc[a][w] = 0.f;
  for (int i = 0; i < Q; ++i) {
    float cv[4], gv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int n = t16 + 16 * a;
      cv[a] = n < N ? c_s[i * N + n] : 0.f;
    }
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int p = l16 + 16 * w;
      gv[w] = p < P ? g_s[i * P + p] : 0.f;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int w = 0; w < 4; ++w) acc[a][w] = fmaf(cv[a], gv[w], acc[a][w]);
  }
  float* out = ds + u * N * P;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int n = t16 + 16 * a;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const int p = l16 + 16 * w;
      if (n < N && p < P) out[n * P + p] = acc[a][w];
    }
  }
  if (tid == 0) dec[u] = expf(cum_s[Q - 1]);
}

// (b): for each (b, h) and state element, from the last chunk: the
// gradient of the state leaving chunk c replaces (a)'s part in ds, and
// the gradient of the state entering it becomes the next one's
__global__ void __launch_bounds__(kThreads)
ssd_bwd_pass(float* __restrict__ ds, const float* __restrict__ dec,
             const float* __restrict__ dstate, float* __restrict__ dinit,
             int nc, int H, int NP) {
  const int per = (NP + kThreads - 1) / kThreads;
  const int bh = blockIdx.x / per;
  const int e = (blockIdx.x % per) * kThreads + threadIdx.x;
  if (e >= NP) return;
  const int b = bh / H, h = bh % H;
  float cur = dstate ? dstate[(int64_t)bh * NP + e] : 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const int64_t u = ((int64_t)b * nc + c) * H + h;
    const float loc = ds[u * NP + e];
    ds[u * NP + e] = cur;
    cur = fmaf(dec[u], cur, loc);
  }
  dinit[(int64_t)bh * NP + e] = cur;
}

// the sum of v over the 16 lanes of a half warp (lanes 0-15, 16-31)
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// (c): the chunk's gradients, a block per (b, chunk, h)
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk(const float* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const float* __restrict__ Bm,
              const float* __restrict__ Cm, const float* __restrict__ dy,
              const float* __restrict__ s_prev, const float* __restrict__ ds,
              float* __restrict__ dx, float* __restrict__ ddt,
              float* __restrict__ dB_part, float* __restrict__ dC_part,
              float* __restrict__ dA_part, int S, int H, int G, int N, int P,
              int Q) {
  extern __shared__ float smem[];
  const int NL = N + 1, PL = P + 1, QL = Q + 1;
  float* b_s = smem;                     // [Q][NL]
  float* c_s = b_s + Q * NL;             // [Q][NL]
  float* x_s = c_s + Q * NL;             // [Q][PL]  dtx
  float* g_s = x_s + Q * PL;             // [Q][PL]  dy
  float* s_s = g_s + Q * PL;             // [N][PL]  dS, then s_prev
  float* m_s = s_s + N * PL;             // [Q][QL]
  float* dt_s = m_s + Q * QL;            // [Q]
  float* cum_s = dt_s + Q;
  float* e_s = cum_s + Q;                // exp(cum_{Q-1} - cum_j)
  float* xd_s = e_s + Q;                 // x_j . d dtx_j
  float* rs_s = xd_s + Q;                // sum_j W[i][j]
  float* cs_s = rs_s + Q;                // sum_i W[i][j]
  float* in_s = cs_s + Q;                // exp(cum_i) C_i . (s_prev g_i)
  float* v_s = in_s + Q;                 // V_j
  float* colp = v_s + Q;                 // [8][Q]

  const int nc = (S + Q - 1) / Q;
  const int64_t u = blockIdx.x;
  const int h = (int)(u % H), c = (int)((u / H) % nc), b = (int)(u / H / nc);
  const int g = h / (H / G), s0 = c * Q, n_valid = min(Q, S - s0);
  const int NP = N * P;
  const int tid = threadIdx.x, t16 = tid / 16, l16 = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const float a = A[(int64_t)b * H + h];
  const int64_t xrow = (int64_t)H * P;   // between positions in x, dy
  const float* xb = x + (((int64_t)b * S + s0) * H + h) * P;
  const float* gb = dy + (((int64_t)b * S + s0) * H + h) * P;
  const int64_t bc0 = (((int64_t)b * S + s0) * G + g) * N;

  chunk_cum(dt_s, cum_s, dt, ((int64_t)b * S + s0) * H + h, H, a, n_valid, Q);
  for (int e = tid; e < Q * N; e += kThreads) {
    const int i = e / N, n = e % N;
    const bool ok = i < n_valid;
    b_s[i * NL + n] = ok ? Bm[bc0 + (int64_t)i * G * N + n] : 0.f;
    c_s[i * NL + n] = ok ? Cm[bc0 + (int64_t)i * G * N + n] : 0.f;
  }
  for (int e = tid; e < Q * P; e += kThreads) {
    const int i = e / P, p = e % P;
    const bool ok = i < n_valid;
    x_s[i * PL + p] = ok ? dt_s[i] * xb[i * xrow + p] : 0.f;
    g_s[i * PL + p] = ok ? gb[i * xrow + p] : 0.f;
  }
  for (int e = tid; e < NP; e += kThreads)
    s_s[(e / P) * PL + e % P] = ds[u * NP + e];
  for (int i = tid; i < Q; i += kThreads)
    e_s[i] = expf(cum_s[Q - 1] - cum_s[i]);
  __syncthreads();

  // M[i][j] = (C_i . B_j) L[i][j] on and below the diagonal, else 0;
  // thread tile rows t16 + 16 r, columns l16 + 16 q
  {
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
    for (int n = 0; n < N; ++n) {
      float cv[8], bv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = t16 + 16 * r, j = l16 + 16 * r;
        cv[r] = i < Q ? c_s[i * NL + n] : 0.f;
        bv[r] = j < Q ? b_s[j * NL + n] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q <= r; ++q) acc[r][q] = fmaf(cv[r], bv[q], acc[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = t16 + 16 * r;
      if (i >= Q) continue;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = l16 + 16 * q;
        if (j < Q)
          m_s[i * QL + j] =
              q <= r && j <= i ? acc[r][q] * expf(cum_s[i] - cum_s[j]) : 0.f;
      }
    }
  }
  __syncthreads();

  // d dtx_j = sum_i M[i][j] g_i + E_j dS^T B_j; dx_j = dt_j d dtx_j and
  // x_j . d dtx_j; thread tile rows j = t16 + 16 r, columns l16 + 16 q
  {
    float acc[8][4], st_[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = st_[r][q] = 0.f;
    // M[i][j] = 0 for i < j: rows i of block ib reach the thread's rows
    // j = t16 + 16 r only for r <= ib
#pragma unroll
    for (int ib = 0; ib < 8; ++ib) {
      if (16 * ib >= Q) break;
      for (int i = 16 * ib; i < min(Q, 16 * ib + 16); ++i) {
        float mv[8], gv[4];
#pragma unroll
        for (int r = 0; r <= ib; ++r) {
          const int j = t16 + 16 * r;
          mv[r] = j < Q ? m_s[i * QL + j] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = l16 + 16 * q;
          gv[q] = p < P ? g_s[i * PL + p] : 0.f;
        }
#pragma unroll
        for (int r = 0; r <= ib; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[r][q] = fmaf(mv[r], gv[q], acc[r][q]);
      }
    }
    for (int n = 0; n < N; ++n) {
      float bv[8], sv[4];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int j = t16 + 16 * r;
        bv[r] = j < Q ? b_s[j * NL + n] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = l16 + 16 * q;
        sv[q] = p < P ? s_s[n * PL + p] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) st_[r][q] = fmaf(bv[r], sv[q], st_[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int j = t16 + 16 * r;
      const bool row_ok = j < n_valid;
      float xd = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = l16 + 16 * q;
        if (!row_ok || p >= P) continue;
        const float d = fmaf(e_s[j], st_[r][q], acc[r][q]);
        dx[(((int64_t)b * S + s0 + j) * H + h) * P + p] = dt_s[j] * d;
        xd = fmaf(xb[j * xrow + p], d, xd);
      }
      xd = half_warp_sum(xd);
      if (l16 == 0 && j < Q) xd_s[j] = xd;
    }
  }
  __syncthreads();                       // M is read: it becomes L (g . dtx)

  // W[i][j] = M[i][j] (g_i . dtx_j), its row and column sums, and
  // M[i][j] <- L[i][j] (g_i . dtx_j); thread tile as for M
  {
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
    for (int p = 0; p < P; ++p) {
      float gv[8], xv[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = t16 + 16 * r, j = l16 + 16 * r;
        gv[r] = i < Q ? g_s[i * PL + p] : 0.f;
        xv[r] = j < Q ? x_s[j * PL + p] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q <= r; ++q) acc[r][q] = fmaf(gv[r], xv[q], acc[r][q]);
    }
    float col[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) col[q] = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = t16 + 16 * r;
      float row_sum = 0.f;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = l16 + 16 * q;
        if (q <= r && i < Q && j < Q && j <= i) {
          const float wv = m_s[i * QL + j] * acc[r][q];
          row_sum += wv;
          col[q] += wv;
          m_s[i * QL + j] = expf(cum_s[i] - cum_s[j]) * acc[r][q];
        }
      }
      row_sum = half_warp_sum(row_sum);
      if (l16 == 0 && i < Q) rs_s[i] = row_sum;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float cv = col[q] + __shfl_xor_sync(0xffffffffu, col[q], 16);
      const int j = l16 + 16 * q;
      if (lane < 16 && j < Q) colp[warp * Q + j] = cv;
    }
  }
  __syncthreads();
  for (int j = tid; j < Q; j += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += colp[w * Q + j];
    cs_s[j] = s;
  }

  // dB_j = sum_i LG[i][j] C_i + E_j dS dtx_j and V_j = E_j B_j . (dS
  // dtx_j); thread tile rows j = t16 + 16 r, columns n = l16 + 16 q
  {
    float acc[8][4], sx[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = sx[r][q] = 0.f;
#pragma unroll
    for (int ib = 0; ib < 8; ++ib) {  // LG[i][j] = 0 for i < j, as above
      if (16 * ib >= Q) break;
      for (int i = 16 * ib; i < min(Q, 16 * ib + 16); ++i) {
        float mv[8], cv[4];
#pragma unroll
        for (int r = 0; r <= ib; ++r) {
          const int j = t16 + 16 * r;
          mv[r] = j < Q ? m_s[i * QL + j] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = l16 + 16 * q;
          cv[q] = n < N ? c_s[i * NL + n] : 0.f;
        }
#pragma unroll
        for (int r = 0; r <= ib; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[r][q] = fmaf(mv[r], cv[q], acc[r][q]);
      }
    }
    for (int p = 0; p < P; ++p) {
      float xv[8], sv[4];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int j = t16 + 16 * r;
        xv[r] = j < Q ? x_s[j * PL + p] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = l16 + 16 * q;
        sv[q] = n < N ? s_s[n * PL + p] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) sx[r][q] = fmaf(xv[r], sv[q], sx[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int j = t16 + 16 * r;
      float vj = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = l16 + 16 * q;
        if (j >= Q || n >= N) continue;
        vj = fmaf(b_s[j * NL + n], sx[r][q], vj);
        if (j < n_valid)
          dB_part[(((int64_t)b * S + s0 + j) * H + h) * N + n] =
              fmaf(e_s[j], sx[r][q], acc[r][q]);
      }
      vj = half_warp_sum(vj);
      if (l16 == 0 && j < Q) v_s[j] = e_s[j] * vj;
    }
  }
  __syncthreads();                       // dS is read: s_prev replaces it

  // <s_prev, dS>, then s_prev into s_s
  float spd = 0.f;
  for (int e = tid; e < NP; e += kThreads) {
    const float sp = s_prev[u * NP + e];
    float* slot = s_s + (e / P) * PL + e % P;
    spd = fmaf(sp, *slot, spd);
    *slot = sp;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    spd += __shfl_xor_sync(0xffffffffu, spd, off);
  if (lane == 0) colp[warp] = spd;
  __syncthreads();
  spd = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) spd += colp[w];

  // dC_i = sum_j LG[i][j] B_j + exp(cum_i) s_prev g_i and the inter term
  // exp(cum_i) C_i . (s_prev g_i); thread tile rows i = t16 + 16 r,
  // columns n = l16 + 16 q
  {
    float acc[8][4], sg[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = sg[r][q] = 0.f;
    // LG[i][j] = 0 for j > i: columns j of block jb reach the thread's
    // rows i = t16 + 16 r only for r >= jb
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      if (16 * jb >= Q) break;
      for (int j = 16 * jb; j < min(Q, 16 * jb + 16); ++j) {
        float mv[8], bv[4];
#pragma unroll
        for (int r = jb; r < 8; ++r) {
          const int i = t16 + 16 * r;
          mv[r] = i < Q ? m_s[i * QL + j] : 0.f;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = l16 + 16 * q;
          bv[q] = n < N ? b_s[j * NL + n] : 0.f;
        }
#pragma unroll
        for (int r = jb; r < 8; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            acc[r][q] = fmaf(mv[r], bv[q], acc[r][q]);
      }
    }
    for (int p = 0; p < P; ++p) {
      float gv[8], sv[4];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = t16 + 16 * r;
        gv[r] = i < Q ? g_s[i * PL + p] : 0.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = l16 + 16 * q;
        sv[q] = n < N ? s_s[n * PL + p] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) sg[r][q] = fmaf(gv[r], sv[q], sg[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = t16 + 16 * r;
      const float ei = i < Q ? expf(cum_s[i]) : 0.f;
      float inter = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = l16 + 16 * q;
        if (i >= Q || n >= N) continue;
        inter = fmaf(c_s[i * NL + n], sg[r][q], inter);
        if (i < n_valid)
          dC_part[(((int64_t)b * S + s0 + i) * H + h) * N + n] =
              fmaf(ei, sg[r][q], acc[r][q]);
      }
      inter = half_warp_sum(inter);
      if (l16 == 0 && i < Q) in_s[i] = ei * inter;
    }
  }
  __syncthreads();

  // dcum, then da_k = sum_{i >= k} dcum_i, ddt and the chunk's part of dA
  if (tid == 0) {
    float vsum = 0.f;
    for (int j = 0; j < Q; ++j) vsum += v_s[j];
    float da = 0.f, dA = 0.f;
    for (int k = Q - 1; k >= 0; --k) {
      float dcum = rs_s[k] - cs_s[k] + in_s[k] - v_s[k];
      if (k == Q - 1) dcum += expf(cum_s[Q - 1]) * spd + vsum;
      da += dcum;
      dA = fmaf(dt_s[k], da, dA);
      if (k < n_valid)
        ddt[((int64_t)b * S + s0 + k) * H + h] = fmaf(a, da, xd_s[k]);
    }
    dA_part[u] = dA;
  }
}

// ----------------------------------------- bf16: five kernels, tensor cores
constexpr int kMaxHeads = 16;          // heads a block of (a), (c1), (c2)

// (c1) and (c2) shared memory: B (c1) or C (c2) [Qp][Np + 8]; two buffers
// of x and dy [2][2][Qp][Pp + 8]; s_prev (c1) or dS (c2), hi and lo
// [2][Np][Pp + 8]; all bf16; dt, cum, W's column sums, V, x . d dtx [Qp]
// and a warp's part of <s_prev, dS> [4], fp32
__host__ __device__ constexpr int tc_chunk_smem_bytes(int Q, int N, int P) {
  return 2 * (pad16(Q) * (pad16(N) + 8) + 4 * pad16(Q) * (pad16(P) + 8)
              + 2 * pad16(N) * (pad16(P) + 8))
         + 4 * (5 * pad16(Q) + 4);
}

// (b), bf16: the gradient of the state leaving each chunk, from the last,
// as bf16 hi and lo halves ds [B, chunks, H, 2, N, P]; dinit in fp32
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

// the A fragment of rows r0 .. r0 + 15, columns 16 ks .. 16 ks + 15 of a
// row-major bf16 matrix in global memory (row stride ld, n_rows rows and
// cols columns that hold data, zero past them).  Its registers also hold
// the accumulator layout's entries of the n-tiles 2 ks (regs 0, 1) and
// 2 ks + 1 (regs 2, 3): rows g (regs 0, 2) and g + 8, columns 2t, 2t + 1
__device__ __forceinline__ void a_frag_global(uint32_t* a, const bf16* m,
                                              int64_t ld, int r0, int n_rows,
                                              int cols, int ks) {
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = r0 + g + 8 * (r & 1), col = ks * 16 + 2 * t4 + 8 * (r >> 1);
    const bf16* p = m + row * ld;
    const bf16 z = __float2bfloat16(0.f);
    if (row >= n_rows)
      a[r] = 0u;
    else if (col + 1 < cols && (cols & 1) == 0)
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

// (c1): dC of the block's heads [B, S, G tiles, N] and, a head, W's row
// sums plus exp(cum_i) C_i . (s_prev g_i) into rsi [B, chunks, H, Qp]
__global__ void __launch_bounds__(kTcThreads, 2)
ssd_bwd_rows(const bf16* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const bf16* __restrict__ Bm,
             const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
             const bf16* __restrict__ s_prev, float* __restrict__ dC_part,
             float* __restrict__ rsi, int S, int H, int G, int N, int P,
             int Q, int heads) {
  const int Qp = pad16(Q), Np = pad16(N), Pp = pad16(P);
  const int NL = Np + 8, PL = Pp + 8;
  const int nc = (S + Q - 1) / Q, rep = H / G;
  const int tiles = (rep + heads - 1) / heads;
  const Tile tl = tile_of(blockIdx.x, nc, G, rep, heads);
  const int s0 = tl.c * Q, n_valid = min(Q, S - s0);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* b_s = reinterpret_cast<bf16*>(smem_raw);   // [Qp][NL]
  bf16* buf0 = b_s + Qp * NL;                       // x, dy [Qp][PL] each
  bf16* buf1 = buf0 + 2 * Qp * PL;
  bf16* sp_s = buf1 + 2 * Qp * PL;                  // hi, lo [Np][PL]
  float* dt_s = reinterpret_cast<float*>(sp_s + 2 * Np * PL);
  float* cum_s = dt_s + Qp;

  const int64_t xld = (int64_t)H * P, bcld = (int64_t)G * N;
  const int64_t bc0 = (((int64_t)tl.b * S + s0) * G + tl.g) * N;
  const bf16* xb = x + ((int64_t)tl.b * S + s0) * xld;
  const bf16* gb = dy + ((int64_t)tl.b * S + s0) * xld;
  const int64_t unit = ((int64_t)tl.b * nc + tl.c) * H + tl.h0;
  auto stage_xg = [&](int hi, bf16* dst) {
    stage(dst, PL, xb + (int64_t)(tl.h0 + hi) * P, xld, n_valid, Qp, P, Pp);
    stage(dst + Qp * PL, PL, gb + (int64_t)(tl.h0 + hi) * P, xld, n_valid,
          Qp, P, Pp);
    cp_async_commit();
  };
  auto stage_sp = [&](int hi) {
    stage_state(sp_s, s_prev + 2 * (unit + hi) * N * P, N, P);
    cp_async_commit();
  };
  stage(b_s, NL, Bm + bc0, bcld, n_valid, Qp, N, Np);
  stage_xg(0, buf0);
  stage_sp(0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int RT = Qp / 16, PT = Pp / 8, NT = Np / 8, NK = Np / 16,
            PK = Pp / 16;
  const int nrow = owned_tiles(warp, RT);
  const int rowt[2] = {warp, RT - 1 - warp};
  const int a_off = a_lane(lane, PL), b_offx = b_lane(lane, PL);
  const int b_offb = b_lane(lane, NL), bt_offb = bt_lane(lane, NL);

  uint32_t cf[2][4][4];                // C's A fragments of the row tiles
  float dC[2][8][4];                   // dC of the row tiles, all heads
#pragma unroll
  for (int q = 0; q < 2; ++q) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      if (q < nrow && ks < NK)
        a_frag_global(cf[q][ks], Cm + bc0, bcld, rowt[q] * 16, n_valid, N,
                      ks);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dC[q][j][0] = dC[q][j][1] = dC[q][j][2] = dC[q][j][3] = 0.f;
  }

  for (int hi = 0; hi < tl.nh; ++hi) {
    bf16* xs = (hi & 1) ? buf1 : buf0;
    bf16* gs = xs + Qp * PL;
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
        mma_nt(tmp, a, smem_addr(sp_s + b_offx + ks * 16), 32 * PL, NT);
        mma_nt(tmp, a, smem_addr(sp_s + Np * PL + b_offx + ks * 16), 32 * PL,
               NT);
      }
      const int i0 = r * 16 + g8, i1 = i0 + 8;
      const float e0 = __expf(cum_s[i0]), e1 = __expf(cum_s[i1]);
      float c0s = 0.f, c1s = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= NT) continue;
        const float2 c0 = unpack2(cf[q][j / 2][(j & 1) ? 2 : 0]);
        const float2 c1 = unpack2(cf[q][j / 2][(j & 1) ? 3 : 1]);
        c0s = fmaf(c0.x, tmp[j][0], fmaf(c0.y, tmp[j][1], c0s));
        c1s = fmaf(c1.x, tmp[j][2], fmaf(c1.y, tmp[j][3], c1s));
        dC[q][j][0] = fmaf(e0, tmp[j][0], dC[q][j][0]);
        dC[q][j][1] = fmaf(e0, tmp[j][1], dC[q][j][1]);
        dC[q][j][2] = fmaf(e1, tmp[j][2], dC[q][j][2]);
        dC[q][j][3] = fmaf(e1, tmp[j][3], dC[q][j][3]);
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
          uint32_t bk[4];
          ldsm_x4(bk, smem_addr(b_s + kt * 16 * NL + b_offb + ks * 16));
          mma_bf16(cb, cf[q][ks], bk[0], bk[1]);
          mma_bf16(cb + 4, cf[q][ks], bk[2], bk[3]);
        }
        for (int ks = 0; ks < PK; ++ks) {
          uint32_t a[4], bk[4];
          ldsm_x4(a, smem_addr(gs + r * 16 * PL + a_off + ks * 16));
          ldsm_x4(bk, smem_addr(xs + kt * 16 * PL + b_offx + ks * 16));
          mma_bf16(gd, a, bk[0], bk[1]);
          mma_bf16(gd + 4, a, bk[2], bk[3]);
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
        mma_split(dC[q], ah, al, smem_addr(b_s + kt * 16 * NL + bt_offb), NT);
      }
      rs0 = quad_sum(rs0);
      rs1 = quad_sum(rs1);
      if (t4 == 0) {
        rsi[(unit + hi) * Qp + i0] = rs0 + inter[q][0];
        rsi[(unit + hi) * Qp + i1] = rs1 + inter[q][1];
      }
    }
    __syncthreads();                   // this head's buffers are refilled
  }
  // the block's dC: rows i0, i1 of each row tile, columns 8 j + 2 t4 (+ 1)
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
                              + (int64_t)tl.g * tiles + ht) * N;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = j * 8 + 2 * t4;
        if (j >= NT) continue;
        if (n < N) out[n] = dC[q][j][2 * half];
        if (n + 1 < N) out[n + 1] = dC[q][j][2 * half + 1];
      }
    }
  }
}

// (c2): dx, ddt and the chunk's part of dA a head, dB of the block's heads
// [B, S, G tiles, N]
__global__ void __launch_bounds__(kTcThreads, 2)
ssd_bwd_cols(const bf16* __restrict__ x, const float* __restrict__ dt,
             const float* __restrict__ A, const bf16* __restrict__ Bm,
             const bf16* __restrict__ Cm, const bf16* __restrict__ dy,
             const bf16* __restrict__ s_prev, const bf16* __restrict__ ds,
             const float* __restrict__ rsi, bf16* __restrict__ dx,
             float* __restrict__ ddt, float* __restrict__ dB_part,
             float* __restrict__ dA_part, int S, int H, int G, int N, int P,
             int Q, int heads) {
  const int Qp = pad16(Q), Np = pad16(N), Pp = pad16(P);
  const int NL = Np + 8, PL = Pp + 8;
  const int nc = (S + Q - 1) / Q, rep = H / G;
  const int tiles = (rep + heads - 1) / heads;
  const Tile tl = tile_of(blockIdx.x, nc, G, rep, heads);
  const int s0 = tl.c * Q, n_valid = min(Q, S - s0);
  const int NP = N * P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* c_s = reinterpret_cast<bf16*>(smem_raw);   // [Qp][NL]
  bf16* buf0 = c_s + Qp * NL;                       // x, dy [Qp][PL] each
  bf16* buf1 = buf0 + 2 * Qp * PL;
  bf16* ds_s = buf1 + 2 * Qp * PL;                  // hi, lo [Np][PL]
  float* dt_s = reinterpret_cast<float*>(ds_s + 2 * Np * PL);
  float* cum_s = dt_s + Qp;
  float* cs_s = cum_s + Qp;                         // W's column sums
  float* v_s = cs_s + Qp;                           // V
  float* xd_s = v_s + Qp;                           // x . d dtx
  float* red_s = xd_s + Qp;                         // [4]

  const int64_t xld = (int64_t)H * P, bcld = (int64_t)G * N;
  const int64_t bc0 = (((int64_t)tl.b * S + s0) * G + tl.g) * N;
  const bf16* xb = x + ((int64_t)tl.b * S + s0) * xld;
  const bf16* gb = dy + ((int64_t)tl.b * S + s0) * xld;
  const int64_t unit = ((int64_t)tl.b * nc + tl.c) * H + tl.h0;
  auto stage_xg = [&](int hi, bf16* dst) {
    stage(dst, PL, xb + (int64_t)(tl.h0 + hi) * P, xld, n_valid, Qp, P, Pp);
    stage(dst + Qp * PL, PL, gb + (int64_t)(tl.h0 + hi) * P, xld, n_valid,
          Qp, P, Pp);
    cp_async_commit();
  };
  auto stage_ds = [&](int hi) {
    stage_state(ds_s, ds + 2 * (unit + hi) * NP, N, P);
    cp_async_commit();
  };
  stage(c_s, NL, Cm + bc0, bcld, n_valid, Qp, N, Np);
  stage_xg(0, buf0);
  stage_ds(0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int RT = Qp / 16, PT = Pp / 8, NT = Np / 8, NK = Np / 16,
            PK = Pp / 16;
  const int ncol = owned_tiles(warp, RT);
  const int colt[2] = {warp, RT - 1 - warp};
  const int a_off = a_lane(lane, PL), b_offx = b_lane(lane, PL);
  const int bt_offx = bt_lane(lane, PL);
  const int b_offc = b_lane(lane, NL), bt_offc = bt_lane(lane, NL);

  float dB[2][8][4];                   // dB of the column tiles, all heads
#pragma unroll
  for (int q = 0; q < 2; ++q)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      dB[q][j][0] = dB[q][j][1] = dB[q][j][2] = dB[q][j][3] = 0.f;

  for (int hi = 0; hi < tl.nh; ++hi) {
    bf16* xs = (hi & 1) ? buf1 : buf0;
    bf16* gs = xs + Qp * PL;
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

    // <s_prev, dS>, a warp's part
    {
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
    float dd[2][8][4], vv[2][2];
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
        if (ks < NK) a_frag_global(bq[ks], Bm + bc0, bcld, J * 16, n_valid, N, ks);
      float tmp[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        tmp[j][0] = tmp[j][1] = tmp[j][2] = tmp[j][3] = 0.f;
        dd[q][j][0] = dd[q][j][1] = dd[q][j][2] = dd[q][j][3] = 0.f;
      }
      for (int ks = 0; ks < PK; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, smem_addr(xs + J * 16 * PL + a_off + ks * 16));
        mma_nt(tmp, a, smem_addr(ds_s + b_offx + ks * 16), 32 * PL, NT);
        mma_nt(tmp, a, smem_addr(ds_s + Np * PL + b_offx + ks * 16), 32 * PL,
               NT);
      }
      float v0 = 0.f, v1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j >= NT) continue;
        const float2 b0 = unpack2(bq[j / 2][(j & 1) ? 2 : 0]);
        const float2 b1 = unpack2(bq[j / 2][(j & 1) ? 3 : 1]);
        v0 = fmaf(b0.x, tmp[j][0], fmaf(b0.y, tmp[j][1], v0));
        v1 = fmaf(b1.x, tmp[j][2], fmaf(b1.y, tmp[j][3], v1));
        dB[q][j][0] = fmaf(w0, tmp[j][0], dB[q][j][0]);
        dB[q][j][1] = fmaf(w0, tmp[j][1], dB[q][j][1]);
        dB[q][j][2] = fmaf(w1, tmp[j][2], dB[q][j][2]);
        dB[q][j][3] = fmaf(w1, tmp[j][3], dB[q][j][3]);
      }
      vv[q][0] = w0 * quad_sum(v0);
      vv[q][1] = w1 * quad_sum(v1);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (ks >= NK) continue;
        mma_row(dd[q], bq[ks], smem_addr(ds_s + ks * 16 * PL + bt_offx), PT);
        mma_row(dd[q], bq[ks], smem_addr(ds_s + (Np + ks * 16) * PL + bt_offx),
                PT);
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
        if (ks < NK) a_frag_global(bq[ks], Bm + bc0, bcld, J * 16, n_valid, N, ks);
      float cs0 = 0.f, cs1 = 0.f;
      for (int I = J; I < RT; ++I) {
        float cbt[8], gdt[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) cbt[e] = gdt[e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if (ks >= NK) continue;
          uint32_t bk[4];
          ldsm_x4(bk, smem_addr(c_s + I * 16 * NL + b_offc + ks * 16));
          mma_bf16(cbt, bq[ks], bk[0], bk[1]);
          mma_bf16(cbt + 4, bq[ks], bk[2], bk[3]);
        }
        for (int ks = 0; ks < PK; ++ks) {
          uint32_t a[4], bk[4];
          ldsm_x4(a, smem_addr(xs + J * 16 * PL + a_off + ks * 16));
          ldsm_x4(bk, smem_addr(gs + I * 16 * PL + b_offx + ks * 16));
          mma_bf16(gdt, a, bk[0], bk[1]);
          mma_bf16(gdt + 4, a, bk[2], bk[3]);
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
        split_tile(mt, ah, al);
        mma_split(dd[q], ah, al, smem_addr(gs + I * 16 * PL + bt_offx), PT);
        split_tile(lgt, ah, al);
        mma_split(dB[q], ah, al, smem_addr(c_s + I * 16 * NL + bt_offc), NT);
      }
      // the column tile is done for this head: dx, x . d dtx, W's column
      // sums and V, rows j0 and j1
      float xd0 = 0.f, xd1 = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = half ? j1 : j0;
        const float dtj = half ? dt1 : dt0;
        const bool row_ok = j < n_valid;
        bf16* dxr = dx + ((int64_t)tl.b * S + s0 + j) * xld + (int64_t)h * P;
        float xd = 0.f;
#pragma unroll
        for (int pt = 0; pt < 8; ++pt) {
          const int p = pt * 8 + 2 * t4;
          if (pt >= PT) continue;
          const float d0 = dd[q][pt][2 * half], d1 = dd[q][pt][2 * half + 1];
          const float2 xv = unpack2(*reinterpret_cast<const uint32_t*>(
              xs + j * PL + p));
          xd = fmaf(xv.x, d0, fmaf(xv.y, d1, xd));
          if (!row_ok) continue;
          if (p + 1 < P && (P & 1) == 0) {
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
      cs0 = quad_sum(cs0);
      cs1 = quad_sum(cs1);
      if (t4 == 0) {
        cs_s[j0] = cs0;
        cs_s[j1] = cs1;
        v_s[j0] = vv[q][0];
        v_s[j1] = vv[q][1];
        xd_s[j0] = xd0;
        xd_s[j1] = xd1;
      }
    }
    __syncthreads();

    // dcum_k = W's row sum + inter - W's column sum - V (+ the last
    // position's terms), da = its sum from k on, ddt and dA's part: a warp,
    // four positions a lane
    if (warp == 0) {
      const float* rs = rsi + (unit + hi) * Qp;
      float dc[4], vsum = 0.f;
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const int k = 4 * lane + qq;
        dc[qq] = k < Qp ? rs[k] - cs_s[k] - v_s[k] : 0.f;
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
                              + (int64_t)tl.g * tiles + ht) * N;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = nt * 8 + 2 * t4;
        if (nt >= NT) continue;
        if (n < N) out[n] = dB[q][nt][2 * half];
        if (n + 1 < N) out[n + 1] = dB[q][nt][2 * half + 1];
      }
    }
  }
}

// (d): dB, dC [B, S, G, N] = the sums over each group's `tiles` planes of
// dB_part, dC_part [B, S, G tiles, N] (a plane a tile of heads; a head in
// fp32); dA [B * H] = the sum over the chunks
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

int configure_bf16() {
  static const int configured =
      configure(ssd_state_kernel<true>,
                state_smem_bytes(kMaxQ, kMaxNP, kMaxNP, kMaxHeads))
      | configure(ssd_bwd_rows, tc_chunk_smem_bytes(kMaxQ, kMaxNP, kMaxNP))
      | configure(ssd_bwd_cols, tc_chunk_smem_bytes(kMaxQ, kMaxNP, kMaxNP));
  return configured;
}

int tc_blocks(int B, int S, int H, int G, int Q, int heads) {
  const int nc = (S + Q - 1) / Q, rep = H / G;
  return B * nc * G * ((rep + heads - 1) / heads);
}

int dstates_f32(const void* dt, const void* A, const void* Cm,
                const void* dy, const void* dstate, void* ds, void* dec,
                void* dinit, int B, int S, int H, int G, int N, int P,
                int Q, cudaStream_t stream) {
  static const int configured =
      configure(ssd_bwd_dstate_local,
                4 * local_floats(kMaxQ, kMaxNP, kMaxNP));
  if (configured != 0) return configured;
  const int nc = (S + Q - 1) / Q, NP = N * P;
  ssd_bwd_dstate_local<<<B * nc * H, kThreads, 4 * local_floats(Q, N, P),
                         stream>>>(
      (const float*)dt, (const float*)A, (const float*)Cm, (const float*)dy,
      (float*)ds, (float*)dec, S, H, G, N, P, Q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_pass<<<B * H * ((NP + kThreads - 1) / kThreads), kThreads, 0,
                 stream>>>((float*)ds, (const float*)dec,
                           (const float*)dstate, (float*)dinit, nc, H, NP);
  return (int)cudaGetLastError();
}

int dstates_bf16(const void* dt, const void* A, const void* Cm,
                 const void* dy, const void* dstate, void* ds, void* ds_loc,
                 void* dec, void* dinit, int B, int S, int H, int G, int N,
                 int P, int Q, int heads, cudaStream_t stream) {
  const int configured = configure_bf16();
  if (configured != 0) return configured;
  const int nc = (S + Q - 1) / Q, NP = N * P;
  ssd_state_kernel<true><<<tc_blocks(B, S, H, G, Q, heads), kTcThreads,
                           state_smem_bytes(Q, N, P, heads), stream>>>(
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

template <typename T>
int reduce(const void* dB_part, const void* dC_part, const void* dA_part,
           void* dB, void* dC, void* dA, int B, int S, int H, int G, int N,
           int Q, int tiles, cudaStream_t stream) {
  const int64_t n_bc = (int64_t)B * S * G * N;
  ssd_bwd_reduce<T><<<grid_for(n_bc > (int64_t)B * H ? n_bc : (int64_t)B * H),
                      kThreads, 0, stream>>>(
      (const float*)dB_part, (const float*)dC_part, (const float*)dA_part,
      (T*)dB, (T*)dC, (float*)dA, n_bc, (S + Q - 1) / Q, B, H, G, N, tiles);
  return (int)cudaGetLastError();
}

int chunks_f32(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, const void* dy, const void* s_prev,
               const void* ds, void* dx, void* ddt, void* dA, void* dB,
               void* dC, void* dB_part, void* dC_part, void* dA_part, int B,
               int S, int H, int G, int N, int P, int Q,
               cudaStream_t stream) {
  static const int configured = configure(
      ssd_bwd_chunk, 4 * chunk_floats(kMaxQ, kMaxNP, kMaxNP));
  if (configured != 0) return configured;
  const int nc = (S + Q - 1) / Q;
  ssd_bwd_chunk<<<B * nc * H, kThreads, 4 * chunk_floats(Q, N, P),
                  stream>>>(
      (const float*)x, (const float*)dt, (const float*)A, (const float*)Bm,
      (const float*)Cm, (const float*)dy, (const float*)s_prev,
      (const float*)ds, (float*)dx, (float*)ddt, (float*)dB_part,
      (float*)dC_part, (float*)dA_part, S, H, G, N, P, Q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return reduce<float>(dB_part, dC_part, dA_part, dB, dC, dA, B, S, H, G, N,
                       Q, H / G, stream);
}

int chunks_bf16(const void* x, const void* dt, const void* A, const void* Bm,
                const void* Cm, const void* dy, const void* s_prev,
                const void* ds, void* dx, void* ddt, void* dA, void* dB,
                void* dC, void* dB_part, void* dC_part, void* dA_part,
                void* rsi, int B, int S, int H, int G, int N, int P, int Q,
                int heads, cudaStream_t stream) {
  const int configured = configure_bf16();
  if (configured != 0) return configured;
  const int blocks = tc_blocks(B, S, H, G, Q, heads);
  const int bytes = tc_chunk_smem_bytes(Q, N, P);
  ssd_bwd_rows<<<blocks, kTcThreads, bytes, stream>>>(
      (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)Bm,
      (const bf16*)Cm, (const bf16*)dy, (const bf16*)s_prev,
      (float*)dC_part, (float*)rsi, S, H, G, N, P, Q, heads);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_cols<<<blocks, kTcThreads, bytes, stream>>>(
      (const bf16*)x, (const float*)dt, (const float*)A, (const bf16*)Bm,
      (const bf16*)Cm, (const bf16*)dy, (const bf16*)s_prev,
      (const bf16*)ds, (const float*)rsi, (bf16*)dx, (float*)ddt,
      (float*)dB_part, (float*)dA_part, S, H, G, N, P, Q, heads);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rep = H / G;
  return reduce<bf16>(dB_part, dC_part, dA_part, dB, dC, dA, B, S, H, G, N,
                      Q, (rep + heads - 1) / heads, stream);
}

bool valid(int B, int S, int H, int G, int N, int P, int Q, int heads,
           int bf16) {
  return B >= 1 && S >= 1 && H >= 1 && G >= 1 && H % G == 0 && Q >= 1
         && Q <= kMaxQ && N >= 1 && N <= kMaxNP && P >= 1 && P <= kMaxNP
         && (!bf16 || (heads >= 1 && heads <= kMaxHeads));
}

}  // namespace

extern "C" {

// The gradient of the state leaving each chunk, ds, and dinit [B, H, N,
// P] float32, from dt [B, S, H] and A [B * H] float32, Cm [B, S, G, N]
// and dy [B, S, H, P] in one type (bf16 != 0: bfloat16, else float32)
// and dstate (or null: zeros) [B, H, N, P] float32.  float32: ds [B,
// chunks, H, N, P] float32 (ds_loc is not read); bfloat16: ds [B, chunks,
// H, 2, N, P] as hi and lo halves, from the scratch ds_loc [B, chunks, H,
// N, P] float32, with `heads` heads a block of kernel (a).  dec [B,
// chunks, H] float32 is scratch.  Kernels (a) and (b).  Returns a CUDA
// error code; cudaErrorInvalidValue outside 1 <= Q <= 128, 1 <= N, P <=
// 64, for H not a multiple of G or, in bfloat16, heads outside 1 .. 16.
int mamba2_scan_bwd_dstates(const void* dt, const void* A, const void* Cm,
                            const void* dy, const void* dstate, void* ds,
                            void* ds_loc, void* dec, void* dinit, int B,
                            int S, int H, int G, int N, int P, int Q,
                            int heads, int bf16, void* stream) {
  if (!valid(B, S, H, G, N, P, Q, heads, bf16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return dstates_bf16(dt, A, Cm, dy, dstate, ds, ds_loc, dec, dinit, B, S,
                        H, G, N, P, Q, heads, st);
  return dstates_f32(dt, A, Cm, dy, dstate, ds, dec, dinit, B, S, H, G, N,
                     P, Q, st);
}

// The gradients dx [B, S, H, P] and dB, dC [B, S, G, N] in x's type,
// ddt [B, S, H] and dA [B * H] float32, from the forward's inputs, dy,
// s_prev (float32 [B, chunks, H, N, P], or for bfloat16 the hi and lo
// halves [B, chunks, H, 2, N, P]) and ds from mamba2_scan_bwd_dstates;
// scratch, float32: dB_part, dC_part [B, S, G tiles, N] (tiles = H / G
// in float32, ceil(H / G / heads) in bfloat16), dA_part [B, chunks, H]
// and, bfloat16 only, rsi [B, chunks, H, pad16(Q)].  Kernels (c) and (d)
// (bfloat16: (c1), (c2) and (d)).  Returns a CUDA error code, as above.
int mamba2_scan_bwd_chunks(const void* x, const void* dt, const void* A,
                           const void* Bm, const void* Cm, const void* dy,
                           const void* s_prev, const void* ds, void* dx,
                           void* ddt, void* dA, void* dB, void* dC,
                           void* dB_part, void* dC_part, void* dA_part,
                           void* rsi, int B, int S, int H, int G, int N,
                           int P, int Q, int heads, int bf16, void* stream) {
  if (!valid(B, S, H, G, N, P, Q, heads, bf16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return chunks_bf16(x, dt, A, Bm, Cm, dy, s_prev, ds, dx, ddt, dA, dB, dC,
                       dB_part, dC_part, dA_part, rsi, B, S, H, G, N, P, Q,
                       heads, st);
  return chunks_f32(x, dt, A, Bm, Cm, dy, s_prev, ds, dx, ddt, dA, dB, dC,
                    dB_part, dC_part, dA_part, B, S, H, G, N, P, Q, st);
}

// How many blocks of kernel (c2), the bfloat16 design's longest, an SM
// holds at once at these sizes, as the occupancy calculator reports it
// (what the wrapper's head planner reads).  Returns a CUDA error code.
int mamba2_scan_bwd_blocks_per_sm(int Q, int N, int P, int* blocks) {
  const int configured = configure_bf16();
  if (configured != 0) return configured;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, ssd_bwd_cols, kTcThreads, tc_chunk_smem_bytes(Q, N, P));
}

// The dynamic shared memory of a block of kernel (a) (which 0) or of the
// chunk kernels (which 1: (c); (c1) and (c2) in bfloat16) at these sizes.
int mamba2_scan_bwd_smem_bytes(int Q, int N, int P, int heads, int bf16,
                               int which) {
  if (bf16)
    return which ? tc_chunk_smem_bytes(Q, N, P)
                 : state_smem_bytes(Q, N, P, heads);
  return 4 * (which ? chunk_floats(Q, N, P) : local_floats(Q, N, P));
}

}  // extern "C"
