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
// Design, a first one that is right: fp32 on the CUDA cores for both
// types (bf16 operands are widened on load, and s_prev's halves added),
// four kernels of independent blocks, no atomics, so two runs are
// bit-equal:
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
//   (d) ssd_bwd_reduce: dB, dC as the sums over each group's heads and dA
//       over the chunks, in order, in the inputs' type.
// What holds it is the CUDA cores and shared memory: ~4.3 M FMA a block
// at one block an SM (224 KB of shared memory and 174 registers a thread
// at Q 128).  Skipping the triangle cut 6.5 M FMA a block to 4.3 M and
// the backward at zamba2's training shape from 10.52 to 8.28 ms
// (chip_smoke.py's timed row, NVIDIA H100 80GB HBM3 at 700 W).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kMaxQ = 128;
constexpr int kMaxNP = 64;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(bf16* p, float x) {
  *p = __float2bfloat16(x);
}
// the state entering a chunk, element e of [N, P]: fp32, or the sum of
// the bf16 hi and lo halves ([2][N][P])
__device__ __forceinline__ float state_at(const float* s, int64_t u, int NP,
                                          int e) {
  return s[u * NP + e];
}
__device__ __forceinline__ float state_at(const bf16* s, int64_t u, int NP,
                                          int e) {
  return __bfloat162float(s[2 * u * NP + e])
         + __bfloat162float(s[(2 * u + 1) * NP + e]);
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
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dstate_local(const float* __restrict__ dt, const float* __restrict__ A,
                     const T* __restrict__ Cm, const T* __restrict__ dy,
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
        ? ld(Cm + (((int64_t)b * S + s0 + i) * G + g) * N + n) * expf(cum_s[i])
        : 0.f;
  }
  for (int e = tid; e < Q * P; e += kThreads) {
    const int i = e / P, p = e % P;
    g_s[e] = i < n_valid ? ld(dy + (((int64_t)b * S + s0 + i) * H + h) * P + p)
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
template <typename T, typename SP>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk(const T* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const T* __restrict__ Bm,
              const T* __restrict__ Cm, const T* __restrict__ dy,
              const SP* __restrict__ s_prev, const float* __restrict__ ds,
              T* __restrict__ dx, float* __restrict__ ddt,
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
  const T* xb = x + (((int64_t)b * S + s0) * H + h) * P;
  const T* gb = dy + (((int64_t)b * S + s0) * H + h) * P;
  const int64_t bc0 = (((int64_t)b * S + s0) * G + g) * N;

  chunk_cum(dt_s, cum_s, dt, ((int64_t)b * S + s0) * H + h, H, a, n_valid, Q);
  for (int e = tid; e < Q * N; e += kThreads) {
    const int i = e / N, n = e % N;
    const bool ok = i < n_valid;
    b_s[i * NL + n] = ok ? ld(Bm + bc0 + (int64_t)i * G * N + n) : 0.f;
    c_s[i * NL + n] = ok ? ld(Cm + bc0 + (int64_t)i * G * N + n) : 0.f;
  }
  for (int e = tid; e < Q * P; e += kThreads) {
    const int i = e / P, p = e % P;
    const bool ok = i < n_valid;
    x_s[i * PL + p] = ok ? dt_s[i] * ld(xb + i * xrow + p) : 0.f;
    g_s[i * PL + p] = ok ? ld(gb + i * xrow + p) : 0.f;
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
        st(dx + (((int64_t)b * S + s0 + j) * H + h) * P + p, dt_s[j] * d);
        xd = fmaf(ld(xb + j * xrow + p), d, xd);
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
    const float sp = state_at(s_prev, u, NP, e);
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

// (d): dB, dC [B, S, G, N] = the sums over each group's heads; dA [B * H]
// = the sum over the chunks
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce(const float* __restrict__ dB_part,
               const float* __restrict__ dC_part,
               const float* __restrict__ dA_part, T* __restrict__ dB,
               T* __restrict__ dC, float* __restrict__ dA, int64_t n_bc,
               int nc, int B, int H, int G, int N) {
  const int rep = H / G;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n_bc;
       e += stride) {
    const int n = (int)(e % N);
    const int64_t bsg = e / N;           // (b, s) * G + g
    const int g = (int)(bsg % G);
    const int64_t src = ((bsg / G) * H + (int64_t)g * rep) * N + n;
    float sb = 0.f, sc = 0.f;
    for (int r = 0; r < rep; ++r) {
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

template <typename T>
int dstates(const void* dt, const void* A, const void* Cm, const void* dy,
            const void* dstate, void* ds, void* dec, void* dinit, int B,
            int S, int H, int G, int N, int P, int Q, cudaStream_t stream) {
  static const int configured =
      configure(ssd_bwd_dstate_local<T>,
                4 * local_floats(kMaxQ, kMaxNP, kMaxNP));
  if (configured != 0) return configured;
  const int nc = (S + Q - 1) / Q, NP = N * P;
  ssd_bwd_dstate_local<T><<<B * nc * H, kThreads, 4 * local_floats(Q, N, P),
                            stream>>>(
      (const float*)dt, (const float*)A, (const T*)Cm, (const T*)dy,
      (float*)ds, (float*)dec, S, H, G, N, P, Q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_pass<<<B * H * ((NP + kThreads - 1) / kThreads), kThreads, 0,
                 stream>>>((float*)ds, (const float*)dec,
                           (const float*)dstate, (float*)dinit, nc, H, NP);
  return (int)cudaGetLastError();
}

template <typename T, typename SP>
int chunks(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* dy, const void* s_prev,
           const void* ds, void* dx, void* ddt, void* dA, void* dB, void* dC,
           void* dB_part, void* dC_part, void* dA_part, int B, int S, int H,
           int G, int N, int P, int Q, cudaStream_t stream) {
  static const int configured = configure(
      ssd_bwd_chunk<T, SP>, 4 * chunk_floats(kMaxQ, kMaxNP, kMaxNP));
  if (configured != 0) return configured;
  const int nc = (S + Q - 1) / Q;
  ssd_bwd_chunk<T, SP><<<B * nc * H, kThreads, 4 * chunk_floats(Q, N, P),
                         stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
      (const T*)Cm, (const T*)dy, (const SP*)s_prev, (const float*)ds, (T*)dx,
      (float*)ddt, (float*)dB_part, (float*)dC_part, (float*)dA_part, S, H, G,
      N, P, Q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n_bc = (int64_t)B * S * G * N;
  ssd_bwd_reduce<T><<<grid_for(n_bc > (int64_t)B * H ? n_bc : (int64_t)B * H),
                      kThreads, 0, stream>>>(
      (const float*)dB_part, (const float*)dC_part, (const float*)dA_part,
      (T*)dB, (T*)dC, (float*)dA, n_bc, nc, B, H, G, N);
  return (int)cudaGetLastError();
}

bool valid(int B, int S, int H, int G, int N, int P, int Q) {
  return B >= 1 && S >= 1 && H >= 1 && G >= 1 && H % G == 0 && Q >= 1
         && Q <= kMaxQ && N >= 1 && N <= kMaxNP && P >= 1 && P <= kMaxNP;
}

}  // namespace

extern "C" {

// The gradient of the state leaving each chunk, ds [B, chunks, H, N, P]
// float32, and dinit [B, H, N, P] float32, from dt [B, S, H] and A
// [B * H] float32, Cm [B, S, G, N] and dy [B, S, H, P] in one type
// (bf16 != 0: bfloat16, else float32) and dstate (or null: zeros)
// [B, H, N, P] float32; dec [B, chunks, H] float32 is scratch.  Kernels
// (a) and (b).  Returns a CUDA error code; cudaErrorInvalidValue outside
// 1 <= Q <= 128, 1 <= N, P <= 64 or for H not a multiple of G.
int mamba2_scan_bwd_dstates(const void* dt, const void* A, const void* Cm,
                            const void* dy, const void* dstate, void* ds,
                            void* dec, void* dinit, int B, int S, int H,
                            int G, int N, int P, int Q, int bf16,
                            void* stream) {
  if (!valid(B, S, H, G, N, P, Q)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return dstates<__nv_bfloat16>(dt, A, Cm, dy, dstate, ds, dec, dinit, B,
                                  S, H, G, N, P, Q, st);
  return dstates<float>(dt, A, Cm, dy, dstate, ds, dec, dinit, B, S, H, G, N,
                        P, Q, st);
}

// The gradients dx [B, S, H, P] and dB, dC [B, S, G, N] in x's type,
// ddt [B, S, H] and dA [B * H] float32, from the forward's inputs, dy,
// s_prev (float32 [B, chunks, H, N, P], or for bfloat16 the hi and lo
// halves [B, chunks, H, 2, N, P]) and ds from mamba2_scan_bwd_dstates;
// dB_part, dC_part [B, S, H, N] and dA_part [B, chunks, H] float32 are
// scratch.  Kernels (c) and (d).  Returns a CUDA error code, as above.
int mamba2_scan_bwd_chunks(const void* x, const void* dt, const void* A,
                           const void* Bm, const void* Cm, const void* dy,
                           const void* s_prev, const void* ds, void* dx,
                           void* ddt, void* dA, void* dB, void* dC,
                           void* dB_part, void* dC_part, void* dA_part, int B,
                           int S, int H, int G, int N, int P, int Q, int bf16,
                           void* stream) {
  if (!valid(B, S, H, G, N, P, Q)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return chunks<__nv_bfloat16, __nv_bfloat16>(  // `bf16` is the flag here
        x, dt, A, Bm, Cm, dy, s_prev, ds, dx, ddt, dA, dB, dC, dB_part,
        dC_part, dA_part, B, S, H, G, N, P, Q, st);
  return chunks<float, float>(x, dt, A, Bm, Cm, dy, s_prev, ds, dx, ddt, dA,
                              dB, dC, dB_part, dC_part, dA_part, B, S, H, G,
                              N, P, Q, st);
}

// The dynamic shared memory of a block of kernel (a) (which 0) or (c)
// (which 1) at these sizes.
int mamba2_scan_bwd_smem_bytes(int Q, int N, int P, int which) {
  return 4 * (which ? chunk_floats(Q, N, P) : local_floats(Q, N, P));
}

}  // extern "C"
