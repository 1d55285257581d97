// Backward of the RWKV6 (Finch) recurrence for Hopper (sm_90a), plain C
// interface.
//
// Differentiates: src/repro/kernels/rwkv6_scan/rwkv6_scan.py:
// rwkv6_scan_kernel, whose forward csrc/rwkv6_scan.cu computes.  The
// Pallas kernel has no backward of its own: the reference differentiates
// its pure-jnp recurrence (models/ssm.py: _rwkv6_chunked), as the port's
// plain backward differentiates rwkv6_scan_plain.
//
// Forward, per batch row b and head h, with P_t the [N, N] state before
// step t (P_0 the initial state, P_S the final one):
//   y_t     = r_t (P_t + (u * k_t) v_t^T)
//   P_{t+1} = diag(w_t) P_t + k_t v_t^T
// Backward, t from S - 1 down to 0, G_{t+1} the gradient of P_{t+1}
// (G_S that of the final state) and (v.dy)_t = v_t . dy_t:
//   dr_t[i] = sum_j P_t[i][j] dy_t[j] + u_i k_t[i] (v.dy)_t
//   dk_t[i] = sum_j G_{t+1}[i][j] v_t[j] + u_i r_t[i] (v.dy)_t
//   dv_t[j] = sum_i G_{t+1}[i][j] k_t[i] + (sum_i r_t[i] u_i k_t[i]) dy_t[j]
//   dw_t[i] = sum_j G_{t+1}[i][j] P_t[i][j]
//   du[i]  += r_t[i] k_t[i] (v.dy)_t
//   G_t     = diag(w_t) G_{t+1} + r_t dy_t^T,   dinit = G_0.
// fp32 only: every model path casts r, k, v and w to fp32.
//
// Layout: r, k, v, w, dy and the gradients dr, dk, dv, dw [B, S, H, N]
// fp32; u and du [B * H, N]; dstate (or null: zeros) and dinit
// [B, H, N, N]; states [B, ceil(S / kSave), H, N, N], P_t at t = 0,
// kSave, 2 kSave, ... as the forward wrote it; all contiguous.
//
// Bound: operations.  At rwkv6-3b's training shape (4 x 40 heads, S
// 2048, N 64) its 14 flops a state element a step (the state recomputed,
// dr, dk, dv, dw and the state gradient) are 18.8 GFLOP, 0.28 ms at the
// fp32 peak; the gradient's own bytes (r, k, v, w, u, init, dy and
// dstate read, their gradients written) are 0.76 GB, 0.23 ms at 3.35
// TB/s, and the saved states this design reads add 0.34 GB.  Like the
// forward, what holds it is the sequence: each step of a head waits on
// the last, and the warps that carry it are few (10 an SM).
//
// Design: the recurrence never mixes state columns and dw needs P_t and
// G_{t+1} together, so a block takes (b, h, a tile of kCols state
// columns) and a thread one state row i of that tile, its kCols values
// of P and of G in registers.  The row sums dr, dk and dw then need no
// exchange within the block; dv, a column sum, is the only one.  The
// block walks the stretches of kSave steps from the last: it loads the
// stretch's saved start state, recomputes P_t forward through the
// stretch into shared memory (the thread's own row, so no barrier
// between the two walks) while it forms dr, then walks the stretch
// backward with G, reading P_t back and leaving G_{t+1}[i][j] k_t[i] in
// its place; after a barrier the block sums those over i for dv.  w is
// never divided by (it reaches ~0).  Each tile's row sums dr, dk, dw and
// du are partials over its columns, written to scratch; a second kernel
// adds the tiles in order.  No atomics: two runs are bit-equal.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSave = 16;             // steps between saved states
constexpr int kCols = 8;              // state columns a block
constexpr int kSumThreads = 256;

__host__ __device__ constexpr int tile_cols(int N) {
  return N < kCols ? N : kCols;
}
// hist [kSave][N][C + 1]; the tile's v and dy [2][kSave][C]; each step's
// v . dy over the tile and bonus sum [2][kSave]; all fp32
__host__ __device__ constexpr int bwd_smem_bytes(int N) {
  return 4 * (kSave * N * (tile_cols(N) + 1) + 2 * kSave * tile_cols(N)
              + 2 * kSave);
}

template <int N>
__global__ void __launch_bounds__(N)
wkv_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ dy,
               const float* __restrict__ dstate,
               const float* __restrict__ states, float* __restrict__ dv,
               float* __restrict__ dinit, float* __restrict__ part,
               float* __restrict__ du_part, int B, int S, int H) {
  constexpr int C = tile_cols(N), T = N / C, LD = C + 1;
  extern __shared__ float smem[];
  float* hist = smem;                          // [kSave][N][LD]
  float* v_s = hist + kSave * N * LD;          // [kSave][C]
  float* dy_s = v_s + kSave * C;               // [kSave][C]
  float* vd_s = dy_s + kSave * C;              // [kSave]
  float* bon_s = vd_s + kSave;                 // [kSave]

  const int bh = blockIdx.x / T, tile = blockIdx.x % T;
  const int b = bh / H, h = bh % H, j0 = tile * C;
  const int i = threadIdx.x;
  const int64_t row = (int64_t)H * N;          // between time steps
  const int64_t base = ((int64_t)b * S * H + h) * N;
  const int64_t plane = (int64_t)B * S * H * N;
  float* dr_p = part + (int64_t)tile * plane;  // part [3][T][B, S, H, N]
  float* dk_p = part + (int64_t)(T + tile) * plane;
  float* dw_p = part + (int64_t)(2 * T + tile) * plane;
  const float ui = u[(int64_t)bh * N + i];
  const int n_save = (S + kSave - 1) / kSave;

  float G[C];                                  // G[i][j0 + c]
#pragma unroll
  for (int c = 0; c < C; ++c)
    G[c] = dstate ? dstate[((int64_t)bh * N + i) * N + j0 + c] : 0.f;
  float du_acc = 0.f;

  for (int sv = n_save - 1; sv >= 0; --sv) {
    const int t0 = sv * kSave, n = min(kSave, S - t0);
    float rr[kSave], kk[kSave], ww[kSave];
#pragma unroll
    for (int t = 0; t < kSave; ++t) {
      const int64_t off = base + (int64_t)(t0 + t) * row + i;
      rr[t] = t < n ? r[off] : 0.f;
      kk[t] = t < n ? k[off] : 0.f;
      ww[t] = t < n ? w[off] : 0.f;
    }
    for (int e = i; e < n * C; e += N) {
      const int64_t off = base + (int64_t)(t0 + e / C) * row + j0 + e % C;
      v_s[e] = v[off];
      dy_s[e] = dy[off];
    }
    __syncthreads();
    for (int t = i; t < n; t += N) {
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) s = fmaf(v_s[t * C + c], dy_s[t * C + c], s);
      vd_s[t] = s;
    }
    __syncthreads();
    // forward through the stretch from its saved start state: P_t into
    // hist, and dr_t
    float P[C];
    const float* p0 =
        states + ((((int64_t)b * n_save + sv) * H + h) * N + i) * N + j0;
#pragma unroll
    for (int c = 0; c < C; ++c) P[c] = p0[c];
#pragma unroll
    for (int t = 0; t < kSave; ++t) {
      if (t < n) {
        float* hr = hist + (t * N + i) * LD;
        const float* vt = v_s + t * C;
        const float* gt = dy_s + t * C;
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          hr[c] = P[c];
          acc = fmaf(P[c], gt[c], acc);
          P[c] = fmaf(ww[t], P[c], kk[t] * vt[c]);
        }
        dr_p[base + (int64_t)(t0 + t) * row + i] =
            fmaf(ui * kk[t], vd_s[t], acc);
      }
    }
    // backward through the stretch: dw_t, dk_t, G_{t+1} k_t into hist,
    // then G_t
#pragma unroll
    for (int t = kSave - 1; t >= 0; --t) {
      if (t < n) {
        float* hr = hist + (t * N + i) * LD;
        const float* vt = v_s + t * C;
        const float* gt = dy_s + t * C;
        float dw_ = 0.f, dk_ = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          dw_ = fmaf(G[c], hr[c], dw_);
          dk_ = fmaf(G[c], vt[c], dk_);
          hr[c] = G[c] * kk[t];
          G[c] = fmaf(ww[t], G[c], rr[t] * gt[c]);
        }
        hr[C] = rr[t] * ui * kk[t];
        const int64_t off = base + (int64_t)(t0 + t) * row + i;
        dw_p[off] = dw_;
        dk_p[off] = fmaf(ui * rr[t], vd_s[t], dk_);
        du_acc = fmaf(rr[t] * kk[t], vd_s[t], du_acc);
      }
    }
    __syncthreads();                   // every row's part of dv is in
    for (int t = i; t < n; t += N) {
      float s = 0.f;
      for (int q = 0; q < N; ++q) s += hist[(t * N + q) * LD + C];
      bon_s[t] = s;
    }
    __syncthreads();
    for (int e = i; e < n * C; e += N) {
      const int t = e / C, c = e % C;
      float s = 0.f;
      for (int q = 0; q < N; ++q) s += hist[(t * N + q) * LD + c];
      dv[base + (int64_t)(t0 + t) * row + j0 + c] = fmaf(bon_s[t], dy_s[e], s);
    }
    __syncthreads();                   // hist and the staging are reused
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
    dinit[((int64_t)bh * N + i) * N + j0 + c] = G[c];
  du_part[((int64_t)tile * B * H + bh) * N + i] = du_acc;
}

// dr, dk, dw (n elements each) and du (n_u) as the sums of the column
// tiles' partials, in tile order
__global__ void __launch_bounds__(kSumThreads)
wkv_bwd_sum(const float* __restrict__ part, const float* __restrict__ du_part,
            float* __restrict__ dr, float* __restrict__ dk,
            float* __restrict__ dw, float* __restrict__ du, int64_t n,
            int64_t n_u, int T) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += stride) {
    float a = 0.f, bk = 0.f, c = 0.f;
    for (int t = 0; t < T; ++t) {
      a += part[t * n + e];
      bk += part[(T + t) * n + e];
      c += part[(2 * T + t) * n + e];
    }
    dr[e] = a;
    dk[e] = bk;
    dw[e] = c;
  }
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n_u;
       e += stride) {
    float s = 0.f;
    for (int t = 0; t < T; ++t) s += du_part[t * n_u + e];
    du[e] = s;
  }
}

template <int N>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* dy, const float* dstate,
           const float* states, float* dr, float* dk, float* dv, float* dw,
           float* du, float* dinit, float* part, float* du_part, int B,
           int S, int H, cudaStream_t stream) {
  constexpr int T = N / tile_cols(N);
  constexpr int bytes = bwd_smem_bytes(N);
  static const int configured = (int)cudaFuncSetAttribute(
      wkv_bwd_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (configured != 0) return configured;
  wkv_bwd_kernel<N><<<B * H * T, N, bytes, stream>>>(
      r, k, v, w, u, dy, dstate, states, dv, dinit, part, du_part, B, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t n = (int64_t)B * S * H * N, n_u = (int64_t)B * H * N;
  const int64_t most = n > n_u ? n : n_u;
  const int blocks = (int)((most + kSumThreads - 1) / kSumThreads < 1056
                               ? (most + kSumThreads - 1) / kSumThreads
                               : 1056);
  wkv_bwd_sum<<<blocks, kSumThreads, 0, stream>>>(part, du_part, dr, dk, dw,
                                                  du, n, n_u, T);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, v, w, dy [B, S, H, N], u [B * H, N], dstate (or null: zeros)
// [B, H, N, N] and states [B, ceil(S / 16), H, N, N] (the forward's),
// all float32 and contiguous.  Writes dr, dk, dv, dw [B, S, H, N], du
// [B * H, N] and dinit [B, H, N, N], float32; part [3, T, B, S, H, N] and
// du_part [T, B * H, N] float32 are scratch, T = N / min(N, 8).  Two
// launches, on `stream`.  Returns a CUDA error code;
// cudaErrorInvalidValue for N outside {8, 16, 32, 64}, S < 1 or B H < 1.
int rwkv6_scan_bwd(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* dy,
                   const void* dstate, const void* states, void* dr,
                   void* dk, void* dv, void* dw, void* du, void* dinit,
                   void* part, void* du_part, int B, int S, int H, int N,
                   void* stream) {
  if (S < 1 || B * H < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define RWKV6_BWD_ARGS                                                      \
  (const float*)r, (const float*)k, (const float*)v, (const float*)w,       \
      (const float*)u, (const float*)dy, (const float*)dstate,              \
      (const float*)states, (float*)dr, (float*)dk, (float*)dv, (float*)dw, \
      (float*)du, (float*)dinit, (float*)part, (float*)du_part, B, S, H, st
  switch (N) {
    case 8: return launch<8>(RWKV6_BWD_ARGS);
    case 16: return launch<16>(RWKV6_BWD_ARGS);
    case 32: return launch<32>(RWKV6_BWD_ARGS);
    case 64: return launch<64>(RWKV6_BWD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RWKV6_BWD_ARGS
}

// The dynamic shared memory of a backward block at state size N.
int rwkv6_scan_bwd_smem_bytes(int N) { return bwd_smem_bytes(N); }

}  // extern "C"
