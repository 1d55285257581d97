// Chunked Mamba2 SSD scan for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/mamba2_scan/mamba2_scan.py:
// mamba2_scan_kernel, the Pallas kernel whose grid walks (head, chunk) with
// the chunks in order and keeps the [N, P] state in VMEM scratch.  This
// kernel also takes an initial state (or zeros) and writes the final state,
// which the prefill cache needs (models/ssm.py: ssd_chunked).
//
// Computes, for every batch row b and head h (group g = h / (H / G)), over
// chunks of Q positions in order, with dA = dt * A[b, h], cum its inclusive
// cumulative sum within the chunk and dtx = dt * x:
//   y[i]  = sum_{j <= i} (C[i] . B[j]) exp(cum[i] - cum[j]) dtx[j]
//         + exp(cum[i]) C[i] . state
//   state = state exp(cum[Q-1]) + sum_j exp(cum[Q-1] - cum[j]) B[j] dtx[j]^T
// all in fp32 on the CUDA cores.  y is written in x's type.  A last chunk
// shorter than Q is padded with dt = x = B = C = 0, which adds nothing and
// leaves cum where it was.
//
// Layout: x and y [B, S, H, P], dt [B, S, H] fp32, A [B * H] fp32, Bm and
// Cm [B, S, G, N] in x's type, state [B, H, N, P] fp32, all contiguous.
// The Pallas layout [BH, S, P] is the case H = G = 1.
//
// Bound: operations at the prefill shapes: 2 Q^2 (N + P) + 4 Q N P flops a
// chunk against Q (2 P + 2 N + 1) elements read and Q P written.
//
// Design: one block of 256 threads per (b, h), looping over the chunks in
// order with the state in shared memory.  Per chunk the block stages B, C,
// dtx and cum in shared memory, builds the [Q, Q] decayed C B^T matrix,
// then each thread computes an interleaved register tile of y and, after a
// barrier, of the state update.  Q <= 128 and N, P <= 64.  Tensor cores and
// the upper triangle's skip are not used yet.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 128;
constexpr int kMaxNP = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__host__ __device__ constexpr int smem_floats(int Q, int N, int P) {
  // B, C [Q][N + 1]; dtx [Q][P]; M [Q][Q + 1]; state [N][P]; cum, dt [Q]
  return 2 * Q * (N + 1) + Q * P + Q * (Q + 1) + N * P + 2 * Q;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ init,
           T* __restrict__ y, float* __restrict__ final_state, int S, int H,
           int G, int N, int P, int Q) {
  extern __shared__ float smem[];
  const int NP1 = N + 1;
  float* B_s = smem;                     // [Q][N + 1]
  float* C_s = B_s + Q * NP1;            // [Q][N + 1]
  float* x_s = C_s + Q * NP1;            // [Q][P]   dt * x
  float* M_s = x_s + Q * P;              // [Q][Q + 1]
  float* st_s = M_s + Q * (Q + 1);       // [N][P]
  float* cum_s = st_s + N * P;           // [Q]
  float* dt_s = cum_s + Q;               // [Q]

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int g = h / (H / G);
  const float a = A[bh];
  const int tid = threadIdx.x;
  const int t16 = tid / 16, l16 = tid % 16;

  for (int i = tid; i < N * P; i += kThreads)
    st_s[i] = init ? init[(int64_t)bh * N * P + i] : 0.f;

  const int n_chunks = (S + Q - 1) / Q;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int s0 = ch * Q;
    __syncthreads();                     // last chunk's readers are done
    for (int i = tid; i < Q; i += kThreads) {
      const int s = s0 + i;
      dt_s[i] = s < S ? dt[((int64_t)b * S + s) * H + h] : 0.f;
    }
    __syncthreads();
    if (tid == 0) {                      // inclusive cumsum of dt * A
      float c = 0.f;
      for (int i = 0; i < Q; ++i) {
        c += dt_s[i] * a;
        cum_s[i] = c;
      }
    }
    for (int i = tid; i < Q * P; i += kThreads) {
      const int r = i / P, p = i % P, s = s0 + r;
      x_s[i] = s < S ? dt_s[r] * to_f32(x[(((int64_t)b * S + s) * H + h) * P + p])
                     : 0.f;
    }
    for (int i = tid; i < Q * N; i += kThreads) {
      const int r = i / N, n = i % N, s = s0 + r;
      const int64_t off = (((int64_t)b * S + s) * G + g) * N + n;
      B_s[r * NP1 + n] = s < S ? to_f32(Bm[off]) : 0.f;
      C_s[r * NP1 + n] = s < S ? to_f32(Cm[off]) : 0.f;
    }
    __syncthreads();
    // M[i][j] = (C[i] . B[j]) exp(cum[i] - cum[j]) for j <= i, else 0;
    // thread tile rows t16 + 16 u, columns l16 + 16 w
    {
      float acc[8][8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int w = 0; w < 8; ++w) acc[u][w] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[8], bv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = t16 + 16 * u, j = l16 + 16 * u;
          cv[u] = i < Q ? C_s[i * NP1 + n] : 0.f;
          bv[u] = j < Q ? B_s[j * NP1 + n] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int w = 0; w < 8; ++w) acc[u][w] = fmaf(cv[u], bv[w], acc[u][w]);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = t16 + 16 * u;
        if (i >= Q) continue;
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          const int j = l16 + 16 * w;
          if (j >= Q) continue;
          M_s[i * (Q + 1) + j] =
              j <= i ? acc[u][w] * expf(cum_s[i] - cum_s[j]) : 0.f;
        }
      }
    }
    __syncthreads();
    // y[i][p] = sum_j M[i][j] dtx[j][p] + exp(cum[i]) sum_n C[i][n] st[n][p]
    // thread tile rows t16 + 16 u (u < 8), columns l16 + 16 w (w < 4)
    {
      float acc[8][4], inter[8][4];
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[u][w] = inter[u][w] = 0.f;
      for (int j = 0; j < Q; ++j) {
        float mv[8], xv[4];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = t16 + 16 * u;
          mv[u] = i < Q ? M_s[i * (Q + 1) + j] : 0.f;
        }
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int p = l16 + 16 * w;
          xv[w] = p < P ? x_s[j * P + p] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int w = 0; w < 4; ++w) acc[u][w] = fmaf(mv[u], xv[w], acc[u][w]);
      }
      for (int n = 0; n < N; ++n) {
        float cv[8], sv[4];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = t16 + 16 * u;
          cv[u] = i < Q ? C_s[i * NP1 + n] : 0.f;
        }
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int p = l16 + 16 * w;
          sv[w] = p < P ? st_s[n * P + p] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 8; ++u)
#pragma unroll
          for (int w = 0; w < 4; ++w)
            inter[u][w] = fmaf(cv[u], sv[w], inter[u][w]);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = t16 + 16 * u;
        const int s = s0 + i;
        if (i >= Q || s >= S) continue;
        const float e = expf(cum_s[i]);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int p = l16 + 16 * w;
          if (p < P)
            store(y + (((int64_t)b * S + s) * H + h) * P + p,
                  acc[u][w] + inter[u][w] * e);
        }
      }
    }
    __syncthreads();                     // y read the state: update it now
    // st[n][p] = st[n][p] exp(cum[Q-1])
    //          + sum_j exp(cum[Q-1] - cum[j]) B[j][n] dtx[j][p]
    // thread tile rows t16 + 16 u (u < 4), columns l16 + 16 w (w < 4)
    {
      const float last = cum_s[Q - 1];
      float acc[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) acc[u][w] = 0.f;
      for (int j = 0; j < Q; ++j) {
        const float dec = expf(last - cum_s[j]);
        float bv[4], xv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int n = t16 + 16 * u;
          bv[u] = n < N ? B_s[j * NP1 + n] * dec : 0.f;
        }
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int p = l16 + 16 * w;
          xv[w] = p < P ? x_s[j * P + p] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int w = 0; w < 4; ++w) acc[u][w] = fmaf(bv[u], xv[w], acc[u][w]);
      }
      const float chunk_dec = expf(last);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int n = t16 + 16 * u;
        if (n >= N) continue;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int p = l16 + 16 * w;
          if (p < P) st_s[n * P + p] = st_s[n * P + p] * chunk_dec + acc[u][w];
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < N * P; i += kThreads)
    final_state[(int64_t)bh * N * P + i] = st_s[i];
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* init, void* y, void* state, int B,
           int S, int H, int G, int N, int P, int Q, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(Q, N, P);
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * smem_floats(kMaxQ, kMaxNP, kMaxNP)));
  if (err != cudaSuccess) return (int)err;
  ssd_kernel<T><<<B * H, kThreads, bytes, stream>>>(
      (const T*)x, (const float*)dt, (const float*)A, (const T*)Bm,
      (const T*)Cm, (const float*)init, (T*)y, (float*)state, S, H, G, N, P,
      Q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x and y [B, S, H, P] and Bm/Cm [B, S, G, N] of one type (bf16 != 0:
// bfloat16, else float32); dt [B, S, H], A [B * H], init (or null: zeros)
// and state [B, H, N, P] float32; all contiguous, H a multiple of G.
// Returns a CUDA error code; cudaErrorInvalidValue outside 1 <= Q <= 128,
// 1 <= N, P <= 64.
int mamba2_scan(const void* x, const void* dt, const void* A, const void* Bm,
                const void* Cm, const void* init, void* y, void* state,
                int B, int S, int H, int G, int N, int P, int Q, int bf16,
                void* stream) {
  if (Q < 1 || Q > kMaxQ || N < 1 || N > kMaxNP || P < 1 || P > kMaxNP)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, init, y, state, B, S, H,
                                 G, N, P, Q, st);
  return launch<float>(x, dt, A, Bm, Cm, init, y, state, B, S, H, G, N, P, Q,
                       st);
}

}  // extern "C"
