// RWKV6 (Finch) recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/rwkv6_scan/rwkv6_scan.py: rwkv6_scan_kernel,
// the Pallas kernel whose grid walks (head, chunk) with the chunks in order
// and keeps the [N, N] state in VMEM scratch.  This kernel also takes the
// initial state (or zeros) and writes the final state, which the prefill
// cache needs (models/ssm.py: rwkv6_time_mix).
//
// Computes, for every batch row b and head h, sequentially over t:
//   y_t = r_t (S + (u * k_t) v_t^T)
//   S   = diag(w_t) S + k_t v_t^T
// with S [N, N] in fp32.  y is written in the inputs' type.
//
// Layout: r, k, v, w and y [B, S, H, N] in one type, u [B * H, N] fp32,
// init (or null: zeros) and state [B, H, N, N] fp32, all contiguous.  The
// Pallas layout [BH, S, N] is the case H = 1.
//
// Bound: neither bytes nor operations but the sequence: every step depends
// on the last, about 4 N^2 flops a (head, step) against 5 N elements moved.
//
// Design: one block per (b, h) with a thread per state column j, which
// keeps its column S[:, j] in registers, so a step needs no exchange
// between threads: y_t[j] = sum_i r_i (S[i][j] + u_i k_i v_j) and the
// column's update.  The block stages a chunk of kStep steps of r, u * k,
// w and v in shared memory between barriers and every thread reads them as
// broadcasts.  N in {8, 16, 32, 64}.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kStep = 32;             // time steps staged per barrier

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int N>
__global__ void __launch_bounds__(N < 32 ? 32 : N)
wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ w,
           const float* __restrict__ u, const float* __restrict__ init,
           T* __restrict__ y, float* __restrict__ final_state, int S,
           int H) {
  constexpr int NT = N < 32 ? 32 : N;
  __shared__ float r_s[kStep][N];
  __shared__ float uk_s[kStep][N];
  __shared__ float k_s[kStep][N];
  __shared__ float w_s[kStep][N];
  __shared__ float v_s[kStep][N];
  __shared__ float u_s[N];
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int j = threadIdx.x;
  const bool owner = j < N;
  float st[N];
#pragma unroll
  for (int i = 0; i < N; ++i)
    st[i] = (owner && init) ? init[((int64_t)bh * N + i) * N + j] : 0.f;
  if (owner) u_s[j] = u[(int64_t)bh * N + j];
  const int64_t row = (int64_t)H * N;           // between time steps
  const int64_t base = ((int64_t)b * S * H + h) * N;
  for (int t0 = 0; t0 < S; t0 += kStep) {
    const int n = min(kStep, S - t0);
    __syncthreads();                   // the last chunk's readers are done
    for (int e = j; e < n * N; e += NT) {
      const int t = e / N, i = e % N;
      const int64_t off = base + (t0 + t) * row + i;
      const float kv = to_f32(k[off]);
      r_s[t][i] = to_f32(r[off]);
      k_s[t][i] = kv;
      uk_s[t][i] = u_s[i] * kv;
      w_s[t][i] = to_f32(w[off]);
      v_s[t][i] = to_f32(v[off]);
    }
    __syncthreads();
    if (!owner) continue;
    for (int t = 0; t < n; ++t) {
      const float vj = v_s[t][j];
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        acc = fmaf(r_s[t][i], fmaf(uk_s[t][i], vj, st[i]), acc);
        st[i] = fmaf(w_s[t][i], st[i], k_s[t][i] * vj);
      }
      store(y + base + (t0 + t) * row + j, acc);
    }
  }
  if (owner) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      final_state[((int64_t)bh * N + i) * N + j] = st[i];
  }
}

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* init, void* y, void* state, int B,
           int S, int H, cudaStream_t stream) {
  wkv_kernel<T, N><<<B * H, N < 32 ? 32 : N, 0, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const T*)w, (const float*)u,
      (const float*)init, (T*)y, (float*)state, S, H);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dim(const void* r, const void* k, const void* v, const void* w,
               const void* u, const void* init, void* y, void* state, int B,
               int S, int H, int N, cudaStream_t st) {
  switch (N) {
    case 8: return launch<T, 8>(r, k, v, w, u, init, y, state, B, S, H, st);
    case 16: return launch<T, 16>(r, k, v, w, u, init, y, state, B, S, H, st);
    case 32: return launch<T, 32>(r, k, v, w, u, init, y, state, B, S, H, st);
    case 64: return launch<T, 64>(r, k, v, w, u, init, y, state, B, S, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// r, k, v, w and y [B, S, H, N] of one type (bf16 != 0: bfloat16, else
// float32); u [B * H, N], init (or null: zeros) and state [B, H, N, N]
// float32; all contiguous.  Returns a CUDA error code;
// cudaErrorInvalidValue for N outside {8, 16, 32, 64}.
int rwkv6_scan(const void* r, const void* k, const void* v, const void* w,
               const void* u, const void* init, void* y, void* state, int B,
               int S, int H, int N, int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return launch_dim<__nv_bfloat16>(r, k, v, w, u, init, y, state, B, S, H,
                                     N, st);
  return launch_dim<float>(r, k, v, w, u, init, y, state, B, S, H, N, st);
}

}  // extern "C"
