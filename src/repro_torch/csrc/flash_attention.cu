// Blocked online-softmax attention (FlashAttention) for Hopper (sm_90a),
// plain C interface.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py:
// flash_attention_kernel, the Pallas kernel whose grid walks (head, query
// block, key block) with the key blocks in order and keeps the running max,
// sum and accumulator of one query block in VMEM scratch.
//
// Computes, for every batch row b, query head h and query position s:
// softmax(q[b, s, h] . k[b, t, h / G] / sqrt(D)) over the keys t (all T of
// them, or t <= s when causal) applied to v[b, t, h / G], with G = H / KV
// query heads per KV head.  Scores, softmax and the value sum are fp32 on
// the CUDA cores (an fp32 input never goes through TF32); the output is
// written in the input type.  Masked keys are skipped, which equals the
// Pallas kernel's exp(-1e30 - m) = 0: every causal row sees key 0 in its
// first key tile, so its running max is finite from then on.  S and T need
// not be multiples of the tiles: rows and keys past them are bounds-checked.
//
// Layout: q and out [B, S, H, D], k and v [B, T, KV, D], all contiguous (the
// models' own layout, so no transposes around the call).  The Pallas
// layout [BH, S, D] is the case H = KV = 1.
//
// Bound: operations.  Causal attention does 2 * 2 * S * T * D / 2 flops a
// head against (S + 2 T) * D elements moved, hundreds of flops a byte at
// the prefill shapes.
//
// Design: one block of 128 threads per (query tile of BQ rows, batch row x
// head); it loops over the key tiles in order, up to the diagonal when
// causal.  Q, the K and V tiles, the probabilities and the output
// accumulator sit in shared memory as fp32 (padded rows against bank
// conflicts); each thread owns a BQ/16 x BK/8 block of scores with rows and
// columns interleaved (row rg + 16 i, column cg + 8 j) and the eight
// threads of a row reduce its max and sum with shuffles.  Tensor cores,
// cp.async/TMA and warp specialisation are not used yet.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D, int BQ, int BK>
constexpr int smem_floats() {
  return BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1) + BQ * D + 3 * BQ;
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int S, int Tk,
             int H, int KV, int causal) {
  static_assert(BQ % 16 == 0 && BK % 8 == 0, "tile shape");
  constexpr int DP = D + 1;
  constexpr int RQ = BQ / 16;          // score rows per thread
  constexpr int CK = BK / 8;           // score columns per thread
  constexpr int MC = 8;                // output columns per pass
  constexpr int NCOL = (D + 7) / 8;    // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                   // [BQ][DP]
  float* k_s = q_s + BQ * DP;          // [BK][DP]
  float* v_s = k_s + BK * DP;          // [BK][DP]
  float* p_s = v_s + BK * DP;          // [BQ][BK + 1]
  float* o_s = p_s + BQ * (BK + 1);    // [BQ][D]
  float* m_s = o_s + BQ * D;           // [BQ] running max
  float* l_s = m_s + BQ;               // [BQ] running sum
  float* a_s = l_s + BQ;               // [BQ] this tile's rescale

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int rg = tid / 8, cg = tid % 8;
  const int64_t q_stride = (int64_t)H * D;      // between query positions
  const int64_t kv_stride = (int64_t)KV * D;    // between key positions
  const T* qb = q + ((int64_t)b * S * H + h) * D;
  const T* kb = k + ((int64_t)b * Tk * KV + kvh) * D;
  const T* vb = v + ((int64_t)b * Tk * KV + kvh) * D;
  T* ob = out + ((int64_t)b * S * H + h) * D;
  const float scale = 1.f / sqrtf((float)D);

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    q_s[r * DP + c] = q0 + r < S ? to_f32(qb[(q0 + r) * q_stride + c]) : 0.f;
    o_s[i] = 0.f;
  }
  for (int r = tid; r < BQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  const int kv_end = causal ? min(Tk, q0 + BQ) : Tk;
  const int n_tiles = (kv_end + BK - 1) / BK;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();                   // the last tile's readers are done
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool ok = k0 + r < Tk;
      k_s[r * DP + c] = ok ? to_f32(kb[(k0 + r) * kv_stride + c]) : 0.f;
      v_s[r * DP + c] = ok ? to_f32(vb[(k0 + r) * kv_stride + c]) : 0.f;
    }
    __syncthreads();
    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = q_s[(rg + 16 * i) * DP + c];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = k_s[(cg + 8 * j) * DP + c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = rg + 16 * i;
      const int qpos = q0 + r;
      bool valid[CK];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kpos = k0 + cg + 8 * j;
        valid[j] = kpos < Tk && (!causal || kpos <= qpos);
        s[i][j] *= scale;
        if (valid[j]) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        p_s[r * (BK + 1) + cg + 8 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (cg == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
    // o[r][c] = o[r][c] * alpha[r] + sum_j p[r][j] v[j][c]
#pragma unroll
    for (int c0 = 0; c0 < NCOL; c0 += MC) {
      float acc[RQ][MC];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float alpha = a_s[rg + 16 * i];
#pragma unroll
        for (int m = 0; m < MC; ++m) {
          const int c = cg + 8 * (c0 + m);
          acc[i][m] = (c0 + m < NCOL && c < D)
                          ? o_s[(rg + 16 * i) * D + c] * alpha : 0.f;
        }
      }
#pragma unroll 4
      for (int j = 0; j < BK; ++j) {
        float pv[RQ], vv[MC];
#pragma unroll
        for (int i = 0; i < RQ; ++i) pv[i] = p_s[(rg + 16 * i) * (BK + 1) + j];
#pragma unroll
        for (int m = 0; m < MC; ++m) {
          const int c = cg + 8 * (c0 + m);
          vv[m] = (c0 + m < NCOL && c < D) ? v_s[j * DP + c] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int m = 0; m < MC; ++m) acc[i][m] = fmaf(pv[i], vv[m], acc[i][m]);
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int m = 0; m < MC; ++m) {
          const int c = cg + 8 * (c0 + m);
          if (c0 + m < NCOL && c < D) o_s[(rg + 16 * i) * D + c] = acc[i][m];
        }
    }
  }
  __syncthreads();
  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (q0 + r < S)
      store(ob + (q0 + r) * q_stride + c, o_s[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T, int D, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Tk, int H, int KV, int causal, cudaStream_t stream) {
  constexpr size_t bytes = sizeof(float) * smem_floats<D, BQ, BK>();
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, D, BQ, BK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_kernel<T, D, BQ, BK><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, Tk, H, KV, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dim(const void* q, const void* k, const void* v, void* out, int B,
               int S, int Tk, int H, int KV, int D, int causal,
               cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16, 64, 64>(q, k, v, out, B, S, Tk, H, KV, causal, st);
    case 32: return launch<T, 32, 64, 64>(q, k, v, out, B, S, Tk, H, KV, causal, st);
    case 64: return launch<T, 64, 64, 64>(q, k, v, out, B, S, Tk, H, KV, causal, st);
    case 80: return launch<T, 80, 64, 64>(q, k, v, out, B, S, Tk, H, KV, causal, st);
    case 128: return launch<T, 128, 32, 32>(q, k, v, out, B, S, Tk, H, KV, causal, st);
    case 256: return launch<T, 256, 32, 32>(q, k, v, out, B, S, Tk, H, KV, causal, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q and out [B, S, H, D], k and v [B, T, KV, D], one type (bf16 != 0:
// bfloat16, else float32), contiguous; H a multiple of KV.  Returns a CUDA
// error code; cudaErrorInvalidValue for a head dim outside
// {16, 32, 64, 80, 128, 256}.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    int B, int S, int T, int H, int KV, int D, int causal,
                    int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return launch_dim<__nv_bfloat16>(q, k, v, out, B, S, T, H, KV, D, causal,
                                     st);
  return launch_dim<float>(q, k, v, out, B, S, T, H, KV, D, causal, st);
}

}  // extern "C"
