// The backward of blocked online-softmax attention (K6) for Hopper
// (sm_90a), plain C interface.
//
// Replaces: the gradient of src/repro/kernels/flash_attention/
// flash_attention.py: flash_attention_kernel.  The JAX package has no
// backward kernel: it differentiates its pure-jnp attention
// (repro/models/layers.py: blocked_attention).  The port's layers run the
// forward kernel (csrc/flash_attention.cu), so their gradient on the card
// needs this one.
//
// Computes, for q [B, S, H, DK], k [B, T, KV, DK], v [B, T, KV, DV], the
// forward's output o [B, S, H, DV], its row log-sum-exp lse [B, H, S]
// (fp32, natural units, written by the forward) and the output's gradient
// dO [B, S, H, DV], with P = exp(q.k / sqrt(DK) - lse) over the keys a
// query sees (t <= s when causal, the plain version's top-left mask, or
// every key):
//   D  = rowsum(dO * o)                    fp32 [B, H, S]  (delta kernel)
//   dV = P^T dO,  dS = P * (dO V^T - D)
//   dK = dS^T q / sqrt(DK)                 (dK/dV kernel)
//   dQ = dS k / sqrt(DK)                   (dQ kernel)
// Query head h reads KV head h / G (G = H / KV); dK and dV sum over the G
// query heads of their KV head.  Every output element is written by one
// block, which owns its sum: no atomics, so the result is deterministic.
// The gradients are written in the inputs' type.  S and T need not be
// multiples of the tiles, and S may differ from T.
//
// Bound: operations.  2.5 times the forward's flops: the forward's S and
// P V products again, and dP, dK and dQ; at gemma-7b's training shape
// (B 4, H 16, S 2048, d 256, causal) 3.44e11 flop against ~0.13 GB moved.
//
// Design, bfloat16 (the models' training type): FlashAttention-2's
// backward on mma.sync.m16n8k16 (bf16 in, fp32 sums), 4 warps a block.
// The dK/dV kernel has a block per (batch row, KV head, key tile); it
// holds its K and V tiles in shared memory and walks the G query heads and
// their query tiles of 64 rows, from the first tile that sees its keys
// when causal: S^T = K Q^T and dP^T = V dO^T by warps of 16 keys x 64 / WC
// queries, P^T and dS^T rounded to bf16 into shared memory (P as the
// forward rounds it before its P V), then dV += P^T dO and dK += dS^T Q
// into fp32 register fragments, each warp 16 keys x DV / WC and DK / WC
// columns.  The dQ kernel mirrors it: a block per (batch row, head, query
// tile), the key tiles of 64 up to the diagonal when causal, dS to shared
// memory, dQ += dS K.  WC (warps across the columns) is 4 at a head dim
// above 128, 2 above 64, else 1, so that a warp's accumulators stay within
// 64 columns each: at d 256 a dK/dV block has 16 keys and a dQ block 16
// queries, and the block's shared memory is ~89 KB (dynamic, above the
// 48 KB default).  Operand rows are padded by 16 bytes so that ldmatrix
// meets no bank conflict; a head dim that is no multiple of 16 (8, 24) is
// zero-filled up to the next one where it is a product's k-dimension.
//
// Design, float32 (the models' agreement checks): the same blocks on the
// CUDA cores, tiles in shared memory as fp32 (16 keys x 32 queries a step
// for dK/dV, 16 queries x 32 keys for dQ), a thread a (row, column) dot
// product, then a thread an output element's sum over the step; no TF32.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// ------------------------------------------------------------ D = rowsum
// a warp a row (b, s, h) of o and dO, [B, S, H, DV]; D [B, H, S]
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                 float* __restrict__ delta, int rows, int S, int H, int DV) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;             // the whole warp
  const T* orow = o + (int64_t)row * DV;
  const T* drow = dout + (int64_t)row * DV;
  float sum = 0.f;
  for (int c = lane; c < DV; c += 32)
    sum = fmaf(to_f32(orow[c]), to_f32(drow[c]), sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const int h = row % H, s = (row / H) % S, b = row / H / S;
    delta[((int64_t)b * H + h) * S + s] = sum;
  }
}

// ------------------------------------------------- fp32 on the CUDA cores
constexpr int kF32Rows = 16;           // a block's keys (dK/dV), queries (dQ)
constexpr int kF32Step = 32;           // queries (dK/dV), keys (dQ) a step

template <int DK, int DV>
constexpr int f32_dkdv_floats() {
  constexpr int R = kF32Rows, C = kF32Step;
  return R * (DK + 1) + R * (DV + 1) + R * DK + R * DV + C * (DK + 1)
         + C * (DV + 1) + 2 * R * (C + 1) + 2 * C;
}

template <int DK, int DV>
constexpr int f32_dq_floats() {
  constexpr int R = kF32Rows, C = kF32Step;
  return R * (DK + 1) + R * (DV + 1) + R * DK + C * (DK + 1) + C * (DV + 1)
         + R * (C + 1) + 2 * R;
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dk,
                    float* __restrict__ dv, int S, int Tk, int H, int KV,
                    int causal) {
  constexpr int BK = kF32Rows, BQ = kF32Step;
  constexpr int KP = DK + 1, VP = DV + 1, PP = BQ + 1;
  extern __shared__ float smem[];
  float* k_s = smem;                   // [BK][KP]
  float* v_s = k_s + BK * KP;          // [BK][VP]
  float* dk_s = v_s + BK * VP;         // [BK][DK]
  float* dv_s = dk_s + BK * DK;        // [BK][DV]
  float* q_s = dv_s + BK * DV;         // [BQ][KP]
  float* do_s = q_s + BQ * KP;         // [BQ][VP]
  float* p_s = do_s + BQ * VP;         // [BK][PP]  P^T
  float* ds_s = p_s + BK * PP;         // [BK][PP]  dS^T
  float* lse_s = ds_s + BK * PP;       // [BQ]
  float* d_s = lse_s + BQ;             // [BQ]

  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int G = H / KV;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x;
  const int64_t q_stride = (int64_t)H * DK, o_stride = (int64_t)H * DV;
  const int64_t k_stride = (int64_t)KV * DK, v_stride = (int64_t)KV * DV;
  const float* kb = k + ((int64_t)b * Tk * KV + kvh) * DK;
  const float* vb = v + ((int64_t)b * Tk * KV + kvh) * DV;
  const float scale = 1.f / sqrtf((float)DK);

  for (int i = tid; i < BK * DK; i += kThreads) {
    const int r = i / DK, c = i % DK;
    k_s[r * KP + c] = k0 + r < Tk ? kb[(k0 + r) * k_stride + c] : 0.f;
    dk_s[i] = 0.f;
  }
  for (int i = tid; i < BK * DV; i += kThreads) {
    const int r = i / DV, c = i % DV;
    v_s[r * VP + c] = k0 + r < Tk ? vb[(k0 + r) * v_stride + c] : 0.f;
    dv_s[i] = 0.f;
  }
  // the first query tile that sees key k0 (the mask is s >= t)
  const int q_begin = causal ? k0 / BQ * BQ : 0;
  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const float* qb = q + ((int64_t)b * S * H + h) * DK;
    const float* dob = dout + ((int64_t)b * S * H + h) * DV;
    const float* lseb = lse + ((int64_t)b * H + h) * S;
    const float* db = delta + ((int64_t)b * H + h) * S;
    for (int q0 = q_begin; q0 < S; q0 += BQ) {
      __syncthreads();                 // the last step's readers are done
      for (int i = tid; i < BQ * DK; i += kThreads) {
        const int r = i / DK, c = i % DK;
        q_s[r * KP + c] = q0 + r < S ? qb[(q0 + r) * q_stride + c] : 0.f;
      }
      for (int i = tid; i < BQ * DV; i += kThreads) {
        const int r = i / DV, c = i % DV;
        do_s[r * VP + c] = q0 + r < S ? dob[(q0 + r) * o_stride + c] : 0.f;
      }
      for (int r = tid; r < BQ; r += kThreads) {
        lse_s[r] = q0 + r < S ? lseb[q0 + r] : 0.f;
        d_s[r] = q0 + r < S ? db[q0 + r] : 0.f;
      }
      __syncthreads();
      for (int i = tid; i < BK * BQ; i += kThreads) {
        const int r = i / BQ, c = i % BQ;
        const int kpos = k0 + r, qpos = q0 + c;
        float s = 0.f, dp = 0.f;
        for (int x = 0; x < DK; ++x)
          s = fmaf(k_s[r * KP + x], q_s[c * KP + x], s);
        for (int x = 0; x < DV; ++x)
          dp = fmaf(v_s[r * VP + x], do_s[c * VP + x], dp);
        const bool ok = kpos < Tk && qpos < S && (!causal || qpos >= kpos);
        const float p = ok ? expf(s * scale - lse_s[c]) : 0.f;
        p_s[r * PP + c] = p;
        ds_s[r * PP + c] = p * (dp - d_s[c]);
      }
      __syncthreads();
      for (int i = tid; i < BK * DV; i += kThreads) {
        const int r = i / DV, c = i % DV;
        float acc = dv_s[i];
        for (int x = 0; x < BQ; ++x)
          acc = fmaf(p_s[r * PP + x], do_s[x * VP + c], acc);
        dv_s[i] = acc;
      }
      for (int i = tid; i < BK * DK; i += kThreads) {
        const int r = i / DK, c = i % DK;
        float acc = dk_s[i];
        for (int x = 0; x < BQ; ++x)
          acc = fmaf(ds_s[r * PP + x], q_s[x * KP + c], acc);
        dk_s[i] = acc;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < BK * DK; i += kThreads) {
    const int r = i / DK, c = i % DK;
    if (k0 + r < Tk)
      dk[((int64_t)(b * Tk + k0 + r) * KV + kvh) * DK + c] = dk_s[i] * scale;
  }
  for (int i = tid; i < BK * DV; i += kThreads) {
    const int r = i / DV, c = i % DV;
    if (k0 + r < Tk)
      dv[((int64_t)(b * Tk + k0 + r) * KV + kvh) * DV + c] = dv_s[i];
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dq,
                  int S, int Tk, int H, int KV, int causal) {
  constexpr int BQ = kF32Rows, BK = kF32Step;
  constexpr int KP = DK + 1, VP = DV + 1, PP = BK + 1;
  extern __shared__ float smem[];
  float* q_s = smem;                   // [BQ][KP]
  float* do_s = q_s + BQ * KP;         // [BQ][VP]
  float* dq_s = do_s + BQ * VP;        // [BQ][DK]
  float* k_s = dq_s + BQ * DK;         // [BK][KP]
  float* v_s = k_s + BK * KP;          // [BK][VP]
  float* ds_s = v_s + BK * VP;         // [BQ][PP]
  float* lse_s = ds_s + BQ * PP;       // [BQ]
  float* d_s = lse_s + BQ;             // [BQ]

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int64_t q_stride = (int64_t)H * DK, o_stride = (int64_t)H * DV;
  const int64_t k_stride = (int64_t)KV * DK, v_stride = (int64_t)KV * DV;
  const float* qb = q + ((int64_t)b * S * H + h) * DK;
  const float* dob = dout + ((int64_t)b * S * H + h) * DV;
  const float* kb = k + ((int64_t)b * Tk * KV + kvh) * DK;
  const float* vb = v + ((int64_t)b * Tk * KV + kvh) * DV;
  const float scale = 1.f / sqrtf((float)DK);

  for (int i = tid; i < BQ * DK; i += kThreads) {
    const int r = i / DK, c = i % DK;
    q_s[r * KP + c] = q0 + r < S ? qb[(q0 + r) * q_stride + c] : 0.f;
    dq_s[i] = 0.f;
  }
  for (int i = tid; i < BQ * DV; i += kThreads) {
    const int r = i / DV, c = i % DV;
    do_s[r * VP + c] = q0 + r < S ? dob[(q0 + r) * o_stride + c] : 0.f;
  }
  for (int r = tid; r < BQ; r += kThreads) {
    const int64_t at = ((int64_t)b * H + h) * S + q0 + r;
    lse_s[r] = q0 + r < S ? lse[at] : 0.f;
    d_s[r] = q0 + r < S ? delta[at] : 0.f;
  }
  const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();                   // the last step's readers are done
    for (int i = tid; i < BK * DK; i += kThreads) {
      const int r = i / DK, c = i % DK;
      k_s[r * KP + c] = k0 + r < Tk ? kb[(k0 + r) * k_stride + c] : 0.f;
    }
    for (int i = tid; i < BK * DV; i += kThreads) {
      const int r = i / DV, c = i % DV;
      v_s[r * VP + c] = k0 + r < Tk ? vb[(k0 + r) * v_stride + c] : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < BQ * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;
      const int qpos = q0 + r, kpos = k0 + c;
      float s = 0.f, dp = 0.f;
      for (int x = 0; x < DK; ++x)
        s = fmaf(q_s[r * KP + x], k_s[c * KP + x], s);
      for (int x = 0; x < DV; ++x)
        dp = fmaf(do_s[r * VP + x], v_s[c * VP + x], dp);
      const bool ok = kpos < Tk && qpos < S && (!causal || qpos >= kpos);
      const float p = ok ? expf(s * scale - lse_s[r]) : 0.f;
      ds_s[r * PP + c] = p * (dp - d_s[r]);
    }
    __syncthreads();
    for (int i = tid; i < BQ * DK; i += kThreads) {
      const int r = i / DK, c = i % DK;
      float acc = dq_s[i];
      for (int x = 0; x < BK; ++x)
        acc = fmaf(ds_s[r * PP + x], k_s[x * KP + c], acc);
      dq_s[i] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < BQ * DK; i += kThreads) {
    const int r = i / DK, c = i % DK;
    if (q0 + r < S)
      dq[((int64_t)b * S + q0 + r) * q_stride + h * DK + c] = dq_s[i] * scale;
  }
}

// ------------------------------------------------- bf16 on the tensor cores
constexpr int kStep = 64;              // queries (dK/dV), keys (dQ) a step

// a row's width in shared memory as a product's k-dimension: d rounded up
// to the k-step of 16
__host__ __device__ constexpr int pad16(int d) { return (d + 15) / 16 * 16; }

// warps across the output columns (the other 4 / WC across the rows): a
// warp's dK and dV (or dQ) fragments stay within 64 columns each
__host__ __device__ constexpr int col_warps(int DK, int DV) {
  return DK > 128 || DV > 128 ? 4 : DK > 64 || DV > 64 ? 2 : 1;
}

// a block's bytes of dynamic shared memory: its own rows (R = 64 / WC of
// the first operand pair) and the step's (64 of the second), two rows of
// bf16 scores for dK/dV, one for dQ, and two fp32 vectors of the step's
// or the block's rows
template <int DK, int DV>
constexpr int bf16_smem_bytes(bool dkdv) {
  constexpr int R = 64 / col_warps(DK, DV);
  constexpr int KP = pad16(DK) + 8, VP = pad16(DV) + 8, PP = kStep + 8;
  return 2 * ((R + kStep) * (KP + VP) + (dkdv ? 2 : 1) * R * PP)
         + 4 * 2 * (dkdv ? kStep : R);
}

// acc[N][4] += A B^T over KD / 16 k-steps: A 16 rows from `a`, B N * 8 rows
// from `b` (b_stride apart), both row-major in shared memory and already
// offset to this lane's ldmatrix row and column (the forward's Q and K
// operands)
template <int N, int KD>
__device__ __forceinline__ void mma_nt(float (*acc)[4], const bf16* a,
                                       const bf16* b, int b_stride) {
  static_assert(N % 2 == 0, "n-tiles in pairs");
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, smem_addr(a + kk * 16));
#pragma unroll
    for (int j = 0; j < N; j += 2) {
      uint32_t bf[4];
      ldsm_x4(bf, smem_addr(b + j * 8 * b_stride + kk * 16));
      mma_bf16(acc[j], af, bf[0], bf[1]);
      mma_bf16(acc[j + 1], af, bf[2], bf[3]);
    }
  }
}

// acc[N][4] += a (a 16 x 16 A fragment) times the 16 x N * 8 tile at
// `tile`, row-major in shared memory and already offset to this lane's
// transposed-ldmatrix row and column (the forward's V operand); an odd last
// n-tile alone
template <int N>
__device__ __forceinline__ void mma_nn(float (*acc)[4], const uint32_t* a,
                                       const bf16* tile) {
#pragma unroll
  for (int j = 0; j + 1 < N; j += 2) {
    uint32_t bt[4];
    ldsm_x4_t(bt, smem_addr(tile + j * 8));
    mma_bf16(acc[j], a, bt[0], bt[1]);
    mma_bf16(acc[j + 1], a, bt[2], bt[3]);
  }
  if constexpr (N % 2) {
    uint32_t bt[2];
    ldsm_x2_t(bt, smem_addr(tile + (N - 1) * 8));
    mma_bf16(acc[N - 1], a, bt[0], bt[1]);
  }
}

// the P^T or P and dS fragments of a warp's 16 x N * 8 scores: row r of
// the fragment at `row0 + r`, column c at `col0 + c` of the block's tile;
// `p_of(row, col, s)` is the probability (0 where masked) and `d_of` the
// D subtracted.  P (when p_out is not null) and dS go to shared memory as
// bf16, rows `stride` apart
template <int N, typename PF, typename DF>
__device__ __forceinline__ void scores_to_smem(
    float (*s)[4], float (*dp)[4], int row0, int col0, bf16* p_out,
    bf16* ds_out, int stride, PF p_of, DF d_of) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int r = row0 + g + (e >> 1) * 8;
      const int c = col0 + j * 8 + tig * 2;
      float pv[2], dsv[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        pv[x] = p_of(r, c + x, s[j][e + x]);
        dsv[x] = pv[x] * (dp[j][e + x] - d_of(r, c + x));
      }
      if (p_out != nullptr)
        *reinterpret_cast<__nv_bfloat162*>(p_out + r * stride + c) =
            __floats2bfloat162_rn(pv[0], pv[1]);
      *reinterpret_cast<__nv_bfloat162*>(ds_out + r * stride + c) =
          __floats2bfloat162_rn(dsv[0], dsv[1]);
    }
}

// a warp's 16 x N * 8 fp32 fragments times `mul`, as bf16 into rows of
// `out` (`stride` apart) from `row0` (at most `n_rows` of them) and columns
// from `col0`
template <int N>
__device__ __forceinline__ void store_frags(float (*acc)[4], bf16* out,
                                            int64_t stride, int row0,
                                            int n_rows, int col0, float mul) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + half * 8;
    if (r >= n_rows) continue;
#pragma unroll
    for (int j = 0; j < N; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + r * stride + col0 + j * 8
                                         + tig * 2) =
          __floats2bfloat162_rn(acc[j][2 * half] * mul,
                                acc[j][2 * half + 1] * mul);
  }
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
bwd_dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int S, int Tk, int H, int KV,
                     int causal) {
  constexpr int WC = col_warps(DK, DV);
  constexpr int BK = 64 / WC;          // keys a block, 16 a warp row
  constexpr int DKP = pad16(DK), DVP = pad16(DV);
  constexpr int KP = DKP + 8, VP = DVP + 8, PP = kStep + 8;
  constexpr int NS = kStep / WC / 8;   // score n-tiles a warp
  constexpr int NK = DK / WC / 8, NV = DV / WC / 8;
  static_assert(DK % (8 * WC) == 0 && DV % (8 * WC) == 0, "column split");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [BK][KP]
  bf16* v_s = k_s + BK * KP;                      // [BK][VP]
  bf16* q_s = v_s + BK * VP;                      // [kStep][KP]
  bf16* do_s = q_s + kStep * KP;                  // [kStep][VP]
  bf16* p_s = do_s + kStep * VP;                  // [BK][PP]  P^T
  bf16* ds_s = p_s + BK * PP;                     // [BK][PP]  dS^T
  float* lse_s = reinterpret_cast<float*>(ds_s + BK * PP);  // log2 units
  float* d_s = lse_s + kStep;

  const int b = blockIdx.y / KV, kvh = blockIdx.y % KV;
  const int G = H / KV;
  const int k0 = blockIdx.x * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp / WC, wc = warp % WC;
  const int64_t q_stride = (int64_t)H * DK, o_stride = (int64_t)H * DV;
  const int64_t k_stride = (int64_t)KV * DK, v_stride = (int64_t)KV * DV;
  const bf16* kb = k + ((int64_t)b * Tk * KV + kvh) * DK;
  const bf16* vb = v + ((int64_t)b * Tk * KV + kvh) * DV;
  const float sl2 = kLog2e / sqrtf((float)DK);

  load_tile<DK, DKP, BK, kThreads>(k_s, kb + k0 * k_stride, k_stride,
                                   Tk - k0);
  load_tile<DV, DVP, BK, kThreads>(v_s, vb + k0 * v_stride, v_stride,
                                   Tk - k0);
  cp_async_commit();

  float acc_k[NK][4], acc_v[NV][4];
#pragma unroll
  for (int j = 0; j < NK; ++j)
    acc_k[j][0] = acc_k[j][1] = acc_k[j][2] = acc_k[j][3] = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j)
    acc_v[j][0] = acc_v[j][1] = acc_v[j][2] = acc_v[j][3] = 0.f;

  // ldmatrix lane offsets: A rows lane % 16, column half lane / 16; B (two
  // n-tiles) rows lane % 8 + 8 * (lane / 16), column half (lane / 8) % 2;
  // transposed B k-rows lane % 8 + 8 * ((lane / 8) % 2), column half
  // lane / 16
  const int a_row = wr * 16 + lane % 16, a_col = (lane / 16) * 8;
  const int b_row = lane % 8 + 8 * (lane / 16), b_col = ((lane / 8) % 2) * 8;
  const int t_row = lane % 8 + 8 * ((lane / 8) % 2), t_col = (lane / 16) * 8;
  const int qc0 = wc * (kStep / WC);   // this warp's queries in a step
  const int ck0 = wc * (DK / WC), cv0 = wc * (DV / WC);
  const auto d_of = [&](int, int c) { return d_s[c]; };

  // the first query tile that sees key k0 (the mask is s >= t)
  const int q_begin = causal ? k0 / kStep * kStep : 0;
  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const bf16* qb = q + ((int64_t)b * S * H + h) * DK;
    const bf16* dob = dout + ((int64_t)b * S * H + h) * DV;
    const float* lseb = lse + ((int64_t)b * H + h) * S;
    const float* db = delta + ((int64_t)b * H + h) * S;
    for (int q0 = q_begin; q0 < S; q0 += kStep) {
      __syncthreads();                 // the last step's readers are done
      load_tile<DK, DKP, kStep, kThreads>(q_s, qb + q0 * q_stride, q_stride,
                                          S - q0);
      load_tile<DV, DVP, kStep, kThreads>(do_s, dob + q0 * o_stride,
                                          o_stride, S - q0);
      cp_async_commit();
      for (int r = threadIdx.x; r < kStep; r += kThreads) {
        const bool ok = q0 + r < S;
        lse_s[r] = ok ? lseb[q0 + r] * kLog2e : 0.f;
        d_s[r] = ok ? db[q0 + r] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();
      // S^T = K Q^T and dP^T = V dO^T: 16 keys x kStep / WC queries a warp
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      }
      mma_nt<NS, DKP>(s, k_s + a_row * KP + a_col,
                      q_s + (qc0 + b_row) * KP + b_col, KP);
      mma_nt<NS, DVP>(dp, v_s + a_row * VP + a_col,
                      do_s + (qc0 + b_row) * VP + b_col, VP);
      const auto p_of = [&](int r, int c, float sc) {
        const int kpos = k0 + r, qpos = q0 + c;
        const bool ok = kpos < Tk && qpos < S && (!causal || qpos >= kpos);
        return ok ? exp2f(fmaf(sc, sl2, -lse_s[c])) : 0.f;
      };
      scores_to_smem<NS>(s, dp, wr * 16, qc0, p_s, ds_s, PP, p_of, d_of);
      __syncthreads();
      // dV += P^T dO and dK += dS^T Q over the step's queries
#pragma unroll
      for (int kk = 0; kk < kStep / 16; ++kk) {
        uint32_t ap[4], ad[4];
        ldsm_x4(ap, smem_addr(p_s + a_row * PP + a_col + kk * 16));
        ldsm_x4(ad, smem_addr(ds_s + a_row * PP + a_col + kk * 16));
        mma_nn<NV>(acc_v, ap, do_s + (kk * 16 + t_row) * VP + t_col + cv0);
        mma_nn<NK>(acc_k, ad, q_s + (kk * 16 + t_row) * KP + t_col + ck0);
      }
    }
  }
  const int n_keys = Tk - k0;          // rows of this block that exist
  store_frags<NK>(acc_k, dk + ((int64_t)b * Tk + k0) * k_stride + kvh * DK,
                  k_stride, wr * 16, n_keys, ck0, 1.f / sqrtf((float)DK));
  store_frags<NV>(acc_v, dv + ((int64_t)b * Tk + k0) * v_stride + kvh * DV,
                  v_stride, wr * 16, n_keys, cv0, 1.f);
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int S, int Tk, int H, int KV, int causal) {
  constexpr int WC = col_warps(DK, DV);
  constexpr int BQ = 64 / WC;          // queries a block, 16 a warp row
  constexpr int DKP = pad16(DK), DVP = pad16(DV);
  constexpr int KP = DKP + 8, VP = DVP + 8, PP = kStep + 8;
  constexpr int NS = kStep / WC / 8;   // score n-tiles a warp
  constexpr int NQ = DK / WC / 8;
  static_assert(DK % (8 * WC) == 0, "column split");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [BQ][KP]
  bf16* do_s = q_s + BQ * KP;                     // [BQ][VP]
  bf16* k_s = do_s + BQ * VP;                     // [kStep][KP]
  bf16* v_s = k_s + kStep * KP;                   // [kStep][VP]
  bf16* ds_s = v_s + kStep * VP;                  // [BQ][PP]
  float* lse_s = reinterpret_cast<float*>(ds_s + BQ * PP);  // log2 units
  float* d_s = lse_s + BQ;

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  // the longest causal rows first, so that short ones fill the tail
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp / WC, wc = warp % WC;
  const int64_t q_stride = (int64_t)H * DK, o_stride = (int64_t)H * DV;
  const int64_t k_stride = (int64_t)KV * DK, v_stride = (int64_t)KV * DV;
  const bf16* qb = q + ((int64_t)b * S * H + h) * DK;
  const bf16* dob = dout + ((int64_t)b * S * H + h) * DV;
  const bf16* kb = k + ((int64_t)b * Tk * KV + kvh) * DK;
  const bf16* vb = v + ((int64_t)b * Tk * KV + kvh) * DV;
  const float sl2 = kLog2e / sqrtf((float)DK);

  load_tile<DK, DKP, BQ, kThreads>(q_s, qb + q0 * q_stride, q_stride,
                                   S - q0);
  load_tile<DV, DVP, BQ, kThreads>(do_s, dob + q0 * o_stride, o_stride,
                                   S - q0);
  cp_async_commit();
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const int64_t at = ((int64_t)b * H + h) * S + q0 + r;
    lse_s[r] = q0 + r < S ? lse[at] * kLog2e : 0.f;
    d_s[r] = q0 + r < S ? delta[at] : 0.f;
  }

  float acc[NQ][4];
#pragma unroll
  for (int j = 0; j < NQ; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int a_row = wr * 16 + lane % 16, a_col = (lane / 16) * 8;
  const int b_row = lane % 8 + 8 * (lane / 16), b_col = ((lane / 8) % 2) * 8;
  const int t_row = lane % 8 + 8 * ((lane / 8) % 2), t_col = (lane / 16) * 8;
  const int kc0 = wc * (kStep / WC);   // this warp's keys in a step
  const int cq0 = wc * (DK / WC);
  const auto d_of = [&](int r, int) { return d_s[r]; };

  const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += kStep) {
    __syncthreads();                   // the last step's readers are done
    load_tile<DK, DKP, kStep, kThreads>(k_s, kb + k0 * k_stride, k_stride,
                                        Tk - k0);
    load_tile<DV, DVP, kStep, kThreads>(v_s, vb + k0 * v_stride, v_stride,
                                        Tk - k0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // S = Q K^T and dP = dO V^T: 16 queries x kStep / WC keys a warp
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
    mma_nt<NS, DKP>(s, q_s + a_row * KP + a_col,
                    k_s + (kc0 + b_row) * KP + b_col, KP);
    mma_nt<NS, DVP>(dp, do_s + a_row * VP + a_col,
                    v_s + (kc0 + b_row) * VP + b_col, VP);
    const auto p_of = [&](int r, int c, float sc) {
      const int qpos = q0 + r, kpos = k0 + c;
      const bool ok = kpos < Tk && qpos < S && (!causal || qpos >= kpos);
      return ok ? exp2f(fmaf(sc, sl2, -lse_s[r])) : 0.f;
    };
    scores_to_smem<NS>(s, dp, wr * 16, kc0, nullptr, ds_s, PP, p_of, d_of);
    __syncthreads();
    // dQ += dS K over the step's keys
#pragma unroll
    for (int kk = 0; kk < kStep / 16; ++kk) {
      uint32_t ad[4];
      ldsm_x4(ad, smem_addr(ds_s + a_row * PP + a_col + kk * 16));
      mma_nn<NQ>(acc, ad, k_s + (kk * 16 + t_row) * KP + t_col + cq0);
    }
  }
  store_frags<NQ>(acc, dq + ((int64_t)b * S + q0) * q_stride + h * DK,
                  q_stride, wr * 16, S - q0, cq0, 1.f / sqrtf((float)DK));
}

// ------------------------------------------------------------------ launch
// the forward's FLASH_PAIRS (csrc/flash_attention.cu)
#define FLASH_PAIRS(X) \
  X(8, 8) X(16, 16) X(24, 16) X(32, 32) X(64, 64) X(80, 80) X(128, 128) \
  X(192, 128) X(256, 256)

template <typename K>
int configure(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DK, int DV>
int smem_bytes(int is_bf16, int dkdv) {
  if (is_bf16) return dkdv ? bf16_smem_bytes<DK, DV>(true)
                        : bf16_smem_bytes<DK, DV>(false);
  return (int)sizeof(float) * (dkdv ? f32_dkdv_floats<DK, DV>()
                                    : f32_dq_floats<DK, DV>());
}

template <int DK, int DV>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk,
           void* dv, int B, int S, int Tk, int H, int KV, int causal,
           int is_bf16, cudaStream_t stream) {
  const int kv_bytes = smem_bytes<DK, DV>(is_bf16, 1);
  const int q_bytes = smem_bytes<DK, DV>(is_bf16, 0);
  if (is_bf16) {
    constexpr int R = 64 / col_warps(DK, DV);
    static const int configured =
        configure(bwd_dkdv_bf16_kernel<DK, DV>, kv_bytes)
        | configure(bwd_dq_bf16_kernel<DK, DV>, q_bytes);
    if (configured != 0) return configured;
    bwd_dkdv_bf16_kernel<DK, DV>
        <<<dim3((Tk + R - 1) / R, B * KV), kThreads, kv_bytes, stream>>>(
            (const bf16*)q, (const bf16*)k, (const bf16*)v,
            (const bf16*)dout, lse, delta, (bf16*)dk, (bf16*)dv, S, Tk, H,
            KV, causal);
    bwd_dq_bf16_kernel<DK, DV>
        <<<dim3((S + R - 1) / R, B * H), kThreads, q_bytes, stream>>>(
            (const bf16*)q, (const bf16*)k, (const bf16*)v,
            (const bf16*)dout, lse, delta, (bf16*)dq, S, Tk, H, KV, causal);
  } else {
    static const int configured =
        configure(bwd_dkdv_f32_kernel<DK, DV>, kv_bytes)
        | configure(bwd_dq_f32_kernel<DK, DV>, q_bytes);
    if (configured != 0) return configured;
    bwd_dkdv_f32_kernel<DK, DV>
        <<<dim3((Tk + kF32Rows - 1) / kF32Rows, B * KV), kThreads, kv_bytes,
           stream>>>((const float*)q, (const float*)k, (const float*)v,
                     (const float*)dout, lse, delta, (float*)dk, (float*)dv,
                     S, Tk, H, KV, causal);
    bwd_dq_f32_kernel<DK, DV>
        <<<dim3((S + kF32Rows - 1) / kF32Rows, B * H), kThreads, q_bytes,
           stream>>>((const float*)q, (const float*)k, (const float*)v,
                     (const float*)dout, lse, delta, (float*)dq, S, Tk, H, KV,
                     causal);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// D = rowsum(dO * o) [B, H, S] fp32 from o, dO [B, S, H, DV] (is_bf16 != 0:
// bfloat16, else float32).  Returns a CUDA error code.
int flash_attention_bwd_delta(const void* o, const void* dout, void* delta,
                              int B, int S, int H, int DV, int is_bf16,
                              void* stream) {
  const int rows = B * S * H;
  const dim3 grid((rows + kThreads / 32 - 1) / (kThreads / 32));
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    bwd_delta_kernel<bf16><<<grid, kThreads, 0, st>>>(
        (const bf16*)o, (const bf16*)dout, (float*)delta, rows, S, H, DV);
  else
    bwd_delta_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float*)o, (const float*)dout, (float*)delta, rows, S, H, DV);
  return (int)cudaGetLastError();
}

// dq [B, S, H, DK], dk [B, T, KV, DK], dv [B, T, KV, DV] in the inputs'
// type from q, k, v, dO (the forward's layouts), the forward's lse and D
// (fp32 [B, H, S]); all contiguous and 16-byte aligned, H a multiple of
// KV.  Two launches: dK/dV, then dQ.  Returns a CUDA error code;
// cudaErrorInvalidValue for a (DK, DV) outside FLASH_PAIRS.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, void* dk, void* dv, int B, int S, int T,
                        int H, int KV, int DK, int DV, int causal, int is_bf16,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define FLASH_CASE(dk_, dv_)                                               \
  if (DK == dk_ && DV == dv_)                                              \
    return launch<dk_, dv_>(q, k, v, dout, (const float*)lse,              \
                            (const float*)delta, dq, dk, dv, B, S, T, H, KV, \
                            causal, is_bf16, st);
  FLASH_PAIRS(FLASH_CASE)
#undef FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory a block of the dK/dV (dkdv != 0) or the dQ
// kernel takes at (DK, DV) (0 for a pair outside FLASH_PAIRS).
int flash_attention_bwd_smem_bytes(int DK, int DV, int is_bf16, int dkdv) {
#define FLASH_CASE(dk_, dv_) \
  if (DK == dk_ && DV == dv_) return smem_bytes<dk_, dv_>(is_bf16, dkdv);
  FLASH_PAIRS(FLASH_CASE)
#undef FLASH_CASE
  return 0;
}

}  // extern "C"
