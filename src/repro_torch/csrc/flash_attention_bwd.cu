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
// dO [B, S, H, DV], with P = exp(q.k * scale - lse) over the keys a
// query sees (t <= s when causal, the plain version's top-left mask, or
// every key), scale the forward's (1/sqrt of the caller's key width, so
// that zero-padded q, k and v run on a larger pair, as the forward):
//   D  = rowsum(dO * o)                    fp32 [B, H, S]  (delta kernel)
//   dV = P^T dO,  dS = P * (dO V^T - D)
//   dK = dS^T q * scale                    (dK/dV kernel)
//   dQ = dS k * scale                      (dQ kernel)
// Query head h reads KV head h / G (G = H / KV); dK and dV sum over the G
// query heads of their KV head.  Every output element is written by one
// block, which owns its sum: no atomics, so the result is deterministic.
// The gradients are written in the inputs' type.  S and T need not be
// multiples of the tiles, and S may differ from T.
//
// Bound: operations.  2.5 times the forward's flops: the forward's S and
// P V products again, and dP, dK and dQ; at gemma-7b's training shape
// (B 4, H 16, S 2048, d 256, causal) 3.44e11 flop against ~0.13 GB moved,
// 0.347 ms at 989 TFLOP/s.
//
// Design, bfloat16 at the head dims that are whole 64-column boxes ((64,
// 64), (128, 128), (192, 128), (256, 256): the pairs that train on the
// card) -- Hopper's: wgmma (m64n64k16, bf16 in, fp32 sums), TMA and
// mbarriers (csrc/hopper.cuh).  Two kernels, dK/dV then dQ, each a block
// of three warpgroups: one thread of the producer group loads the
// block's resident rows and keeps 2-4 streamed 64-row tile pairs in
// flight in a ring of stages (4-D tensor maps of [B, S, H, d], boxes of
// 64 rows x 64 columns in the 128-byte swizzle that the products read;
// rows past S or T arrive as zeros), and hands its registers to the two
// consumer groups (setmaxnreg: 40 and 232 a thread).
//   Blocks are numbered in groups of 4 (batch row, head) pairs, tiles
//   first within a group and the longest first when causal, so that the
//   ~132 blocks in flight stream a few heads' tiles, which stay in the L2
//   (numbered tile first across all heads, gemma-7b's 128 MB of Q and dO
//   went to device memory: 1.43 against 1.24 ms).
//   dK/dV: a block per (64 keys, batch row, KV head); it holds K and V and
//   walks the G query heads of its KV head and each one's query tiles
//   from the first that sees its keys (masked tiles are never loaded).
//   Exchange mode: group 0 computes S^T = K Q^T and P^T (rounded to bf16
//   as the forward rounds P before its P V) and adds P^T dO into dV;
//   group 1 computes
//   dP^T = V dO^T, takes P^T from group 0 through a 16 KB fp32 buffer in
//   fragment order, forms dS^T = P^T (dP^T - D) and adds dS^T Q into dK.
//   The A operands of the sums come from registers, dV and dK stay in
//   registers (at d 256 128 a thread: why the groups split them), so the
//   block needs no atomics; 64 keys a block at every head dim (the
//   mma.sync design below would hold 16 at d 256), so Q and dO are read
//   from the L2 4x less.
//   dQ: a block per (query rows, batch row, head), the last rows first
//   when causal; it holds Q and dO and walks the key tiles up to the
//   diagonal.  Rows mode (up to d 192, where 128 resident rows and two
//   stages fit): 128 queries a block, each group owns 64 of them end to
//   end (S and dP back to back, P, dS, dQ += dS K), so K and V are read
//   half as often.  Exchange mode (d 256): 64 queries, group 0 computes S
//   and P, group 1 dP, they swap P and dP and each adds dS K into its
//   columns of dQ (split at a whole box so that the two are even).
//   Between products the groups are elementwise (P = 2^(s log2e / sqrt(d)
//   - lse), dS), and that pass is on the products' path: it takes P from
//   the MUFU's ex2.approx alone and applies the mask only to the tiles
//   that cross the diagonal or a ragged end (-inf before the one pass),
//   which took gemma-7b's backward from 1.25 to 1.05 ms.
//   dQ route: a separate kernel that recomputes S and dP (7 products where
//   5 suffice), chosen over summing dQ's partials in key-tile order inside
//   the dK/dV kernel: at d 256 a group holding dK (or dV) has no registers
//   left for a 64 x 256 fp32 partial, and a third consumer group does not
//   fit the register file; the dQ kernel is 0.43 of the backward's 1.05 ms
//   at gemma-7b's shape (tools/flash_bwd_variants.py, H100 80GB HBM3 at
//   700 W; SDPA's backward 1.12).  Every output element has one block and
//   one order of sums: the result is bit-equal run to run (and, in this
//   order, to the mma.sync design's on the timed shapes).
//
// Design, bfloat16 at the other pairs ((8, 8), (16, 16), (24, 16), (32,
// 32), (80, 80)): FlashAttention-2's backward on mma.sync.m16n8k16 (bf16
// in, fp32 sums), 4 warps a block.  The dK/dV kernel has a block per
// (batch row, KV head, key tile); it holds its K and V tiles in shared
// memory and walks the G query heads and their query tiles of 64 rows,
// from the first tile that sees its keys when causal: S^T = K Q^T and
// dP^T = V dO^T by warps of 16 keys x 64 / WC queries, P^T and dS^T
// rounded to bf16 into shared memory, then dV += P^T dO and dK += dS^T Q
// into fp32 register fragments, each warp 16 keys x DV / WC and DK / WC
// columns.  The dQ kernel mirrors it: a block per (batch row, head, query
// tile), the key tiles of 64 up to the diagonal when causal, dS to shared
// memory, dQ += dS K.  WC (warps across the columns) is 2 above d 64,
// else 1.  Operand rows are padded by 16 bytes so that ldmatrix meets no
// bank conflict; a head dim that is no multiple of 16 (8, 24) is
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

#include "hopper.cuh"

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
                    int causal, float scale) {
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
                  int S, int Tk, int H, int KV, int causal, float scale) {
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
// warp's dK and dV (or dQ) fragments stay within 64 columns each (this
// design's pairs reach d 80)
__host__ __device__ constexpr int col_warps(int DK, int DV) {
  return DK > 64 || DV > 64 ? 2 : 1;
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
                     int causal, float scale) {
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
  const float sl2 = kLog2e * scale;

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
                  k_stride, wr * 16, n_keys, ck0, scale);
  store_frags<NV>(acc_v, dv + ((int64_t)b * Tk + k0) * v_stride + kvh * DV,
                  v_stride, wr * 16, n_keys, cv0, 1.f);
}

template <int DK, int DV>
__global__ void __launch_bounds__(kThreads)
bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int S, int Tk, int H, int KV, int causal, float scale) {
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
  const float sl2 = kLog2e * scale;

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
                  q_stride, wr * 16, S - q0, cq0, scale);
}

// ------------------------------------------- bf16 on wgmma (Hopper's design)
// a block: two consumer warpgroups (warps 0-3, 4-7) and a producer
// warpgroup (8-11) of which one thread issues the loads; the producer gives
// its registers to the consumers (168 each at launch, 40 and 232 after)
constexpr int kWgThreads = 384;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kBox = 64 * 64;          // bf16 of a TMA box, 8 KB
constexpr int kGroupHeads = 4;         // (b, head) pairs a group of blocks
constexpr int kSmemLimit = 232448;     // an H100 block's shared memory

// the pairs on this design: head dims that are whole 64-column boxes
__host__ __device__ constexpr bool on_wgmma(int DK, int DV) {
  return DK % 64 == 0 && DV % 64 == 0;
}

// A block of the dK/dV (DQ false) or the dQ kernel holds its own rows
// resident (K and V of its keys, or Q and dO of its queries) and streams
// 64-row tile pairs of the other kind (Q and dO, or K and V) through
// kStages stages.  Rows mode (dQ, where two stages fit beside 128
// resident rows: up to d 192): 128 rows a block, each consumer warpgroup
// owns 64 of them end to end.  Exchange mode (dK/dV, whose dK and dV of
// 64 keys would not fit one group's registers above d 64, and dQ at d
// 256): 64 rows a block, the two groups split the products and pass P
// (and dP) through two 16 KB fp32 buffers.  1 KB of alignment slack and
// the mbarriers besides.
template <int DK, int DV, bool DQ>
struct WgPlan {
  static constexpr int kPair = 64 * (DK + DV) * 2;  // bytes of a tile pair
  static constexpr bool kRows = DQ && 1280 + 4 * kPair <= kSmemLimit;
  static constexpr int kRowsPerBlock = kRows ? 128 : 64;
  static constexpr int kXchg = kRows ? 0 : 2 * 64 * 64 * 4;
  static constexpr int kFixed =
      1024 + 256 + kRowsPerBlock / 64 * kPair + kXchg;
  static constexpr int kStages0 = (kSmemLimit - kFixed) / kPair;
  static constexpr int kStages = kStages0 > 4 ? 4 : kStages0;
  static constexpr int kSmem = kFixed + kStages * kPair;
  static_assert(kStages >= 2, "two stages at least");
};

// exchange mode's dQ: the first group's boxes of columns (the rest are the
// second's), whole boxes that even the two groups' products out
__host__ __device__ constexpr int dq_boxes0(int DV) { return DV / 2 / 64; }

// issues one warpgroup's 64 x 64 scores (S or dP, as `x`) from two
// K-major tiles of W columns, `a` resident and `b` a stage's, as a group
template <int W>
__device__ __forceinline__ void issue_scores(float (&x)[32], const bf16* a,
                                             const bf16* b) {
  const uint64_t da = kmajor_desc(a), db = kmajor_desc(b);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < W / 16; ++kk) {
    // box kk / 4 (8 KB, 512 in 16-byte units), 32 bytes a k-step within it
    const uint64_t off = (kk / 4) * 512 + (kk % 4) * 2;
    wgmma_ss(x, da + off, db + off, kk > 0);
  }
  wgmma_commit();
}

// the scores, waited for
template <int W>
__device__ __forceinline__ void scores(float (&x)[32], const bf16* a,
                                       const bf16* b) {
  issue_scores<W>(x, a, b);
  wgmma_wait<0>();
  fence_acc(x);
}

// acc[c] += a (64 x 64, A fragments of 4 k-steps) times columns
// 64 (C0 + c) .. of the MN-major tile `b` (k-rows 0..63)
template <int NC, int C0>
__device__ __forceinline__ void accumulate(float (&acc)[NC][32],
                                           const uint32_t (&a)[4][4],
                                           const bf16* b) {
  const uint64_t db = mnmajor_desc(b);
#pragma unroll
  for (int c = 0; c < NC; ++c) fence_acc(acc[c]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      // box C0 + c; 16 rows of 128 bytes a k-step
      wgmma_rs(acc[c], a[kk], db + (C0 + c) * 512 + kk * 128, 1);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < NC; ++c) fence_acc(acc[c]);
}

// fragment-order exchange: value v of warpgroup thread i at float
// (v / 4 * 128 + i) * 4 + v % 4, so that a warp's 16-byte stores and loads
// are contiguous
__device__ __forceinline__ void put_frag(float* buf, int i,
                                         const float (&x)[32]) {
#pragma unroll
  for (int v = 0; v < 32; v += 4)
    *reinterpret_cast<float4*>(buf + (v / 4 * 128 + i) * 4) =
        make_float4(x[v], x[v + 1], x[v + 2], x[v + 3]);
}
__device__ __forceinline__ void get_frag(const float* buf, int i,
                                         float (&x)[32]) {
#pragma unroll
  for (int v = 0; v < 32; v += 4) {
    const float4 f = *reinterpret_cast<const float4*>(buf + (v / 4 * 128 + i)
                                                      * 4);
    x[v] = f.x, x[v + 1] = f.y, x[v + 2] = f.z, x[v + 3] = f.w;
  }
}

template <int NC>
__device__ __forceinline__ void zero(float (&acc)[NC][32]) {
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int v = 0; v < 32; ++v) acc[c][v] = 0.f;
}

// a warpgroup's NC x 64 output columns from `col0`, times `mul`, as bf16
// into rows `row0 + r` (r < 64, row0 + r < n_rows) of `out`, `stride` apart
template <int NC>
__device__ __forceinline__ void store_acc(const float (&acc)[NC][32],
                                          bf16* out, int64_t stride,
                                          int row0, int n_rows, int col0,
                                          float mul, int i) {
  const int w = i / 32, g = i % 32 / 4, t = i % 4;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int v = 0; v < 32; v += 2) {
      const int r = 16 * w + g + 8 * ((v >> 1) & 1);
      if (row0 + r >= n_rows) continue;
      const int col = col0 + 64 * c + 8 * (v >> 2) + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(out + (row0 + r) * stride + col) =
          __floats2bfloat162_rn(acc[c][v] * mul, acc[c][v + 1] * mul);
    }
}

// whether the 64 x 64 scores of queries q0.. and keys k0.. are all kept:
// the same for every thread of a step; the others' masked scores are set
// to -inf, so that one pass of 2^(s sl2 - lse) gives P with zeros there
__device__ __forceinline__ bool inside(int q0, int k0, int S, int Tk,
                                       int causal) {
  return q0 + 63 < S && k0 + 63 < Tk && (!causal || q0 >= k0 + 63);
}

// What a block walks: its batch row, head (a KV head for dK/dV), first row
// and steps; step s streams rows 64 * step_tile(s) of head step_head(s).
// scale multiplies q.k (the forward's).
struct Walk {
  int b, head, row0, n_steps, n_q, i0, G;
  float scale;
  __device__ int step_head(int s, bool dq) const {
    return dq ? head / G : head * G + s / n_q;
  }
  __device__ int step_tile(int s, bool dq) const {
    return dq ? s : i0 + s % n_q;
  }
};

// Rows mode (dQ): a warpgroup owns the block's queries r0 .. r0 + 63 end
// to end: S = Q K^T and dP = dO V^T back to back, P, dS = P (dP - D),
// dQ += dS K.
template <int DK, int DV, int NST>
__device__ __forceinline__ void dq_rows_group(
    const bf16* xa, const bf16* xb, const bf16* ys, uint64_t* full,
    uint64_t* empty, const float* lse, const float* delta, bf16* dq,
    const Walk& wk, int r0, int S, int Tk, int H, int causal) {
  constexpr int NA = DK / 64, NB = DV / 64;
  const int i = threadIdx.x % 128, lane = threadIdx.x % 32;
  const int w = i / 32, g = lane / 4, t = lane % 4;
  const float sl2 = kLog2e * wk.scale;
  float acc[NA][32];
  zero(acc);
  float l2[2], dd[2];                  // this thread's rows' lse (log2), D
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int q = r0 + 16 * w + g + 8 * hh;
    const int64_t at = ((int64_t)wk.b * H + wk.head) * S + q;
    l2[hh] = q < S ? lse[at] * kLog2e : 0.f;
    dd[hh] = q < S ? delta[at] : 0.f;
  }
  for (int s = 0; s < wk.n_steps; ++s) {
    const int st = s % NST, k0 = 64 * s;
    const bf16* ya = ys + st * (NA + NB) * kBox;
    mbar_wait(&full[st], (s / NST) & 1);
    float x[32], y[32];
    issue_scores<DK>(x, xa, ya);
    issue_scores<DV>(y, xb, ya + NA * kBox);
    wgmma_wait<0>();
    fence_acc(x);
    fence_acc(y);
    if (!inside(r0, k0, S, Tk, causal)) {
#pragma unroll
      for (int v = 0; v < 32; ++v) {
        const int q = r0 + 16 * w + g + 8 * ((v >> 1) & 1);
        const int key = k0 + 8 * (v >> 2) + 2 * t + (v & 1);
        if (!(key < Tk && q < S && (!causal || q >= key)))
          x[v] = -INFINITY;
      }
    }
#pragma unroll
    for (int v = 0; v < 32; ++v) {
      const float p = ex2_approx(fmaf(x[v], sl2, -l2[(v >> 1) & 1]));
      y[v] = p * (y[v] - dd[(v >> 1) & 1]);
    }
    uint32_t a[4][4];
    acc_to_a(y, a);
    accumulate<NA, 0>(acc, a, ya);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }
  store_acc<NA>(acc, dq + (int64_t)wk.b * S * H * DK + wk.head * DK,
                (int64_t)H * DK, r0, S, 0, wk.scale, i);
}

// Exchange mode, dK/dV: the first group computes S^T = K Q^T and P^T,
// hands P^T to the second and adds P^T dO into dV; the second computes
// dP^T = V dO^T, dS^T = P^T (dP^T - D) and adds dS^T Q into dK.
template <int DK, int DV, int NST, bool FIRST>
__device__ __forceinline__ void dkdv_xchg_group(
    const bf16* xa, const bf16* xb, const bf16* ys, float* p_buf,
    uint64_t* full, uint64_t* empty, const float* lse, const float* delta,
    bf16* out, const Walk& wk, int S, int Tk, int H, int KV, int causal) {
  constexpr int NA = DK / 64, NB = DV / 64;
  constexpr int NC = FIRST ? NB : NA;
  const int i = threadIdx.x % 128, lane = threadIdx.x % 32;
  const int w = i / 32, g = lane / 4, t = lane % 4;
  const int k0 = wk.row0;
  const float sl2 = kLog2e * wk.scale;
  float acc[NC][32];                   // dV (first) or dK
  zero(acc);
  for (int s = 0; s < wk.n_steps; ++s) {
    const int st = s % NST;
    const int h = wk.step_head(s, false), q0 = 64 * wk.step_tile(s, false);
    // this thread's columns' lse (log2) or D
    const float* row = (FIRST ? lse : delta) + ((int64_t)wk.b * H + h) * S;
    float cv[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int q = q0 + 8 * j + 2 * t + c;
        cv[2 * j + c] = q < S ? row[q] * (FIRST ? kLog2e : 1.f) : 0.f;
      }
    const bf16* ya = ys + st * (NA + NB) * kBox;
    mbar_wait(&full[st], (s / NST) & 1);
    float x[32];
    if (FIRST) {
      scores<DK>(x, xa, ya);
      if (!inside(q0, k0, S, Tk, causal)) {
#pragma unroll
        for (int v = 0; v < 32; ++v) {
          const int key = k0 + 16 * w + g + 8 * ((v >> 1) & 1);
          const int q = q0 + 8 * (v >> 2) + 2 * t + (v & 1);
          if (!(key < Tk && q < S && (!causal || q >= key)))
            x[v] = -INFINITY;
        }
      }
#pragma unroll
      for (int v = 0; v < 32; ++v)
        x[v] = ex2_approx(fmaf(x[v], sl2, -cv[2 * (v >> 2) + (v & 1)]));
      if (s > 0) named_sync(2, 256);  // step s - 1's P^T was read
      put_frag(p_buf, i, x);
      named_sync(1, 256);
    } else {
      scores<DV>(x, xb, ya + NA * kBox);
      if (s > 0) named_sync(2, 256);
      named_sync(1, 256);
      // dS^T = P^T (dP^T - D), P^T four values at a time from the buffer
#pragma unroll
      for (int v = 0; v < 32; v += 4) {
        const float4 p = *reinterpret_cast<const float4*>(
            p_buf + (v / 4 * 128 + i) * 4);
        const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[v + e] = pv[e] * (x[v + e] - cv[2 * (v >> 2) + (e & 1)]);
      }
    }
    uint32_t a[4][4];
    acc_to_a(x, a);
    accumulate<NC, 0>(acc, a, FIRST ? ya + NA * kBox : ya);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }
  const int64_t stride = (int64_t)KV * (FIRST ? DV : DK);
  store_acc<NC>(acc, out + (int64_t)wk.b * Tk * stride
                         + wk.head * (FIRST ? DV : DK),
                stride, k0, Tk, 0, FIRST ? 1.f : wk.scale, i);
}

// Exchange mode, dQ: the first group computes S = Q K^T and P, the second
// dP = dO V^T; they swap P and dP through `xch`, and each forms
// dS = P (dP - D) and adds dS K into NC boxes of dQ's columns from box
// COFF
template <int DK, int DV, int NST, int NC, int COFF, bool FIRST>
__device__ __forceinline__ void dq_xchg_group(
    const bf16* xa, const bf16* xb, const bf16* ys, float* xch,
    uint64_t* full, uint64_t* empty, const float* lse, const float* delta,
    bf16* dq, const Walk& wk, int S, int Tk, int H, int causal) {
  constexpr int NA = DK / 64, NB = DV / 64;
  const int i = threadIdx.x % 128, lane = threadIdx.x % 32;
  const int w = i / 32, g = lane / 4, t = lane % 4;
  const int q0 = wk.row0, h = wk.head;
  const float sl2 = kLog2e * wk.scale;
  float l2[2], dd[2];                  // this thread's rows' lse (log2), D
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int q = q0 + 16 * w + g + 8 * hh;
    const int64_t at = ((int64_t)wk.b * H + h) * S + q;
    l2[hh] = q < S ? lse[at] * kLog2e : 0.f;
    dd[hh] = q < S ? delta[at] : 0.f;
  }
  float acc[NC > 0 ? NC : 1][32];
  zero(acc);
  float* mine = FIRST ? xch : xch + 64 * 64;
  const float* other = FIRST ? xch + 64 * 64 : xch;
  for (int s = 0; s < wk.n_steps; ++s) {
    const int st = s % NST, k0 = 64 * s;
    const bf16* ya = ys + st * (NA + NB) * kBox;
    mbar_wait(&full[st], (s / NST) & 1);
    float x[32], y[32];
    if (FIRST) {
      scores<DK>(x, xa, ya);
      if (!inside(q0, k0, S, Tk, causal)) {
#pragma unroll
        for (int v = 0; v < 32; ++v) {
          const int q = q0 + 16 * w + g + 8 * ((v >> 1) & 1);
          const int key = k0 + 8 * (v >> 2) + 2 * t + (v & 1);
          if (!(key < Tk && q < S && (!causal || q >= key)))
            x[v] = -INFINITY;
        }
      }
#pragma unroll
      for (int v = 0; v < 32; ++v)
        x[v] = ex2_approx(fmaf(x[v], sl2, -l2[(v >> 1) & 1]));
    } else {
      scores<DV>(x, xb, ya + NA * kBox);
    }
    if (s > 0) named_sync(2, 256);    // step s - 1's buffers were read
    put_frag(mine, i, x);
    named_sync(1, 256);
    get_frag(other, i, y);
    // dS = P (dP - D): x is P and y dP in the first group, the other way
    // round in the second
#pragma unroll
    for (int v = 0; v < 32; ++v) {
      const float pv = FIRST ? x[v] : y[v], dpv = FIRST ? y[v] : x[v];
      x[v] = pv * (dpv - dd[(v >> 1) & 1]);
    }
    if constexpr (NC > 0) {
      uint32_t a[4][4];
      acc_to_a(x, a);
      accumulate<NC, COFF>(acc, a, ya);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }
  if constexpr (NC > 0)
    store_acc<NC>(acc, dq + (int64_t)wk.b * S * H * DK + h * DK,
                  (int64_t)H * DK, q0, S, 64 * COFF, wk.scale, i);
}

// The dK/dV (DQ false) or dQ (DQ true) kernel of the bf16 design for
// Hopper.  dK/dV: a block per (key tile, batch row, KV head); it walks the
// G query heads of its KV head and each one's query tiles of 64 from the
// first that sees its keys.  dQ: a block per (query tile, batch row,
// head); it walks the key tiles of 64 up to the diagonal.  Blocks are
// numbered by groups of kGroupHeads (batch row, head) pairs, and within a
// group tile first, the longest first when causal.  The producer thread
// loads the block's resident rows, then keeps NST streamed tile pairs in
// flight.
template <int DK, int DV, bool DQ>
__global__ void __launch_bounds__(kWgThreads, 1)
bwd_wgmma_kernel(__grid_constant__ const CUtensorMap q_map,
                 __grid_constant__ const CUtensorMap k_map,
                 __grid_constant__ const CUtensorMap v_map,
                 __grid_constant__ const CUtensorMap do_map,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ out0,
                 bf16* __restrict__ out1, int B, int S, int Tk, int H,
                 int KV, int causal, float scale) {
  using Plan = WgPlan<DK, DV, DQ>;
  constexpr int NA = DK / 64, NB = DV / 64;   // boxes of a tile's two parts
  constexpr int NST = Plan::kStages, R = Plan::kRowsPerBlock;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  // resident rows, 64 at a time: (K, V) or (Q, dO) boxes
  bf16* res = reinterpret_cast<bf16*>(base);
  bf16* ys = res + R / 64 * (NA + NB) * kBox;  // stages: (Q, dO) or (K, V)
  float* xch = reinterpret_cast<float*>(ys + NST * (NA + NB) * kBox);
  uint64_t* full = reinterpret_cast<uint64_t*>(xch + Plan::kXchg / 4);
  uint64_t* empty = full + NST;
  uint64_t* res_full = empty + NST;

  Walk wk;
  wk.G = H / KV;
  wk.scale = scale;
  const int n_qt = (S + 63) / 64, n_kt = (Tk + 63) / 64;
  // (row tile, b * heads + head): heads in groups of kGroupHeads, so that
  // the blocks in flight stream few heads' tiles, which stay in the L2;
  // within a group the tiles are numbered first, the longest first when
  // causal (dK/dV's first tile, dQ's last)
  const int n_t = DQ ? (S + R - 1) / R : (Tk + R - 1) / R;
  const int n_bh = B * (DQ ? H : KV);
  const int group = blockIdx.x / (kGroupHeads * n_t);
  const int in_group = min(kGroupHeads, n_bh - group * kGroupHeads);
  const int rank = blockIdx.x % (kGroupHeads * n_t) / in_group;
  const int bh = group * kGroupHeads
                 + blockIdx.x % (kGroupHeads * n_t) % in_group;
  const int tile = DQ && causal ? n_t - 1 - rank : rank;
  wk.b = bh / (DQ ? H : KV);
  wk.head = bh % (DQ ? H : KV);
  wk.row0 = R * tile;
  if (!DQ) {                           // K and V of keys row0 ..
    wk.i0 = causal ? wk.row0 / 64 : 0; // the first query tile seeing a key
    wk.n_q = max(0, n_qt - wk.i0);
    wk.n_steps = wk.G * wk.n_q;
  } else {                             // Q and dO of queries row0 ..
    wk.i0 = 0;
    wk.n_q = 1;
    wk.n_steps = causal ? min((wk.row0 + R - 1) / 64 + 1, n_kt) : n_kt;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);         // a lane of each consumer warp
    }
    mbar_init(res_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {                     // ------------------------ producer
    reg_dealloc<kProducerRegs>();
    if (warp != 8 || lane != 0) return;
    const CUtensorMap* ra = DQ ? &q_map : &k_map;
    const CUtensorMap* rb = DQ ? &do_map : &v_map;
    const CUtensorMap* sa = DQ ? &k_map : &q_map;
    const CUtensorMap* sb = DQ ? &v_map : &do_map;
    mbar_expect_tx(res_full, R / 64 * Plan::kPair);
    for (int half = 0; half < R / 64; ++half) {
      bf16* dst = res + half * (NA + NB) * kBox;
      const int r = wk.row0 + 64 * half;
      for (int c = 0; c < NA; ++c)
        tma_load_4d(dst + c * kBox, ra, res_full, 64 * c, wk.head, r, wk.b);
      for (int c = 0; c < NB; ++c)
        tma_load_4d(dst + (NA + c) * kBox, rb, res_full, 64 * c, wk.head, r,
                    wk.b);
    }
    for (int s = 0; s < wk.n_steps; ++s) {
      const int st = s % NST;
      if (s >= NST) mbar_wait(&empty[st], (s / NST - 1) & 1);
      const int h = wk.step_head(s, DQ), r = 64 * wk.step_tile(s, DQ);
      bf16* ya = ys + st * (NA + NB) * kBox;
      mbar_expect_tx(&full[st], Plan::kPair);
      for (int c = 0; c < NA; ++c)
        tma_load_4d(ya + c * kBox, sa, &full[st], 64 * c, h, r, wk.b);
      for (int c = 0; c < NB; ++c)
        tma_load_4d(ya + (NA + c) * kBox, sb, &full[st], 64 * c, h, r, wk.b);
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  reg_alloc<kConsumerRegs>();
  const int wg = warp / 4;
  mbar_wait(res_full, 0);
  if constexpr (Plan::kRows) {
    const bf16* xa = res + wg * (NA + NB) * kBox;
    dq_rows_group<DK, DV, NST>(xa, xa + NA * kBox, ys, full, empty, lse,
                               delta, out0, wk, wk.row0 + 64 * wg, S, Tk, H,
                               causal);
  } else if constexpr (DQ) {
    constexpr int C0 = dq_boxes0(DV);
    if (wg == 0)
      dq_xchg_group<DK, DV, NST, C0, 0, true>(
          res, res + NA * kBox, ys, xch, full, empty, lse, delta, out0, wk,
          S, Tk, H, causal);
    else
      dq_xchg_group<DK, DV, NST, NA - C0, C0, false>(
          res, res + NA * kBox, ys, xch, full, empty, lse, delta, out0, wk,
          S, Tk, H, causal);
  } else {
    if (wg == 0)
      dkdv_xchg_group<DK, DV, NST, true>(res, res + NA * kBox, ys, xch, full,
                                         empty, lse, delta, out1, wk, S, Tk,
                                         H, KV, causal);
    else
      dkdv_xchg_group<DK, DV, NST, false>(res, res + NA * kBox, ys, xch,
                                          full, empty, lse, delta, out0, wk,
                                          S, Tk, H, KV, causal);
  }
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
  if (is_bf16) {
    if constexpr (on_wgmma(DK, DV))
      return dkdv ? WgPlan<DK, DV, false>::kSmem : WgPlan<DK, DV, true>::kSmem;
    else return dkdv ? bf16_smem_bytes<DK, DV>(true)
                     : bf16_smem_bytes<DK, DV>(false);
  }
  return (int)sizeof(float) * (dkdv ? f32_dkdv_floats<DK, DV>()
                                    : f32_dq_floats<DK, DV>());
}

// the wgmma design's two launches, each from the four tensors' TMA maps
template <int DK, int DV>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 void* dq, void* dk, void* dv, int B, int S, int Tk, int H,
                 int KV, int causal, float scale, cudaStream_t stream) {
  constexpr int kv_bytes = WgPlan<DK, DV, false>::kSmem;
  constexpr int q_bytes = WgPlan<DK, DV, true>::kSmem;
  constexpr int kv_rows = WgPlan<DK, DV, false>::kRowsPerBlock;
  constexpr int q_rows = WgPlan<DK, DV, true>::kRowsPerBlock;
  static const int configured =
      configure(bwd_wgmma_kernel<DK, DV, false>, kv_bytes)
      | configure(bwd_wgmma_kernel<DK, DV, true>, q_bytes);
  if (configured != 0) return configured;
  CUtensorMap qm, km, vm, om;
  int err = bf16_box_map(&qm, q, B, S, H, DK);
  if (err == 0) err = bf16_box_map(&km, k, B, Tk, KV, DK);
  if (err == 0) err = bf16_box_map(&vm, v, B, Tk, KV, DV);
  if (err == 0) err = bf16_box_map(&om, dout, B, S, H, DV);
  if (err != 0) return err;
  bwd_wgmma_kernel<DK, DV, false>
      <<<(Tk + kv_rows - 1) / kv_rows * B * KV, kWgThreads, kv_bytes,
         stream>>>(qm, km, vm, om, lse, delta, (bf16*)dk, (bf16*)dv, B, S,
                   Tk, H, KV, causal, scale);
  bwd_wgmma_kernel<DK, DV, true>
      <<<(S + q_rows - 1) / q_rows * B * H, kWgThreads, q_bytes, stream>>>(
          qm, km, vm, om, lse, delta, (bf16*)dq, nullptr, B, S, Tk, H, KV,
          causal, scale);
  return (int)cudaGetLastError();
}

template <int DK, int DV>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, void* dq, void* dk,
           void* dv, int B, int S, int Tk, int H, int KV, int causal,
           float scale, int is_bf16, cudaStream_t stream) {
  const int kv_bytes = smem_bytes<DK, DV>(is_bf16, 1);
  const int q_bytes = smem_bytes<DK, DV>(is_bf16, 0);
  if (is_bf16) {
    if constexpr (on_wgmma(DK, DV)) {
      return launch_wgmma<DK, DV>(q, k, v, dout, lse, delta, dq, dk, dv, B,
                                  S, Tk, H, KV, causal, scale, stream);
    } else {
      constexpr int R = 64 / col_warps(DK, DV);
      static const int configured =
          configure(bwd_dkdv_bf16_kernel<DK, DV>, kv_bytes)
          | configure(bwd_dq_bf16_kernel<DK, DV>, q_bytes);
      if (configured != 0) return configured;
      bwd_dkdv_bf16_kernel<DK, DV>
          <<<dim3((Tk + R - 1) / R, B * KV), kThreads, kv_bytes, stream>>>(
              (const bf16*)q, (const bf16*)k, (const bf16*)v,
              (const bf16*)dout, lse, delta, (bf16*)dk, (bf16*)dv, S, Tk, H,
              KV, causal, scale);
      bwd_dq_bf16_kernel<DK, DV>
          <<<dim3((S + R - 1) / R, B * H), kThreads, q_bytes, stream>>>(
              (const bf16*)q, (const bf16*)k, (const bf16*)v,
              (const bf16*)dout, lse, delta, (bf16*)dq, S, Tk, H, KV,
              causal, scale);
    }
  } else {
    static const int configured =
        configure(bwd_dkdv_f32_kernel<DK, DV>, kv_bytes)
        | configure(bwd_dq_f32_kernel<DK, DV>, q_bytes);
    if (configured != 0) return configured;
    bwd_dkdv_f32_kernel<DK, DV>
        <<<dim3((Tk + kF32Rows - 1) / kF32Rows, B * KV), kThreads, kv_bytes,
           stream>>>((const float*)q, (const float*)k, (const float*)v,
                     (const float*)dout, lse, delta, (float*)dk, (float*)dv,
                     S, Tk, H, KV, causal, scale);
    bwd_dq_f32_kernel<DK, DV>
        <<<dim3((S + kF32Rows - 1) / kF32Rows, B * H), kThreads, q_bytes,
           stream>>>((const float*)q, (const float*)k, (const float*)v,
                     (const float*)dout, lse, delta, (float*)dq, S, Tk, H, KV,
                     causal, scale);
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
// KV; scale the forward's.  Two launches: dK/dV, then dQ.  Returns a CUDA
// error code; cudaErrorInvalidValue for a (DK, DV) outside FLASH_PAIRS.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, void* dk, void* dv, int B, int S, int T,
                        int H, int KV, int DK, int DV, int causal, float scale,
                        int is_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define FLASH_CASE(dk_, dv_)                                               \
  if (DK == dk_ && DV == dv_)                                              \
    return launch<dk_, dv_>(q, k, v, dout, (const float*)lse,              \
                            (const float*)delta, dq, dk, dv, B, S, T, H, KV, \
                            causal, scale, is_bf16, st);
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

// The design that runs at (DK, DV) in the given type: 0 the CUDA cores
// (float32), 1 mma.sync, 2 wgmma; -1 for a pair outside FLASH_PAIRS.
int flash_attention_bwd_design(int DK, int DV, int is_bf16) {
#define FLASH_CASE(dk_, dv_) \
  if (DK == dk_ && DV == dv_) return is_bf16 ? (on_wgmma(dk_, dv_) ? 2 : 1) : 0;
  FLASH_PAIRS(FLASH_CASE)
#undef FLASH_CASE
  return -1;
}

}  // extern "C"
