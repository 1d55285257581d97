// Blocked online-softmax attention (FlashAttention) for Hopper (sm_90a),
// plain C interface.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py:
// flash_attention_kernel, the Pallas kernel whose grid walks (head, query
// block, key block) with the key blocks in order and keeps the running max,
// sum and accumulator of one query block in VMEM scratch.
//
// Computes, for every batch row b, query head h and query position s:
// softmax(q[b, s, h] . k[b, t, h / G] * scale) over the keys t (all T
// of them, or t <= s when causal) applied to v[b, t, h / G], with G = H / KV
// query heads per KV head.  Keys are DK wide and values DV wide (MLA's
// decompressed heads take DK = nope + rope and DV = v_head).  Scores,
// softmax and the value sum accumulate in fp32 (bf16 probabilities enter
// the value sum, as in SDPA's flash backend); the output is written in the
// input type.  Masked keys are skipped, which equals the
// Pallas kernel's exp(-1e30 - m) = 0: every causal row sees key 0 in its
// first key tile, so its running max is finite from then on.  S and T need
// not be multiples of the tiles: rows and keys past them are bounds-checked.
//
// Layout: q [B, S, H, DK], k [B, T, KV, DK], v [B, T, KV, DV], out
// [B, S, H, DV], all contiguous (the models' own layout, so no transposes
// around the call).  The Pallas layout [BH, S, d] is the case H = KV = 1.
// The (DK, DV) pairs instantiated are FLASH_PAIRS below: every pair the
// model zoo's configs reach.  The scale is the caller's (1/sqrt(d) of its
// own key width), so the wrapper can run any (d, dv) up to 256 on the
// smallest pair that covers it, with q and k zero-padded to DK and v to
// DV, and slice the output back: zero key columns leave q.k unchanged
// and zero value columns only add output columns.  For training, the caller may also ask for
// each row's log-sum-exp lse [B, H, S] (fp32, natural units), which the
// backward (csrc/flash_attention_bwd.cu) uses to recompute the
// probabilities; the output does not change.
//
// Bound: operations.  Causal attention does 2 * S * T * (DK + DV) / 2
// flops a head against S * (DK + DV) + T * (DK + DV) elements moved,
// hundreds of flops a byte at the prefill shapes.
//
// Design, bfloat16 (the models' prefill type): FlashAttention-2 on the
// tensor cores.  One block of 4 warps per (query tile of 64 rows, batch row
// x head); each warp owns 16 query rows.  Q and double-buffered K/V tiles
// sit in shared memory as bf16, rows padded by 16 bytes so that ldmatrix
// meets no bank conflict; K/V tiles are copied with 16-byte cp.async while
// the previous tile is computed, rows past S or T zero-filled.  S = Q K^T
// runs on mma.sync.m16n8k16 (bf16 in, fp32 accumulate) and stays in
// registers, where the online softmax works on the accumulator fragments
// (row max and sum across the quad of a row by shuffles); P is rounded to
// bf16 in registers and fed as the A operand of P V, with V read by
// ldmatrix.trans; O is an fp32 register accumulator rescaled per tile.
// Causal blocks stop at the diagonal and mask only the tiles that cross
// it.  DV 256 takes key tiles of 32 to keep O (128 fp32 registers a
// thread) and S in registers.  The m16n8k16 products contract 16 key
// columns a step, so a DK that is no multiple of 16 (8, 24) sits in
// shared memory zero-filled up to the next one (DKP), which leaves q.k
// unchanged.  P V tiles DV in steps of 8,
// the last one alone (ldmatrix x2) when DV / 8 is odd.  At (192, 128):
// Q 64 x 200, K 2 x 64 x 200 and V 2 x 64 x 136 bf16 are 111.6 KB of
// shared memory a block, O 64 and S 32 fp32 registers a thread.
//
// Design, float32 (the models' agreement checks): one block of 128 threads
// per (query tile of BQ rows, batch row x head) on the CUDA cores; it loops
// over the key tiles in order, up to the diagonal when causal.  Q, the K
// and V tiles, the probabilities and the output accumulator sit in shared
// memory as fp32 (padded rows against bank conflicts); each thread owns a
// BQ/16 x BK/8 block of scores with rows and columns interleaved (row
// rg + 16 i, column cg + 8 j) and the eight threads of a row reduce its
// max and sum with shuffles.  An fp32 input never goes through TF32: the
// reference's tolerance of 2e-5 rules it out.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// ----------------------------------------------------- fp32 on the CUDA cores
template <int DK, int DV, int BQ, int BK>
constexpr int smem_floats() {
  return BQ * (DK + 1) + BK * (DK + 1) + BK * (DV + 1) + BQ * (BK + 1)
         + BQ * DV + 3 * BQ;
}

template <typename T, int DK, int DV, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             float* __restrict__ lse, int S, int Tk, int H, int KV,
             int causal, float scale) {
  static_assert(BQ % 16 == 0 && BK % 8 == 0, "tile shape");
  constexpr int DP = DK + 1;
  constexpr int VP = DV + 1;
  constexpr int RQ = BQ / 16;          // score rows per thread
  constexpr int CK = BK / 8;           // score columns per thread
  constexpr int MC = 8;                // output columns per pass
  constexpr int NCOL = (DV + 7) / 8;   // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                   // [BQ][DP]
  float* k_s = q_s + BQ * DP;          // [BK][DP]
  float* v_s = k_s + BK * DP;          // [BK][VP]
  float* p_s = v_s + BK * VP;          // [BQ][BK + 1]
  float* o_s = p_s + BQ * (BK + 1);    // [BQ][DV]
  float* m_s = o_s + BQ * DV;          // [BQ] running max
  float* l_s = m_s + BQ;               // [BQ] running sum
  float* a_s = l_s + BQ;               // [BQ] this tile's rescale

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int rg = tid / 8, cg = tid % 8;
  const int64_t q_stride = (int64_t)H * DK;     // between query positions
  const int64_t o_stride = (int64_t)H * DV;
  const int64_t k_stride = (int64_t)KV * DK;    // between key positions
  const int64_t v_stride = (int64_t)KV * DV;
  const T* qb = q + ((int64_t)b * S * H + h) * DK;
  const T* kb = k + ((int64_t)b * Tk * KV + kvh) * DK;
  const T* vb = v + ((int64_t)b * Tk * KV + kvh) * DV;
  T* ob = out + ((int64_t)b * S * H + h) * DV;
  for (int i = tid; i < BQ * DK; i += kThreads) {
    const int r = i / DK, c = i % DK;
    q_s[r * DP + c] = q0 + r < S ? to_f32(qb[(q0 + r) * q_stride + c]) : 0.f;
  }
  for (int i = tid; i < BQ * DV; i += kThreads) o_s[i] = 0.f;
  for (int r = tid; r < BQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  const int kv_end = causal ? min(Tk, q0 + BQ) : Tk;
  const int n_tiles = (kv_end + BK - 1) / BK;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();                   // the last tile's readers are done
    for (int i = tid; i < BK * DK; i += kThreads) {
      const int r = i / DK, c = i % DK;
      k_s[r * DP + c] =
          k0 + r < Tk ? to_f32(kb[(k0 + r) * k_stride + c]) : 0.f;
    }
    for (int i = tid; i < BK * DV; i += kThreads) {
      const int r = i / DV, c = i % DV;
      v_s[r * VP + c] =
          k0 + r < Tk ? to_f32(vb[(k0 + r) * v_stride + c]) : 0.f;
    }
    __syncthreads();
    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < DK; ++c) {
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
          acc[i][m] = (c0 + m < NCOL && c < DV)
                          ? o_s[(rg + 16 * i) * DV + c] * alpha : 0.f;
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
          vv[m] = (c0 + m < NCOL && c < DV) ? v_s[j * VP + c] : 0.f;
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
          if (c0 + m < NCOL && c < DV) o_s[(rg + 16 * i) * DV + c] = acc[i][m];
        }
    }
  }
  __syncthreads();
  for (int i = tid; i < BQ * DV; i += kThreads) {
    const int r = i / DV, c = i % DV;
    if (q0 + r < S)
      store(ob + (q0 + r) * o_stride + c, o_s[i] / fmaxf(l_s[r], 1e-30f));
  }
  if (lse != nullptr)
    for (int r = tid; r < BQ && q0 + r < S; r += kThreads)
      lse[((int64_t)b * H + h) * S + q0 + r] =
          m_s[r] + logf(fmaxf(l_s[r], 1e-30f));
}

// ------------------------------------------------- bf16 on the tensor cores
constexpr int kRows = 64;              // query rows a block, 16 a warp

// a key row's width in shared memory: DK rounded up to the k-step of 16
__host__ __device__ constexpr int pad16(int d) { return (d + 15) / 16 * 16; }

template <int DK, int DV, int BK>
constexpr int bf16_smem_bytes() {
  // Q, two K and two V tiles, rows padded by 16 bytes
  return 2 * ((kRows + 2 * BK) * (pad16(DK) + 8) + 2 * BK * (DV + 8));
}

template <int DK, int DV, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out, float* __restrict__ lse,
                  int S, int Tk, int H, int KV, int causal,
                  float scale) {
  static_assert(DV % 8 == 0 && BK % 16 == 0, "tile shape");
  constexpr int DKP = pad16(DK);       // key columns, zero-filled past DK
  constexpr int DP = DKP + 8;          // padded Q/K row (16 bytes)
  constexpr int VP = DV + 8;           // padded V row
  constexpr int NS = BK / 8;           // score n-tiles a warp
  constexpr int NO = DV / 8;           // output n-tiles a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kRows * DP;        // [2][BK][DP]
  __nv_bfloat16* v_s = k_s + 2 * BK * DP;       // [2][BK][VP]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  // the longest causal tiles first, so that short ones fill the tail
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tig = lane % 4;       // mma row group, column pair
  const int64_t q_stride = (int64_t)H * DK;
  const int64_t k_stride = (int64_t)KV * DK;
  const int64_t v_stride = (int64_t)KV * DV;
  const __nv_bfloat16* qb = q + ((int64_t)b * S * H + h) * DK;
  const __nv_bfloat16* kb = k + ((int64_t)b * Tk * KV + kvh) * DK;
  const __nv_bfloat16* vb = v + ((int64_t)b * Tk * KV + kvh) * DV;
  // scores in log2 units: exp(x * scale) = exp2(x * sl2)
  const float sl2 = 1.4426950408889634f * scale;

  const int kv_end = causal ? min(Tk, q0 + kRows) : Tk;
  const int n_tiles = (kv_end + BK - 1) / BK;
  load_tile<DK, DKP, kRows, kThreads>(q_s, qb + q0 * q_stride, q_stride,
                                      S - q0);
  load_tile<DK, DKP, BK, kThreads>(k_s, kb, k_stride, Tk);
  load_tile<DV, DV, BK, kThreads>(v_s, vb, v_stride, Tk);
  cp_async_commit();

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 units
  float l[2] = {0.f, 0.f};              // this thread's part of the row sum
  const int row0 = q0 + warp * 16 + g;  // query position of row g

  // ldmatrix lane addresses: A (Q) rows lane % 16, column half lane / 16;
  // B (K) key lane % 8 + 8 * (lane / 16), column half (lane / 8) % 2; B^T
  // (V) key lane % 8 + 8 * ((lane / 8) % 2), column half lane / 16
  const uint32_t q_lane = smem_addr(q_s + (warp * 16 + lane % 16) * DP
                                    + (lane / 16) * 8);
  const int k_off = (lane % 8 + 8 * (lane / 16)) * DP + ((lane / 8) % 2) * 8;
  const int v_off = (lane % 8 + 8 * ((lane / 8) % 2)) * VP + (lane / 16) * 8;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int st = tile & 1;
    if (tile + 1 < n_tiles) {
      const int k0n = (tile + 1) * BK;
      load_tile<DK, DKP, BK, kThreads>(k_s + (st ^ 1) * BK * DP,
                                       kb + k0n * k_stride, k_stride,
                                       Tk - k0n);
      load_tile<DV, DV, BK, kThreads>(v_s + (st ^ 1) * BK * VP,
                                      vb + k0n * v_stride, v_stride,
                                      Tk - k0n);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = k_s + st * BK * DP;
    const __nv_bfloat16* vt = v_s + st * BK * VP;
    const int k0 = tile * BK;

    // S = Q K^T for this warp's 16 rows and the tile's BK keys
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DKP / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, q_lane + kk * 32);
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t bk[4];
        ldsm_x4(bk, smem_addr(kt + j * 8 * DP + k_off + kk * 16));
        mma_bf16(s[j], a, bk[0], bk[1]);
        mma_bf16(s[j + 1], a, bk[2], bk[3]);
      }
    }
    // mask the keys past T, and above the diagonal when causal
    if (k0 + BK > Tk || (causal && k0 + BK - 1 > q0 + warp * 16)) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + j * 8 + tig * 2 + (e & 1);
          const int qpos = row0 + (e >> 1) * 8;
          if (kpos >= Tk || (causal && kpos > qpos)) s[j][e] = -INFINITY;
        }
    }
    // online softmax on the fragments: rows g (e = 0, 1) and g + 8 (2, 3)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx * sl2);
      // a row whose keys are all masked so far keeps m = -inf: no NaN
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m[r] - m_use);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j][2 * r] = exp2f(fmaf(s[j][2 * r], sl2, -m_use));
        s[j][2 * r + 1] = exp2f(fmaf(s[j][2 * r + 1], sl2, -m_use));
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][2 * r] *= alpha;
        o[j][2 * r + 1] *= alpha;
      }
    }
    // O += P V: the score fragments of key tiles 2kk, 2kk + 1 are the A
    // fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j + 1 < NO; j += 2) {
        uint32_t bv[4];
        ldsm_x4_t(bv, smem_addr(vt + kk * 16 * VP + v_off + j * 8));
        mma_bf16(o[j], a, bv[0], bv[1]);
        mma_bf16(o[j + 1], a, bv[2], bv[3]);
      }
      if constexpr (NO % 2) {          // the last n-tile alone
        uint32_t bv[2];
        ldsm_x2_t(bv, smem_addr(vt + kk * 16 * VP + v_off + (NO - 1) * 8));
        mma_bf16(o[NO - 1], a, bv[0], bv[1]);
      }
    }
    __syncthreads();                   // this stage is refilled next
  }

  // row sums across the quad, the row's log-sum-exp (natural units) when
  // asked, then out = O / l in bf16
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qpos = row0 + r * 8;
    if (lse != nullptr && tig == 0 && qpos < S)
      lse[((int64_t)b * H + h) * S + qpos] =
          (m[r] + log2f(fmaxf(l[r], 1e-30f))) * 0.6931471805599453f;
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* ob = out + ((int64_t)b * S * H + h) * DV;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + r * 8;
    if (qpos >= S) continue;
    __nv_bfloat16* orow = ob + qpos * (int64_t)H * DV + tig * 2;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(o[j][2 * r] * l[r], o[j][2 * r + 1] * l[r]);
  }
}

// ------------------------------------------------------------------ launch
// every (DK, DV) the model zoo's configs reach (configs/registry.py, full
// and smoke; MLA's DK is nope + rope), and 32
#define FLASH_PAIRS(X) \
  X(8, 8) X(16, 16) X(24, 16) X(32, 32) X(64, 64) X(80, 80) X(128, 128) \
  X(192, 128) X(256, 256)

// tiles: bf16 keys a tile (query tiles are kRows); fp32 query and key tiles
constexpr int bf16_bk(int DV) { return DV == 256 ? 32 : 64; }
constexpr int f32_tile(int DK, int DV) {
  return DK >= 128 || DV >= 128 ? 32 : 64;
}

template <int DK, int DV>
int smem_bytes(int bf16) {
  constexpr int BT = f32_tile(DK, DV);
  return bf16 ? bf16_smem_bytes<DK, DV, bf16_bk(DV)>()
              : (int)sizeof(float) * smem_floats<DK, DV, BT, BT>();
}

template <typename K>
int configure(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DK, int DV>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int S, int Tk, int H, int KV, int causal,
           float scale, int bf16, cudaStream_t stream) {
  const int bytes = smem_bytes<DK, DV>(bf16);
  if (bf16) {
    constexpr int BK = bf16_bk(DV);
    static const int configured =
        configure(flash_bf16_kernel<DK, DV, BK>, bytes);
    if (configured != 0) return configured;
    const dim3 grid((S + kRows - 1) / kRows, B * H);
    flash_bf16_kernel<DK, DV, BK><<<grid, kThreads, bytes, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, (__nv_bfloat16*)out, lse, S, Tk, H, KV,
        causal, scale);
  } else {
    constexpr int BT = f32_tile(DK, DV);
    static const int configured =
        configure(flash_kernel<float, DK, DV, BT, BT>, bytes);
    if (configured != 0) return configured;
    const dim3 grid((S + BT - 1) / BT, B * H);
    flash_kernel<float, DK, DV, BT, BT><<<grid, kThreads, bytes, stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)out, lse,
        S, Tk, H, KV, causal, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, S, H, DK], k [B, T, KV, DK], v [B, T, KV, DV], out [B, S, H, DV],
// one type (bf16 != 0: bfloat16, else float32), contiguous and 16-byte
// aligned; H a multiple of KV.  lse, when not null, receives each row's
// fp32 log-sum-exp of the scaled scores, [B, H, S], for the backward
// (csrc/flash_attention_bwd.cu); out is the same either way.  Scores are
// q.k times `scale` (1/sqrt of the caller's key width).  Returns a CUDA
// error code; cudaErrorInvalidValue for a (DK, DV) outside FLASH_PAIRS.
int flash_attention(const void* q, const void* k, const void* v, void* out,
                    void* lse, int B, int S, int T, int H, int KV, int DK,
                    int DV, int causal, float scale, int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define FLASH_CASE(dk, dv)                                                \
  if (DK == dk && DV == dv)                                               \
    return launch<dk, dv>(q, k, v, out, (float*)lse, B, S, T, H, KV, causal, \
                          scale, bf16, st);
  FLASH_PAIRS(FLASH_CASE)
#undef FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory a block takes at (DK, DV) (0 for a pair
// outside FLASH_PAIRS).
int flash_attention_smem_bytes(int DK, int DV, int bf16) {
#define FLASH_CASE(dk, dv) \
  if (DK == dk && DV == dv) return smem_bytes<dk, dv>(bf16);
  FLASH_PAIRS(FLASH_CASE)
#undef FLASH_CASE
  return 0;
}

}  // extern "C"
