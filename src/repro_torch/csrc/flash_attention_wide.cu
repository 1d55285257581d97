// Blocked online-softmax attention (K6) and its backward at any key and
// value width, for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py:
// flash_attention_kernel at the widths that no pair of
// csrc/flash_attention.cu covers (d or dv past 256).  The Pallas kernel's
// block specs take whole head widths, so it computes every width; this
// file is the port's route for the widths past the instantiated pairs,
// and for their gradient, as csrc/flash_attention_bwd.cu is for the
// pairs'.  One real width lives here: DeepSeek-V2's absorbed MLA, d 576
// (kv_lora_rank 512 + rope 64) and dv 512 over one shared KV head.
//
// Computes the function of csrc/flash_attention.cu (its header has the
// layouts: q [B, S, H, d], k [B, T, KV, d], v [B, T, KV, dv], out [B, S,
// H, dv], query head h reading KV head h / (H / KV), keys t <= s when
// causal) with d and dv run-time arguments, and the row log-sum-exp lse
// [B, H, S] (fp32, natural units) the backward reads; and, from dO and
// D = rowsum(dO o) (flash_attention_bwd_delta), the gradients of
// csrc/flash_attention_bwd.cu's header, written in fp32 (the wrapper
// rounds them to the inputs' type once).
//
// Bound: operations.  The forward does 2 S T (d + dv) flops a head (half
// when causal), the backward 2.5 times that; at (512, 512), 8 heads, B 4,
// S 2048, causal: 1.37e11 and 3.44e11 flop against ~0.1 GB moved, 0.139
// and 0.347 ms at 989 TFLOP/s.
//
// Design, bfloat16 -- Hopper's: wgmma (m64n64k16, bf16 in, fp32 sums), TMA
// and mbarriers (csrc/hopper.cuh), as csrc/flash_attention_bwd.cu's wgmma
// design, with every width cut into 64-column boxes.  A block is three
// warpgroups: one thread of the producer group loads boxes of 64 rows x 64
// bf16 columns (4-D tensor maps of [B, S, H, width], the 128-byte swizzle
// the products read; rows past S or T and columns past the width arrive
// as zeros) into a ring of 8 KB stages, and two consumer groups (setmaxnreg
// 232 a thread) take them in the order they were loaded.  In the forward
// every box has one reader and each group has a ring of its own; in the
// backward some boxes have two, and both groups wait for every stage of
// the one ring in order, releasing each once (8 arrivals a stage), those
// that do not read it as soon as it has arrived, so that no group runs
// two phases ahead of a stage.  A group's accumulator is at most four
// boxes (64 x 256 fp32, 128 registers a thread), so wide accumulators are
// cut into pieces and pieces into blocks.  Widths whose rows are not whole 16-byte chunks (d or dv not a
// multiple of 8) cannot be mapped by TMA: the wrapper zero-pads them
// outside the kernel (the caller's scale kept) and slices back.
//   Forward: a block per (64 query rows, batch row x head, value piece of
//   at most 8 boxes = 512 columns).  For each key tile of 64 (up to the
//   diagonal when causal) the two groups split S = Q K^T by d's boxes
//   (group g the boxes j = g mod 2, both operands K-major), swap their
//   partial S through two 16 KB fp32 buffers in fragment order and each
//   adds the other's: S is formed once a block and is bit-equal in both
//   groups (a + b = b + a).  Both then run the same online softmax
//   (2^x by ex2.approx, the mask only on tiles that cross the diagonal or
//   a ragged end), round P to bf16 (as csrc/flash_attention.cu does; the
//   row sum l takes P unrounded) and add P V into their own value boxes
//   (alternate boxes of the piece, V MN-major).  Past dv 512 each piece is
//   a block of its own and forms S again: score_work = pieces.  Q stays
//   in shared memory up to d 1024 (16 boxes beside an 8-stage ring);
//   wider, Q's boxes stream through the ring beside K's.  At (512, 512): Q
//   64 KB, 16 stages (128 KB), the exchange 32 KB.
//   Backward: the two kernels of csrc/flash_attention_bwd.cu's wgmma
//   design, on boxes.  Side a is the score product
//   S (over d's boxes), side b dP (over dv's); each side has resident rows
//   R (K, V of the block's keys in dK/dV; Q, dO of its queries in dQ) and
//   streamed rows (Q, dO; or K, V).  Group 0 forms side a's product, group
//   1 side b's, each box R_j S_j^T a wgmma from shared memory.
//     dK/dV: a block per (64 keys, batch row x KV head, piece pair): the
//     columns of dK and dV cut into the same number of pieces of at most
//     4 boxes; group 0 holds a dV piece, group 1 a dK piece.  It walks the
//     G query heads of its KV head and their query tiles from the first
//     that sees its keys; group 0 forms S^T and P^T = 2^(S^T sl2 - lse)
//     (rounded to bf16 for dV += P^T dO), hands P^T to group 1 through a
//     16 KB buffer, group 1 forms dP^T and dS^T = P^T (dP^T - D) for dK +=
//     dS^T Q.
//     dQ: a block per (64 queries, batch row x head, dQ piece of at most
//     8 boxes); group 0 forms S and P, group 1 dP, they swap them through
//     two buffers, each forms dS and adds dS K into its part of the
//     piece (split so that the two groups' products are even).
//   Gradients stay in registers (no atomics, no global read-modify-write)
//   and are written once in fp32: two runs are bit-equal.  The boxes a
//   piece sums with (dO's, Q's or K's) are the same stages the scores
//   read; they come last in a step's ring order and are released after
//   the sum, the others as soon as their product is done, so the ring
//   needs only as many stages as a step holds.  R rows stay resident
//   where they fit beside a ring that holds two stages more than that,
//   else they stream beside the others (side a first kept resident).
//   Score work (S and dP formed, over the two the function needs): the
//   pieces of dK/dV plus the pieces of dQ; 3 at (512, 512), where the
//   function's five products take nine.
//
// Design, float32 (the agreement route, as fp32 is for the <= 256
// backward) on the CUDA cores with fp32 sums (probabilities are not
// rounded before the value sum: the plain version's function).  The
// widths are walked, never held: a block stages 32 (or 64) columns of its
// operands at a time in shared memory, so no width is too wide.
//   Forward: a block of 256 threads per (32 query rows, batch row x head,
//   group of kGroup value columns).  For each key tile of 64 (up to the
//   diagonal when causal) it forms the 32 x 64 scores by walking d in
//   slabs of 32 columns of Q and K, each thread 8 scores of one row; the
//   online softmax runs on the row's 8 threads (shuffles); then the value
//   sum walks the group's columns in slabs of 64 of V, the accumulator
//   O [32][group] in shared memory.  Scores are recomputed by each group
//   of value columns: at dv past kGroup the q.k work is ceil(dv / kGroup)
//   times the function's.
//   Backward: a dK/dV kernel, a block per (32 keys, batch row x KV head)
//   that walks the G query heads of its KV head and their query tiles from
//   the first that sees its keys, and a dQ kernel, a block per (32 query
//   rows, batch row x head) that walks the key tiles.  Each forms S (d in
//   slabs), P = exp(S scale - lse), dP = dO V^T (dv in slabs) and dS = P
//   (dP - D) for its 32 x 32 tile, then adds P^T dO and dS^T q scale into
//   dV and dK, or dS k scale into dQ, 64 columns at a time, in fp32 rows
//   of global memory that the block owns (the L2 holds them): no atomics,
//   so the result is the same from run to run.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// ----------------------------------- float32 on the CUDA cores (agreement)
constexpr int kThreads = 256;
constexpr int kRows = 32;              // query rows a forward block
constexpr int kKeys = 64;              // keys a forward tile
constexpr int kSlab = 32;              // key-width columns a step of S
constexpr int kVSlab = 64;             // value columns a step of P V
constexpr int kGroup = 512;            // value columns a forward block
constexpr int kTile = 32;              // rows and keys a backward tile
constexpr float kNegInf = -1e30f;

using bf16 = __nv_bfloat16;

// the forward's dynamic shared memory for `cols` value columns a block
__host__ __device__ constexpr int fwd_smem_floats(int cols) {
  return kRows * (kSlab + 1) + kKeys * (kSlab + 1) + kRows * (kKeys + 1)
         + kKeys * kVSlab + kRows * cols + kRows;
}

// rows [r0, r0 + n) x columns [c0, c0 + w) of a row-major operand with
// row stride ld into dst [n][dld] as fp32, zeros outside (rows, cols)
__device__ __forceinline__ void stage(float* dst, int dld, const float* src,
                                      int64_t ld, int r0, int n, int rows,
                                      int c0, int w, int cols) {
  for (int i = threadIdx.x; i < n * w; i += kThreads) {
    const int r = i / w, c = i % w;
    dst[r * dld + c] = r0 + r < rows && c0 + c < cols
                           ? src[(int64_t)(r0 + r) * ld + c0 + c]
                           : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
wide_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ out,
                float* __restrict__ lse, int S, int Tk, int H, int KV, int d,
                int dv, int causal, float scale) {
  const int tiles = (S + kRows - 1) / kRows;
  const int bh = blockIdx.x / tiles;
  const int q0 = blockIdx.x % tiles * kRows;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int v0 = blockIdx.y * kGroup;
  const int cols = min(kGroup, dv - v0);
  extern __shared__ float smem[];
  float* q_s = smem;                               // [kRows][kSlab + 1]
  float* k_s = q_s + kRows * (kSlab + 1);          // [kKeys][kSlab + 1]
  float* p_s = k_s + kKeys * (kSlab + 1);          // [kRows][kKeys + 1]
  float* v_s = p_s + kRows * (kKeys + 1);          // [kKeys][kVSlab]
  float* o_s = v_s + kKeys * kVSlab;               // [kRows][cols]
  float* l_s = o_s + kRows * cols;                 // [kRows]

  const int tid = threadIdx.x;
  const int r = tid / 8, c0 = tid % 8;             // row r, keys c0 + 8 j
  const int64_t q_ld = (int64_t)H * d, k_ld = (int64_t)KV * d;
  const int64_t v_ld = (int64_t)KV * dv;
  const float* qb = q + (int64_t)b * S * q_ld + (int64_t)h * d;
  const float* kb = k + (int64_t)b * Tk * k_ld + (int64_t)kvh * d;
  const float* vb = v + (int64_t)b * Tk * v_ld + (int64_t)kvh * dv + v0;
  for (int i = tid; i < kRows * cols; i += kThreads) o_s[i] = 0.f;
  float m = kNegInf, l = 0.f;
  const int qpos = q0 + r;
  const int k_end = causal ? min(Tk, q0 + kRows) : Tk;

  for (int k0 = 0; k0 < k_end; k0 += kKeys) {
    float s[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = 0.f;
    for (int cs = 0; cs < d; cs += kSlab) {
      __syncthreads();                 // the previous slab is consumed
      stage(q_s, kSlab + 1, qb, q_ld, q0, kRows, S, cs, kSlab, d);
      stage(k_s, kSlab + 1, kb, k_ld, k0, kKeys, Tk, cs, kSlab, d);
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kSlab; ++kk) {
        const float qv = q_s[r * (kSlab + 1) + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[j] = fmaf(qv, k_s[(c0 + 8 * j) * (kSlab + 1) + kk], s[j]);
      }
    }
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = k0 + c0 + 8 * j;
      const bool ok = key < Tk && (!causal || key <= qpos);
      s[j] = ok ? s[j] * scale : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float mn = fmaxf(m, mx);
    const float alpha = expf(m - mn);
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p = s[j] == -INFINITY ? 0.f : expf(s[j] - mn);
      p_s[r * (kKeys + 1) + c0 + 8 * j] = p;
      ps += p;
    }
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      ps += __shfl_xor_sync(0xffffffffu, ps, off);
    l = l * alpha + ps;
    m = mn;
    // O = O alpha + P V over the group's columns, 64 at a time; thread
    // (r, c0) owns O's columns c0 + 8 j of row r
    for (int vs = 0; vs < cols; vs += kVSlab) {
      __syncthreads();                 // P written, the previous V consumed
      stage(v_s, kVSlab, vb, v_ld, k0, kKeys, Tk, vs, kVSlab, cols);
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + 8 * j;
        if (vs + c >= cols) continue;
        float o = o_s[r * cols + vs + c] * alpha;
#pragma unroll 8
        for (int kk = 0; kk < kKeys; ++kk)
          o = fmaf(p_s[r * (kKeys + 1) + kk], v_s[kk * kVSlab + c], o);
        o_s[r * cols + vs + c] = o;
      }
    }
  }
  if (c0 == 0) l_s[r] = l;
  if (lse != nullptr && blockIdx.y == 0 && c0 == 0 && qpos < S)
    lse[((int64_t)b * H + h) * S + qpos] = m + logf(fmaxf(l, 1e-30f));
  __syncthreads();
  float* ob = out + ((int64_t)b * S * H + h) * dv + v0;
  for (int i = tid; i < kRows * cols; i += kThreads) {
    const int rr = i / cols, c = i % cols;
    if (q0 + rr < S)
      ob[(int64_t)(q0 + rr) * H * dv + c] = o_s[i] / fmaxf(l_s[rr], 1e-30f);
  }
}

// ---------------------------------------------------------------- backward
// The backward's shared memory: two 32 x 32 operand slabs, P and dS
// [32][33] each, one 32 x 64 operand slab for the sums, lse and D
struct BwdSmem {
  float a[kTile * (kTile + 1)];
  float b[kTile * (kTile + 1)];
  float p[kTile * (kTile + 1)];
  float ds[kTile * (kTile + 1)];
  float w[kTile * 64];
  float lse[kTile];
  float dd[kTile];
};

// The tile's scores and gradients: thread (r = tid / 8, c0 = tid % 8)
// forms S[r][c0 + 8 j] (query r, key c0 + 8 j) from q rows q0.. and k rows
// k0.. walking d, dP likewise from dO and v walking dv, then P and dS
// into sm.p and sm.ds as [query][key].  lse and D of the 32 queries are
// in sm.lse and sm.dd.
__device__ __forceinline__ void tile_grads(
    BwdSmem& sm, const float* qb, int64_t q_ld, const float* kb, int64_t k_ld,
    const float* vb, int64_t v_ld, const float* gb, int64_t g_ld, int q0,
    int k0, int S, int Tk, int d, int dv, int causal, float scale) {
  const int tid = threadIdx.x, r = tid / 8, c0 = tid % 8;
  float s[4], dp[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) s[j] = dp[j] = 0.f;
  for (int cs = 0; cs < d; cs += kTile) {
    __syncthreads();
    stage(sm.a, kTile + 1, qb, q_ld, q0, kTile, S, cs, kTile, d);
    stage(sm.b, kTile + 1, kb, k_ld, k0, kTile, Tk, cs, kTile, d);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTile; ++kk) {
      const float a = sm.a[r * (kTile + 1) + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[j] = fmaf(a, sm.b[(c0 + 8 * j) * (kTile + 1) + kk], s[j]);
    }
  }
  for (int cs = 0; cs < dv; cs += kTile) {
    __syncthreads();
    stage(sm.a, kTile + 1, gb, g_ld, q0, kTile, S, cs, kTile, dv);
    stage(sm.b, kTile + 1, vb, v_ld, k0, kTile, Tk, cs, kTile, dv);
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kTile; ++kk) {
      const float a = sm.a[r * (kTile + 1) + kk];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dp[j] = fmaf(a, sm.b[(c0 + 8 * j) * (kTile + 1) + kk], dp[j]);
    }
  }
  const int qpos = q0 + r;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = k0 + c0 + 8 * j;
    const bool ok = qpos < S && key < Tk && (!causal || key <= qpos);
    const float p = ok ? expf(s[j] * scale - sm.lse[r]) : 0.f;
    sm.p[r * (kTile + 1) + c0 + 8 * j] = p;
    sm.ds[r * (kTile + 1) + c0 + 8 * j] = p * (dp[j] - sm.dd[r]);
  }
  __syncthreads();
}

// acc [32 rows of global fp32, ld apart] += coef * M^T X (trans) or M X,
// M [32][33] in shared memory (query x key), X 32 rows of an operand
// (row stride x_ld from x0) walked 64 columns at a time over `width`:
// thread (i = tid / 64, c = tid % 64) owns rows i + 4 n of each slab's
// column c.  Rows at or past `n_rows` of acc are not written.
__device__ __forceinline__ void add_product(
    BwdSmem& sm, const float* M, bool trans, float coef, float* acc,
    int64_t acc_ld, int n_rows, const float* x, int64_t x_ld, int x0,
    int x_rows, int width) {
  const int tid = threadIdx.x, i = tid / 64, c = tid % 64;
  for (int cs = 0; cs < width; cs += 64) {
    __syncthreads();
    stage(sm.w, 64, x, x_ld, x0, kTile, x_rows, cs, 64, width);
    __syncthreads();
    if (cs + c >= width) continue;
#pragma unroll
    for (int n = 0; n < kTile / 4; ++n) {
      const int row = i + 4 * n;
      if (row >= n_rows) continue;
      float sum = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < kTile; ++kk)
        sum = fmaf(trans ? M[kk * (kTile + 1) + row] : M[row * (kTile + 1) + kk],
                   sm.w[kk * 64 + c], sum);
      acc[row * acc_ld + cs + c] += coef * sum;
    }
  }
}

__device__ __forceinline__ void stage_rows(BwdSmem& sm, const float* lse,
                                           const float* delta, int q0,
                                           int S) {
  __syncthreads();
  if (threadIdx.x < kTile) {
    const int s = q0 + threadIdx.x;
    sm.lse[threadIdx.x] = s < S ? lse[s] : 0.f;
    sm.dd[threadIdx.x] = s < S ? delta[s] : 0.f;
  }
}

// dK, dV of 32 keys of one KV head, fp32 [B, T, KV, d*]
__global__ void __launch_bounds__(kThreads)
wide_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dk,
                 float* __restrict__ dv_out, int S, int Tk, int H, int KV,
                 int d, int dv, int causal, float scale) {
  __shared__ BwdSmem sm;
  const int tiles = (Tk + kTile - 1) / kTile;
  const int bk = blockIdx.x / tiles;
  const int k0 = blockIdx.x % tiles * kTile;
  const int b = bk / KV, kvh = bk % KV, G = H / KV;
  const int64_t q_ld = (int64_t)H * d, k_ld = (int64_t)KV * d;
  const int64_t v_ld = (int64_t)KV * dv, g_ld = (int64_t)H * dv;
  const float* kb = k + (int64_t)b * Tk * k_ld + (int64_t)kvh * d;
  const float* vb = v + (int64_t)b * Tk * v_ld + (int64_t)kvh * dv;
  float* dkb = dk + ((int64_t)b * Tk + k0) * k_ld + (int64_t)kvh * d;
  float* dvb = dv_out + ((int64_t)b * Tk + k0) * v_ld + (int64_t)kvh * dv;
  const int n_keys = min(kTile, Tk - k0);
  for (int i = threadIdx.x; i < n_keys * d; i += kThreads)
    dkb[i / d * k_ld + i % d] = 0.f;
  for (int i = threadIdx.x; i < n_keys * dv; i += kThreads)
    dvb[i / dv * v_ld + i % dv] = 0.f;
  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const float* qb = q + (int64_t)b * S * q_ld + (int64_t)h * d;
    const float* gb = dout + (int64_t)b * S * g_ld + (int64_t)h * dv;
    const float* lrow = lse + ((int64_t)b * H + h) * S;
    const float* drow = delta + ((int64_t)b * H + h) * S;
    for (int q0 = causal ? k0 / kTile * kTile : 0; q0 < S; q0 += kTile) {
      stage_rows(sm, lrow, drow, q0, S);
      tile_grads(sm, qb, q_ld, kb, k_ld, vb, v_ld, gb, g_ld, q0, k0, S, Tk,
                 d, dv, causal, scale);
      // dV += P^T dO, dK += dS^T q scale (rows: this block's keys)
      add_product(sm, sm.p, true, 1.f, dvb, v_ld, n_keys, gb, g_ld, q0, S,
                  dv);
      add_product(sm, sm.ds, true, scale, dkb, k_ld, n_keys, qb, q_ld, q0,
                  S, d);
    }
  }
}

// dQ of 32 query rows of one head, fp32 [B, S, H, d]
__global__ void __launch_bounds__(kThreads)
wide_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ dq, int S, int Tk, int H, int KV, int d,
               int dv, int causal, float scale) {
  __shared__ BwdSmem sm;
  const int tiles = (S + kTile - 1) / kTile;
  const int bh = blockIdx.x / tiles;
  const int q0 = blockIdx.x % tiles * kTile;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int64_t q_ld = (int64_t)H * d, k_ld = (int64_t)KV * d;
  const int64_t v_ld = (int64_t)KV * dv, g_ld = (int64_t)H * dv;
  const float* qb = q + (int64_t)b * S * q_ld + (int64_t)h * d;
  const float* gb = dout + (int64_t)b * S * g_ld + (int64_t)h * dv;
  const float* kb = k + (int64_t)b * Tk * k_ld + (int64_t)kvh * d;
  const float* vb = v + (int64_t)b * Tk * v_ld + (int64_t)kvh * dv;
  float* dqb = dq + ((int64_t)b * S + q0) * q_ld + (int64_t)h * d;
  const int n_rows = min(kTile, S - q0);
  for (int i = threadIdx.x; i < n_rows * d; i += kThreads)
    dqb[i / d * q_ld + i % d] = 0.f;
  stage_rows(sm, lse + ((int64_t)b * H + h) * S,
                delta + ((int64_t)b * H + h) * S, q0, S);
  const int k_end = causal ? min(Tk, q0 + kTile) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    tile_grads(sm, qb, q_ld, kb, k_ld, vb, v_ld, gb, g_ld, q0, k0, S, Tk, d,
               dv, causal, scale);
    add_product(sm, sm.ds, false, scale, dqb, q_ld, n_rows, kb, k_ld, k0, Tk,
                d);
  }
}

int launch_fwd(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int S, int Tk, int H, int KV, int d, int dv,
               int causal, float scale, cudaStream_t stream) {
  const int cols = dv < kGroup ? dv : kGroup;
  const int bytes = (int)sizeof(float) * fwd_smem_floats(cols);
  static const int configured = (int)cudaFuncSetAttribute(
      wide_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(float) * fwd_smem_floats(kGroup));
  if (configured != 0) return configured;
  const dim3 grid((unsigned)((S + kRows - 1) / kRows) * B * H,
                  (dv + kGroup - 1) / kGroup);
  wide_fwd_kernel<<<grid, kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, lse, S,
      Tk, H, KV, d, dv, causal, scale);
  return (int)cudaGetLastError();
}

int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, float* dq, float* dk,
               float* dv_out, int B, int S, int Tk, int H, int KV, int d,
               int dv, int causal, float scale, cudaStream_t stream) {
  wide_dkdv_kernel<<<(unsigned)((Tk + kTile - 1) / kTile) * B * KV,
                     kThreads, 0, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, delta, dk, dv_out, S, Tk, H, KV, d, dv, causal, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wide_dq_kernel<<<(unsigned)((S + kTile - 1) / kTile) * B * H, kThreads,
                   0, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      lse, delta, dq, S, Tk, H, KV, d, dv, causal, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------- bf16 on wgmma (Hopper's design)
// a block: two consumer warpgroups (warps 0-3, 4-7) and a producer
// warpgroup (8-11) of which one thread issues the loads
constexpr int kWgThreads = 384;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kBox = 64 * 64;              // bf16 of a TMA box
constexpr int kBoxBytes = 2 * kBox;        // 8 KB
constexpr int kSmemLimit = 232448;         // an H100 block's shared memory
constexpr int kFixedBytes = 1024 + 512;    // alignment slack, mbarriers
constexpr int kXchgFloats = 64 * 64;       // a 64 x 64 fp32 exchange buffer
constexpr int kMaxStages = 24;             // 2 * 24 + 1 mbarriers in 512 B
constexpr int kMinStages = 8;
constexpr int kGroupBoxes = 4;             // a group's accumulator, 256 cols
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

enum { kFwd = 0, kDkdv = 1, kDq = 2 };

// What a kernel's blocks hold, the same for every block of a launch
// (mirrored by flash_attention.py: wide_plan).  Side a is the score
// product over d's na boxes (Q K^T), side b the value side over dv's nb
// boxes (P V; dP = dO V^T in the backward).  res_a, res_b: the side's R
// rows (the forward's Q; dK/dV's K, V; dQ's Q, dO) stay in shared memory
// for the block's life, else they stream through the ring.  A row tile
// of a head has `pieces` blocks; a piece holds pa boxes of side a's
// columns (dK's; dQ's) and pb of side b's (the forward's V; dV's).
struct WidePlan {
  int kind, na, nb, res_a, res_b, pieces, pa, pb, xchg, entries, stages,
      table, smem;
};

__host__ __device__ constexpr int cdiv(int a, int b) {
  return (a + b - 1) / b;
}
__host__ __device__ constexpr int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// dQ: the first group's boxes of a piece of n, so that the two groups'
// products are even (na + n0 = nb + n - n0), each at most kGroupBoxes
__host__ __device__ inline int dq_split(int n, int na, int nb) {
  const int x = n + nb - na;
  const int half = x >= 0 ? x / 2 : -((1 - x) / 2);   // floor(x / 2)
  return imin(imin(kGroupBoxes, n), imax(imax(0, n - kGroupBoxes), half));
}

inline WidePlan wide_plan(int d, int dv, int kind) {
  WidePlan p{};
  p.kind = kind;
  p.na = cdiv(d, 64);
  p.nb = cdiv(dv, 64);
  if (kind == kFwd) {
    p.pieces = cdiv(p.nb, 2 * kGroupBoxes);
    p.pb = cdiv(p.nb, p.pieces);
    p.xchg = 2;
  } else if (kind == kDkdv) {
    p.pieces = imax(cdiv(p.na, kGroupBoxes), cdiv(p.nb, kGroupBoxes));
    p.pa = cdiv(p.na, p.pieces);
    p.pb = cdiv(p.nb, p.pieces);
    p.xchg = 1;
  } else {
    p.pieces = cdiv(p.na, 2 * kGroupBoxes);
    p.pa = cdiv(p.na, p.pieces);
    p.xchg = 2;
  }
  const int opts[4][2] = {{1, 1}, {1, 0}, {0, 1}, {0, 0}};
  for (const auto& o : opts) {
    const int ra = o[0], rb = kind == kFwd ? 0 : o[1];
    if (kind == kFwd && o[1]) continue;  // V has no resident rows
    const int entries = kind == kFwd ? p.na * (2 - ra) + p.pb
                                     : p.na * (2 - ra) + p.nb * (2 - rb);
    const int table = kind == kFwd ? 0 : (2 * entries + 15) / 16 * 16;
    const int held = p.pa * (2 - ra) + p.pb * (2 - rb);
    const int need = imax(kMinStages, kind == kFwd ? 0 : held + 2);
    const int fixed = kFixedBytes + p.xchg * kXchgFloats * 4 + table
                      + (ra * p.na + rb * p.nb) * kBoxBytes;
    const int avail = (kSmemLimit - fixed) / kBoxBytes;
    if (avail >= need) {
      p.res_a = ra;
      p.res_b = rb;
      p.entries = entries;
      p.table = table;
      // the forward's two groups take half the stages each
      p.stages = imin(avail, kMaxStages) & (kind == kFwd ? ~1 : ~0);
      p.smem = fixed + p.stages * kBoxBytes;
      return p;
    }
  }
  return p;                              // smem 0: too wide for a block
}

// the shared memory of a block: the 1024-aligned base, then the resident
// boxes, the ring, the exchange buffers, the mbarriers and the entry table
struct WideSmem {
  bf16* res;
  bf16* ring;
  float* xch;
  uint64_t* full;
  uint64_t* empty;
  uint64_t* res_full;
  uint16_t* table;
  __device__ WideSmem(unsigned char* raw, const WidePlan& p) {
    unsigned char* base = raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
    res = reinterpret_cast<bf16*>(base);
    ring = res + (p.res_a * p.na + p.res_b * p.nb) * kBox;
    xch = reinterpret_cast<float*>(ring + p.stages * kBox);
    full = reinterpret_cast<uint64_t*>(xch + p.xchg * kXchgFloats);
    empty = full + p.stages;
    res_full = empty + p.stages;
    table = reinterpret_cast<uint16_t*>(full + 64);
  }
};

// A ring: entry i (counted from the block's first) sits in stage i % n,
// in that stage's phase i / n.  Every group that shares a ring waits for
// each of its entries in order and releases each once, so none can run
// two phases ahead of a stage (a parity wait would then pass on the
// phase before).  Both come from a float reciprocal
// and one correction (exact for i < 2^24): an integer division by a
// run-time n costs tens of instructions, and every thread takes several
// an entry.
struct Ring {
  bf16* base;
  uint64_t* full;
  uint64_t* empty;
  int n;
  float inv;                           // 1 / n
  __device__ Ring(bf16* b, uint64_t* f, uint64_t* e, int stages)
      : base(b), full(f), empty(e), n(stages), inv(1.f / stages) {}
  // (phase, stage) of entry i
  __device__ __forceinline__ int2 at(int i) const {
    int q = __float2int_rz((float)i * inv);
    int r = i - q * n;
    if (r < 0) --q, r += n;
    else if (r >= n) ++q, r -= n;
    return make_int2(q, r);
  }
  __device__ bf16* box(int i) const { return base + at(i).y * kBox; }
  __device__ void wait(int i) const {
    const int2 a = at(i);
    mbar_wait(&full[a.y], a.x & 1);
  }
  // this warp's arrival on entry i's stage
  __device__ void release(int i) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(&empty[at(i).y]);
  }
  // the producer: box (c0, c1, c2, c3) of `map` into entry i
  __device__ void load(int i, const CUtensorMap* map, int c0, int c1, int c2,
                       int c3) const {
    const int2 a = at(i);
    if (a.x > 0) mbar_wait(&empty[a.y], (a.x - 1) & 1);
    mbar_expect_tx(&full[a.y], kBoxBytes);
    tma_load_4d(base + a.y * kBox, map, &full[a.y], c0, c1, c2, c3);
  }
};

// a value the same in every lane of the warp, broadcast from lane 0 so
// that the compiler sees it so: a wgmma on a path that depends on a
// value it cannot prove uniform is serialised (ptxas C7520)
__device__ __forceinline__ int uniform(int x) {
  return __shfl_sync(0xffffffffu, x, 0);
}
// the consumer group of warp `warp` (0-3: 0, 4-7: 1)
__device__ __forceinline__ int group_of(int warp) { return uniform(warp / 4); }

// x (+)= A B^T over one 64-column box, A and B K-major boxes; issued and
// committed as one group
__device__ __forceinline__ void box_scores(float (&x)[32], const bf16* a,
                                           const bf16* b, bool acc) {
  const uint64_t da = kmajor_desc(a), db = kmajor_desc(b);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)      // 32 bytes a k-step within the box
    wgmma_ss(x, da + 2 * kk, db + 2 * kk, acc || kk > 0);
  wgmma_commit();
}

// acc[c] += a B_c for c < n: a the A fragments of a 64 x 64 tile, B_c
// the MN-major box of ring entry e0 + step * c; waited for
__device__ __forceinline__ void box_sums(float (&acc)[kGroupBoxes][32],
                                         const uint32_t (&a)[4][4],
                                         const Ring& ring, const int* e,
                                         int n) {
#pragma unroll
  for (int c = 0; c < kGroupBoxes; ++c) fence_acc(acc[c]);
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < kGroupBoxes; ++c)
    if (c < n) {
      const uint64_t db = mnmajor_desc(ring.box(e[c]));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)  // 16 rows of 128 bytes a k-step
        wgmma_rs(acc[c], a[kk], db + kk * 128, 1);
    }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int c = 0; c < kGroupBoxes; ++c) fence_acc(acc[c]);
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
__device__ __forceinline__ float4 get4(const float* buf, int i, int v) {
  return *reinterpret_cast<const float4*>(buf + (v / 4 * 128 + i) * 4);
}

// whether the 64 x 64 scores of queries q0.. and keys k0.. are all kept:
// the same for every thread of a step; the others' masked scores are set
// to -inf before the one pass of 2^x
__device__ __forceinline__ bool inside(int q0, int k0, int S, int Tk,
                                       int causal) {
  return q0 + 63 < S && k0 + 63 < Tk && (!causal || q0 >= k0 + 63);
}

// a warpgroup's boxes c < n of a 64-row accumulator, box c at column
// col[c], times `mul`, into fp32 rows row0 + r < n_rows (stride apart) and
// columns < width of `out`
__device__ __forceinline__ void store_f32(const float (&acc)[kGroupBoxes][32],
                                          float* out, int64_t stride,
                                          int row0, int n_rows, int width,
                                          const int* col, int n, float mul,
                                          int i) {
  const int w = i / 32, g = i % 32 / 4, t = i % 4;
#pragma unroll
  for (int c = 0; c < kGroupBoxes; ++c) {
    if (c >= n) continue;
#pragma unroll
    for (int v = 0; v < 32; v += 2) {
      const int row = row0 + 16 * w + g + 8 * ((v >> 1) & 1);
      const int cc = col[c] + 8 * (v >> 2) + 2 * t;
      if (row < n_rows && cc < width)
        *reinterpret_cast<float2*>(out + row * stride + cc) =
            make_float2(acc[c][v] * mul, acc[c][v + 1] * mul);
    }
  }
}

// The forward: a block per (64 query rows, batch row x head, value
// piece), numbered head by head, within a head piece by piece and the
// tiles within a piece longest first when causal, so that the blocks in
// flight read few heads' K and V, which stay in the L2.  Every box has one
// reader, so each group has a ring of its own (half the stages): a key
// tile's entries in group g's are Q_j (when Q streams) and K_j for d's
// boxes j = g mod 2, then its value boxes p0 + g + 2 c.  The producer
// loads them in the order the two groups' products take them.
__global__ void __launch_bounds__(kWgThreads, 1)
wide_fwd_wgmma(__grid_constant__ const CUtensorMap q_map,
               __grid_constant__ const CUtensorMap k_map,
               __grid_constant__ const CUtensorMap v_map,
               bf16* __restrict__ out, float* __restrict__ lse, int S,
               int Tk, int H, int KV, int dv, int causal, float scale,
               const WidePlan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const WideSmem sm(smem_raw, p);
  const int half = p.stages / 2;       // a group's ring
  const Ring rings[2] = {
      Ring(sm.ring, sm.full, sm.empty, half),
      Ring(sm.ring + half * kBox, sm.full + half, sm.empty + half, half)};
  const int n_qt = cdiv(S, 64), n_kt = cdiv(Tk, 64);
  const int per_bh = n_qt * p.pieces;
  const int bh = blockIdx.x / per_bh;
  const int piece = blockIdx.x % per_bh / n_qt;
  const int rank = blockIdx.x % n_qt;
  const int qt = causal ? n_qt - 1 - rank : rank;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = 64 * qt;
  const int p0 = imin(piece * p.pb, p.nb), nv = imin(p0 + p.pb, p.nb) - p0;
  const int n_tiles = causal ? imin(n_kt, qt + 1) : n_kt;
  const int step = 2 - p.res_a;        // entries a box of d
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 4);      // a lane of each warp of the group
    }
    mbar_init(sm.res_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 8) {                     // ------------------------ producer
    reg_dealloc<kProducerRegs>();
    if (warp != 8 || lane != 0) return;
    if (p.res_a) {
      mbar_expect_tx(sm.res_full, p.na * kBoxBytes);
      for (int c = 0; c < p.na; ++c)
        tma_load_4d(sm.res + c * kBox, &q_map, sm.res_full, 64 * c, h, q0, b);
    }
    int i[2] = {0, 0};                 // the next entry of each ring
    for (int kt = 0; kt < n_tiles; ++kt) {
      const int k0 = 64 * kt;
      for (int j = 0; j < p.na; ++j) {
        const Ring& r = rings[j & 1];
        if (!p.res_a) r.load(i[j & 1]++, &q_map, 64 * j, h, q0, b);
        r.load(i[j & 1]++, &k_map, 64 * j, kvh, k0, b);
      }
      for (int c = 0; c < nv; ++c)
        rings[c & 1].load(i[c & 1]++, &v_map, 64 * (p0 + c), kvh, k0, b);
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  reg_alloc<kConsumerRegs>();
  const int g = group_of(warp);        // the consumer group
  const int tid = threadIdx.x % 128, w = tid / 32, gq = lane / 4,
            t = lane % 4;
  const float sl2 = scale * kLog2e;
  if (p.res_a) mbar_wait(sm.res_full, 0);
  const int mine = (nv - g + 1) / 2;   // my value boxes: p0 + g + 2 c
  const int my_a = (p.na - g + 1) / 2; // my boxes of d: g + 2 j
  const int E = my_a * step + mine;    // my ring's entries a tile
  const Ring& ring = rings[g];
  float* my_buf = sm.xch + g * kXchgFloats;
  const float* other_buf = sm.xch + (1 - g) * kXchgFloats;
  float o[kGroupBoxes][32];
#pragma unroll
  for (int c = 0; c < kGroupBoxes; ++c)
#pragma unroll
    for (int v = 0; v < 32; ++v) o[c][v] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = 64 * kt, base = kt * E;
    // my half of S: boxes j = g mod 2, each product's stages released
    // when the next is issued
    float x[32];
    int pend = -1;
    for (int jj = 0; jj < my_a; ++jj) {
      const int j = g + 2 * jj, ik = base + (jj + 1) * step - 1;
      if (!p.res_a) ring.wait(ik - 1);
      ring.wait(ik);
      box_scores(x, p.res_a ? sm.res + j * kBox : ring.box(ik - 1),
                 ring.box(ik), jj > 0);
      if (pend >= 0) {
        wgmma_wait<1>();
        for (int e = pend - step + 1; e <= pend; ++e) ring.release(e);
      }
      pend = ik;
    }
    wgmma_wait<0>();
    fence_acc(x);
    if (pend >= 0)
      for (int e = pend - step + 1; e <= pend; ++e) ring.release(e);
    if (g >= p.na) {                   // no box of d for this group
#pragma unroll
      for (int v = 0; v < 32; ++v) x[v] = 0.f;
    }
    // S = mine + theirs, the same sum in both groups
    if (kt > 0) named_sync(2, 256);    // the other read my last partial
    put_frag(my_buf, tid, x);
    named_sync(1, 256);
#pragma unroll
    for (int v = 0; v < 32; v += 4) {
      const float4 f = get4(other_buf, tid, v);
      x[v] += f.x, x[v + 1] += f.y, x[v + 2] += f.z, x[v + 3] += f.w;
    }
    if (!inside(q0, k0, S, Tk, causal)) {
#pragma unroll
      for (int v = 0; v < 32; ++v) {
        const int q = q0 + 16 * w + gq + 8 * ((v >> 1) & 1);
        const int key = k0 + 8 * (v >> 2) + 2 * t + (v & 1);
        if (!(key < Tk && (!causal || q >= key))) x[v] = -INFINITY;
      }
    }
    // the online softmax, rows 16 w + gq (hh 0) and + 8 (hh 1), each row
    // on the quad of threads t
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = -INFINITY;
#pragma unroll
      for (int v = 0; v < 32; ++v)
        if (((v >> 1) & 1) == hh) mx = fmaxf(mx, x[v]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[hh], mx * sl2);
      // a row whose keys are all masked so far keeps m = -inf: no NaN
      const float mu = mn == -INFINITY ? 0.f : mn;
      const float alpha = ex2_approx(m[hh] - mu);
      m[hh] = mn;
      float sum = 0.f;
#pragma unroll
      for (int v = 0; v < 32; ++v)
        if (((v >> 1) & 1) == hh) {
          x[v] = ex2_approx(fmaf(x[v], sl2, -mu));
          sum += x[v];
        }
      l[hh] = l[hh] * alpha + sum;
#pragma unroll
      for (int c = 0; c < kGroupBoxes; ++c)
#pragma unroll
        for (int v = 0; v < 32; ++v)
          if (((v >> 1) & 1) == hh) o[c][v] *= alpha;
    }
    uint32_t a[4][4];
    acc_to_a(x, a);                    // P rounded to bf16
    // O += P V over my value boxes
    int mv[kGroupBoxes];
#pragma unroll
    for (int c = 0; c < kGroupBoxes; ++c) {
      mv[c] = base + my_a * step + c;
      if (c < mine) ring.wait(mv[c]);
    }
    box_sums(o, a, ring, mv, mine);
    for (int c = 0; c < mine; ++c) ring.release(mv[c]);
  }

  // out = O / l in bf16, lse = (m + log2 l) ln 2 from the first piece
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  if (lse != nullptr && piece == 0 && g == 0 && t == 0)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int q = q0 + 16 * w + gq + 8 * hh;
      if (q < S) lse[((int64_t)b * H + h) * S + q] =
          (m[hh] + log2f(l[hh])) * kLn2;
    }
  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
  bf16* ob = out + ((int64_t)b * S * H + h) * dv;
  const int64_t stride = (int64_t)H * dv;
#pragma unroll
  for (int c = 0; c < kGroupBoxes; ++c) {
    if (c >= mine) continue;
    const int col0 = 64 * (p0 + g + 2 * c);
#pragma unroll
    for (int v = 0; v < 32; v += 2) {
      const int hh = (v >> 1) & 1;
      const int q = q0 + 16 * w + gq + 8 * hh;
      const int col = col0 + 8 * (v >> 2) + 2 * t;
      if (q < S && col < dv)
        *reinterpret_cast<__nv_bfloat162*>(ob + q * stride + col) =
            __floats2bfloat162_rn(o[c][v] * inv[hh], o[c][v + 1] * inv[hh]);
    }
  }
}

// an entry of the backward's ring order: side (0 a, 1 b), whether it is
// an R box (the side's resident rows streamed) and the box
__host__ __device__ constexpr uint16_t entry_code(int side, int r, int j) {
  return (uint16_t)(side << 15 | r << 14 | j);
}

// The dK/dV (DQ false) or dQ (DQ true) kernel.  dK/dV: a block per (key
// tile, batch row x KV head, piece); it walks the G query heads of its KV
// head and each one's query tiles from the first that sees its keys.  dQ:
// a block per (query tile, batch row x head, piece), the last rows first
// when causal; it walks the key tiles up to the diagonal.  A step's ring
// order (the block's entry table): every box of both sides that no group
// sums with, j = 0, 1, ..., side a's before side b's, each after its R box
// when R streams; then the held boxes of side a, then side b's.
template <bool DQ>
__global__ void __launch_bounds__(kWgThreads, 1)
wide_bwd_wgmma(__grid_constant__ const CUtensorMap q_map,
               __grid_constant__ const CUtensorMap k_map,
               __grid_constant__ const CUtensorMap v_map,
               __grid_constant__ const CUtensorMap do_map,
               const float* __restrict__ lse, const float* __restrict__ delta,
               float* __restrict__ out0, float* __restrict__ out1, int S,
               int Tk, int H, int KV, int d, int dv, int causal, float scale,
               const WidePlan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const WideSmem sm(smem_raw, p);
  const Ring ring(sm.ring, sm.full, sm.empty, p.stages);
  const int G = H / KV;
  const int n_qt = cdiv(S, 64), n_kt = cdiv(Tk, 64);
  const int n_t = DQ ? n_qt : n_kt;
  const int per = n_t * p.pieces;
  const int bh = blockIdx.x / per;
  const int piece = blockIdx.x % per / n_t;
  const int rank = blockIdx.x % n_t;
  const int tile = DQ && causal ? n_t - 1 - rank : rank;
  const int b = bh / (DQ ? H : KV), head = bh % (DQ ? H : KV);
  const int row0 = 64 * tile;
  int i0 = 0, n_q = 1, n_steps;
  if (!DQ) {                           // K and V of keys row0 ..
    i0 = causal ? tile : 0;            // the first query tile seeing a key
    n_q = imax(0, n_qt - i0);
    n_steps = G * n_q;
  } else {                             // Q and dO of queries row0 ..
    n_steps = causal ? imin(tile + 1, n_kt) : n_kt;
  }
  // the held boxes: dK/dV's dK piece (a) and dV piece (b), dQ's piece (a)
  const int ha0 = imin(piece * p.pa, p.na), ha1 = imin(ha0 + p.pa, p.na);
  const int hb0 = DQ ? 0 : imin(piece * p.pb, p.nb);
  const int hb1 = DQ ? 0 : imin(hb0 + p.pb, p.nb);
  const int E = p.entries;
  const int ra = 2 - p.res_a, rb = 2 - p.res_b;   // entries a box
  const int e2 = E - (ha1 - ha0) * ra - (hb1 - hb0) * rb;  // held part
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 8);      // a lane of each consumer warp
    }
    mbar_init(sm.res_full, 1);
    mbar_fence_init();
    int e = 0;
    for (int j = 0; j < imax(p.na, p.nb); ++j) {
      if (j < p.na && !(j >= ha0 && j < ha1)) {
        if (!p.res_a) sm.table[e++] = entry_code(0, 1, j);
        sm.table[e++] = entry_code(0, 0, j);
      }
      if (j < p.nb && !(j >= hb0 && j < hb1)) {
        if (!p.res_b) sm.table[e++] = entry_code(1, 1, j);
        sm.table[e++] = entry_code(1, 0, j);
      }
    }
    for (int j = ha0; j < ha1; ++j) {
      if (!p.res_a) sm.table[e++] = entry_code(0, 1, j);
      sm.table[e++] = entry_code(0, 0, j);
    }
    for (int j = hb0; j < hb1; ++j) {
      if (!p.res_b) sm.table[e++] = entry_code(1, 1, j);
      sm.table[e++] = entry_code(1, 0, j);
    }
  }
  __syncthreads();

  // R rows: (head, row0) of r_map; streamed rows: (step head, step row)
  const CUtensorMap* r_map[2] = {DQ ? &q_map : &k_map, DQ ? &do_map : &v_map};
  const CUtensorMap* s_map[2] = {DQ ? &k_map : &q_map, DQ ? &v_map : &do_map};
  const int res_bytes = (p.res_a * p.na + p.res_b * p.nb) * kBoxBytes;
  bf16* res_b_base = sm.res + p.res_a * p.na * kBox;
  if (warp >= 8) {                     // ------------------------ producer
    reg_dealloc<kProducerRegs>();
    if (warp != 8 || lane != 0) return;
    if (res_bytes) {
      mbar_expect_tx(sm.res_full, res_bytes);
      for (int c = 0; p.res_a && c < p.na; ++c)
        tma_load_4d(sm.res + c * kBox, r_map[0], sm.res_full, 64 * c, head,
                    row0, b);
      for (int c = 0; p.res_b && c < p.nb; ++c)
        tma_load_4d(res_b_base + c * kBox, r_map[1], sm.res_full, 64 * c,
                    head, row0, b);
    }
    int i = 0;
    for (int s = 0; s < n_steps; ++s) {
      const int sh = DQ ? head / G : head * G + s / n_q;
      const int srow = DQ ? 64 * s : 64 * (i0 + s % n_q);
      for (int e = 0; e < E; ++e, ++i) {
        const int u = sm.table[e], side = u >> 15, j = u & 0x3fff;
        if ((u >> 14) & 1)
          ring.load(i, r_map[side], 64 * j, head, row0, b);
        else
          ring.load(i, s_map[side], 64 * j, sh, srow, b);
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  reg_alloc<kConsumerRegs>();
  const int g = group_of(warp);        // group g forms side g's product
  const int tid = threadIdx.x % 128, w = tid / 32, gq = lane / 4,
            t = lane % 4;
  const float sl2 = scale * kLog2e;
  if (res_bytes) mbar_wait(sm.res_full, 0);
  // my sums: dK/dV's group 0 dV (side b), group 1 dK (side a); dQ's
  // groups the two parts of the piece (side a)
  const int sum_side = DQ ? 0 : 1 - g;
  int s0, s1;
  if (DQ) {
    const int n0 = dq_split(ha1 - ha0, p.na, p.nb);
    s0 = g == 0 ? ha0 : ha0 + n0;
    s1 = g == 0 ? ha0 + n0 : ha1;
  } else {
    s0 = g == 0 ? hb0 : ha0;
    s1 = g == 0 ? hb1 : ha1;
  }
  const int nsum = s1 - s0;
  // my sum boxes' places in the held part of a step's entries
  int sum_e[kGroupBoxes];
#pragma unroll
  for (int c = 0; c < kGroupBoxes; ++c)
    sum_e[c] = sum_side == 0
        ? e2 + (s0 + c - ha0) * ra + ra - 1
        : e2 + (ha1 - ha0) * ra + (s0 + c - hb0) * rb + rb - 1;
  float acc[kGroupBoxes][32];
#pragma unroll
  for (int c = 0; c < kGroupBoxes; ++c)
#pragma unroll
    for (int v = 0; v < 32; ++v) acc[c][v] = 0.f;
  float l2[2] = {0.f, 0.f}, dd[2] = {0.f, 0.f};   // dQ: my rows' lse, D
  if (DQ)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int q = row0 + 16 * w + gq + 8 * hh;
      const int64_t at = ((int64_t)b * H + head) * S + q;
      l2[hh] = q < S ? lse[at] * kLog2e : 0.f;
      dd[hh] = q < S ? delta[at] : 0.f;
    }
  float* my_buf = sm.xch + (DQ ? g * kXchgFloats : 0);
  const float* other_buf = sm.xch + (DQ ? (1 - g) * kXchgFloats : 0);

  for (int s = 0; s < n_steps; ++s) {
    const int sh = DQ ? head / G : head * G + s / n_q;
    const int srow = DQ ? 64 * s : 64 * (i0 + s % n_q);
    const int q0 = DQ ? row0 : srow, k0 = DQ ? srow : row0;
    const int base = s * E;
    float cv[16];                      // dK/dV: my columns' lse or D
    if (!DQ) {
      const float* row = (g == 0 ? lse : delta) + ((int64_t)b * H + sh) * S;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int q = q0 + 8 * j + 2 * t + c;
          cv[2 * j + c] = q < S ? row[q] * (g == 0 ? kLog2e : 1.f) : 0.f;
        }
    }
    // my side's product over the step's entries, every one of which I
    // wait for (the others' released at once); a product's stages are
    // released when the next is issued, or before a wait for an entry
    // that needs them
    float x[32];
    bool any = false, pend_held = false;
    int pend = -1, pend_r = -1, re = -1;
    for (int e = 0; e < E; ++e) {
      const int u = uniform(sm.table[e]), side = u >> 15;
      const int isr = (u >> 14) & 1, j = u & 0x3fff, i = base + e;
      const bool held = !isr && side == sum_side && j >= s0 && j < s1;
      if (pend >= 0 && imin(pend, pend_r < 0 ? pend : pend_r)
                           <= i - p.stages) {
        wgmma_wait<0>();
        if (!pend_held) ring.release(pend);
        if (pend_r >= 0) ring.release(pend_r);
        pend = pend_r = -1;
      }
      ring.wait(i);
      if (side != g) {
        if (!held) ring.release(i);
        continue;
      }
      if (isr) {
        re = i;
        continue;
      }
      const bool res = side ? p.res_b : p.res_a;
      const bf16* a = res ? (side ? res_b_base : sm.res) + j * kBox
                          : ring.box(re);
      box_scores(x, a, ring.box(i), any);
      if (pend >= 0) {
        wgmma_wait<1>();
        if (!pend_held) ring.release(pend);
        if (pend_r >= 0) ring.release(pend_r);
      }
      pend = i;
      pend_r = res ? -1 : re;
      pend_held = held;
      any = true;
    }
    wgmma_wait<0>();
    fence_acc(x);
    if (pend >= 0) {
      if (!pend_held) ring.release(pend);
      if (pend_r >= 0) ring.release(pend_r);
    }
    if (!any) {
#pragma unroll
      for (int v = 0; v < 32; ++v) x[v] = 0.f;
    }
    if (!DQ) {
      if (g == 0) {                    // S^T: rows keys, columns queries
        if (!inside(q0, k0, S, Tk, causal)) {
#pragma unroll
          for (int v = 0; v < 32; ++v) {
            const int key = k0 + 16 * w + gq + 8 * ((v >> 1) & 1);
            const int q = q0 + 8 * (v >> 2) + 2 * t + (v & 1);
            if (!(key < Tk && q < S && (!causal || q >= key)))
              x[v] = -INFINITY;
          }
        }
#pragma unroll
        for (int v = 0; v < 32; ++v)
          x[v] = ex2_approx(fmaf(x[v], sl2, -cv[2 * (v >> 2) + (v & 1)]));
        if (s > 0) named_sync(2, 256);  // step s - 1's P^T was read
        put_frag(my_buf, tid, x);
        named_sync(1, 256);
      } else {                         // dS^T = P^T (dP^T - D)
        if (s > 0) named_sync(2, 256);
        named_sync(1, 256);
#pragma unroll
        for (int v = 0; v < 32; v += 4) {
          const float4 f = get4(other_buf, tid, v);
          const float pv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
          for (int c = 0; c < 4; ++c)
            x[v + c] = pv[c] * (x[v + c] - cv[2 * (v >> 2) + (c & 1)]);
        }
      }
    } else {
      if (g == 0) {                    // S: rows queries, columns keys
        if (!inside(q0, k0, S, Tk, causal)) {
#pragma unroll
          for (int v = 0; v < 32; ++v) {
            const int q = q0 + 16 * w + gq + 8 * ((v >> 1) & 1);
            const int key = k0 + 8 * (v >> 2) + 2 * t + (v & 1);
            if (!(key < Tk && q < S && (!causal || q >= key)))
              x[v] = -INFINITY;
          }
        }
#pragma unroll
        for (int v = 0; v < 32; ++v)
          x[v] = ex2_approx(fmaf(x[v], sl2, -l2[(v >> 1) & 1]));
      }
      if (s > 0) named_sync(2, 256);    // step s - 1's buffers were read
      put_frag(my_buf, tid, x);
      named_sync(1, 256);
      // dS = P (dP - D): x is P and the other's dP in group 0, the other
      // way round in group 1
#pragma unroll
      for (int v = 0; v < 32; v += 4) {
        const float4 f = get4(other_buf, tid, v);
        const float y[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float pv = g == 0 ? x[v + c] : y[c];
          const float dpv = g == 0 ? y[c] : x[v + c];
          x[v + c] = pv * (dpv - dd[((v + c) >> 1) & 1]);
        }
      }
    }
    uint32_t a[4][4];
    acc_to_a(x, a);
    int se[kGroupBoxes];
#pragma unroll
    for (int c = 0; c < kGroupBoxes; ++c) se[c] = base + sum_e[c];
    box_sums(acc, a, ring, se, nsum);
    for (int c = 0; c < nsum; ++c) ring.release(se[c]);
  }

  // dK/dV: group 0 dV [B, T, KV, dv], group 1 dK (times scale); dQ
  // [B, S, H, d] (times scale)
  int col[kGroupBoxes];
#pragma unroll
  for (int c = 0; c < kGroupBoxes; ++c) col[c] = 64 * (s0 + c);
  if (DQ)
    store_f32(acc, out0 + ((int64_t)b * S * H + head) * d, (int64_t)H * d,
              row0, S, d, col, nsum, scale, tid);
  else if (g == 0)
    store_f32(acc, out1 + ((int64_t)b * Tk * KV + head) * dv,
              (int64_t)KV * dv, row0, Tk, dv, col, nsum, 1.f, tid);
  else
    store_f32(acc, out0 + ((int64_t)b * Tk * KV + head) * d,
              (int64_t)KV * d, row0, Tk, d, col, nsum, scale, tid);
}

// a 4-D map of each tensor; d and dv whole 16-byte chunks
int wide_maps(CUtensorMap* qm, CUtensorMap* km, CUtensorMap* vm,
              CUtensorMap* om, const void* q, const void* k, const void* v,
              const void* dout, int B, int S, int Tk, int H, int KV, int d,
              int dv) {
  int err = bf16_box_map(qm, q, B, S, H, d);
  if (err == 0) err = bf16_box_map(km, k, B, Tk, KV, d);
  if (err == 0) err = bf16_box_map(vm, v, B, Tk, KV, dv);
  if (err == 0 && dout != nullptr) err = bf16_box_map(om, dout, B, S, H, dv);
  return err;
}

template <typename K>
int configure(K kernel) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
}

int launch_fwd_wgmma(const void* q, const void* k, const void* v, void* out,
                     float* lse, int B, int S, int Tk, int H, int KV, int d,
                     int dv, int causal, float scale, cudaStream_t stream) {
  const WidePlan p = wide_plan(d, dv, kFwd);
  if (d % 8 || dv % 8 || p.smem == 0) return (int)cudaErrorInvalidValue;
  static const int configured = configure(wide_fwd_wgmma);
  if (configured != 0) return configured;
  CUtensorMap qm, km, vm;
  const int err = wide_maps(&qm, &km, &vm, nullptr, q, k, v, nullptr, B, S,
                            Tk, H, KV, d, dv);
  if (err != 0) return err;
  wide_fwd_wgmma<<<(unsigned)cdiv(S, 64) * p.pieces * B * H, kWgThreads,
                   p.smem, stream>>>(qm, km, vm, (bf16*)out, lse, S, Tk, H,
                                     KV, dv, causal, scale, p);
  return (int)cudaGetLastError();
}

int launch_bwd_wgmma(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     float* dq, float* dk, float* dv_out, int B, int S,
                     int Tk, int H, int KV, int d, int dv, int causal,
                     float scale, cudaStream_t stream) {
  const WidePlan pkv = wide_plan(d, dv, kDkdv), pq = wide_plan(d, dv, kDq);
  if (d % 8 || dv % 8 || pkv.smem == 0 || pq.smem == 0)
    return (int)cudaErrorInvalidValue;
  static const int configured =
      configure(wide_bwd_wgmma<false>) | configure(wide_bwd_wgmma<true>);
  if (configured != 0) return configured;
  CUtensorMap qm, km, vm, om;
  const int err = wide_maps(&qm, &km, &vm, &om, q, k, v, dout, B, S, Tk, H,
                            KV, d, dv);
  if (err != 0) return err;
  wide_bwd_wgmma<false><<<(unsigned)cdiv(Tk, 64) * pkv.pieces * B * KV,
                          kWgThreads, pkv.smem, stream>>>(
      qm, km, vm, om, lse, delta, dk, dv_out, S, Tk, H, KV, d, dv, causal,
      scale, pkv);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  wide_bwd_wgmma<true><<<(unsigned)cdiv(S, 64) * pq.pieces * B * H,
                         kWgThreads, pq.smem, stream>>>(
      qm, km, vm, om, lse, delta, dq, nullptr, S, Tk, H, KV, d, dv, causal,
      scale, pq);
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" {

// out [B, S, H, dv] in the inputs' type (is_bf16 != 0: bfloat16, on the
// wgmma design, d and dv multiples of 8; else float32 on the CUDA cores,
// any d, dv >= 1) from q [B, S, H, d], k [B, T, KV, d], v [B, T, KV, dv],
// all contiguous and 16-byte aligned, H a multiple of KV; lse [B, H, S]
// fp32 when not null.  Scores are q.k * scale.  Returns a CUDA error code.
int flash_attention_wide(const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int S, int T, int H,
                         int KV, int d, int dv, int causal, float scale,
                         int is_bf16, void* stream) {
  if (B < 1 || S < 1 || T < 1 || KV < 1 || H % KV != 0 || d < 1 || dv < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch_fwd_wgmma(q, k, v, out, (float*)lse, B, S, T, H,
                                    KV, d, dv, causal, scale, st)
                 : launch_fwd(q, k, v, out, (float*)lse, B, S, T, H,
                                     KV, d, dv, causal, scale, st);
}

// dq [B, S, H, d], dk [B, T, KV, d], dv [B, T, KV, dv] in float32 from q,
// k, v, dO in the inputs' type (the forward's layouts and limits), the
// forward's lse and D [B, H, S] fp32 and its scale.  Two launches: dK/dV,
// then dQ.  Returns a CUDA error code.
int flash_attention_wide_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, void* dk, void* dv,
                             int B, int S, int T, int H, int KV, int d,
                             int dvw, int causal, float scale, int is_bf16,
                             void* stream) {
  if (B < 1 || S < 1 || T < 1 || KV < 1 || H % KV != 0 || d < 1 || dvw < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16
      ? launch_bwd_wgmma(q, k, v, dout, (const float*)lse,
                         (const float*)delta, (float*)dq, (float*)dk,
                         (float*)dv, B, S, T, H, KV, d, dvw, causal, scale, st)
      : launch_bwd(q, k, v, dout, (const float*)lse,
                          (const float*)delta, (float*)dq, (float*)dk,
                          (float*)dv, B, S, T, H, KV, d, dvw, causal, scale,
                          st);
}

// The dynamic shared memory a block of the forward (kind 0), the dK/dV
// kernel (1) or the dQ kernel (2) takes at (d, dv): the wgmma design's
// for bfloat16 (0 where no block holds the widths), the CUDA cores' for
// float32 (whose backward kernels take static shared memory: 0).
int flash_attention_wide_smem_bytes(int d, int dv, int kind, int is_bf16) {
  if (is_bf16) return wide_plan(d, dv, kind).smem;
  return kind == kFwd
      ? (int)sizeof(float) * fwd_smem_floats(dv < kGroup ? dv : kGroup) : 0;
}

// The wgmma design's plan of kind 0 (forward), 1 (dK/dV) or 2 (dQ) at
// (d, dv), WidePlan's 13 fields in order into out.
void flash_attention_wide_plan(int d, int dv, int kind, int* out) {
  const WidePlan p = wide_plan(d, dv, kind);
  const int f[13] = {p.kind, p.na, p.nb, p.res_a, p.res_b, p.pieces, p.pa,
                     p.pb, p.xchg, p.entries, p.stages, p.table, p.smem};
  for (int i = 0; i < 13; ++i) out[i] = f[i];
}

}  // extern "C"
