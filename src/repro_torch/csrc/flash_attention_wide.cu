// Blocked online-softmax attention (K6) and its backward at any key and
// value width, for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/flash_attention/flash_attention.py:
// flash_attention_kernel at the widths that no pair of
// csrc/flash_attention.cu covers (d or dv past 256).  The Pallas kernel's
// block specs take whole head widths, so it computes every width; this
// file is the port's route for the widths past the instantiated pairs,
// and for their gradient, as csrc/flash_attention_bwd.cu is for the
// pairs'.
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
// Design, either type, on the CUDA cores with fp32 sums (probabilities
// are not rounded before the value sum: the plain version's function).
// The widths are walked, never held: a block stages 32 (or 64) columns
// of its operands at a time in shared memory, so no width is too wide.
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

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;              // query rows a forward block
constexpr int kKeys = 64;              // keys a forward tile
constexpr int kSlab = 32;              // key-width columns a step of S
constexpr int kVSlab = 64;             // value columns a step of P V
constexpr int kGroup = 512;            // value columns a forward block
constexpr int kTile = 32;              // rows and keys a backward tile
constexpr float kNegInf = -1e30f;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

// the forward's dynamic shared memory for `cols` value columns a block
__host__ __device__ constexpr int fwd_smem_floats(int cols) {
  return kRows * (kSlab + 1) + kKeys * (kSlab + 1) + kRows * (kKeys + 1)
         + kKeys * kVSlab + kRows * cols + kRows;
}

// rows [r0, r0 + n) x columns [c0, c0 + w) of a row-major operand with
// row stride ld into dst [n][dld] as fp32, zeros outside (rows, cols)
template <typename T>
__device__ __forceinline__ void stage(float* dst, int dld, const T* src,
                                      int64_t ld, int r0, int n, int rows,
                                      int c0, int w, int cols) {
  for (int i = threadIdx.x; i < n * w; i += kThreads) {
    const int r = i / w, c = i % w;
    dst[r * dld + c] = r0 + r < rows && c0 + c < cols
                           ? to_f32(src[(int64_t)(r0 + r) * ld + c0 + c])
                           : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, T* __restrict__ out,
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
  const T* qb = q + (int64_t)b * S * q_ld + (int64_t)h * d;
  const T* kb = k + (int64_t)b * Tk * k_ld + (int64_t)kvh * d;
  const T* vb = v + (int64_t)b * Tk * v_ld + (int64_t)kvh * dv + v0;
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
  T* ob = out + ((int64_t)b * S * H + h) * dv + v0;
  for (int i = tid; i < kRows * cols; i += kThreads) {
    const int rr = i / cols, c = i % cols;
    if (q0 + rr < S)
      store(ob + (int64_t)(q0 + rr) * H * dv + c,
            o_s[i] / fmaxf(l_s[rr], 1e-30f));
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
template <typename T>
__device__ __forceinline__ void tile_grads(
    BwdSmem& sm, const T* qb, int64_t q_ld, const T* kb, int64_t k_ld,
    const T* vb, int64_t v_ld, const T* gb, int64_t g_ld, int q0, int k0,
    int S, int Tk, int d, int dv, int causal, float scale) {
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
template <typename T>
__device__ __forceinline__ void add_product(
    BwdSmem& sm, const float* M, bool trans, float coef, float* acc,
    int64_t acc_ld, int n_rows, const T* x, int64_t x_ld, int x0, int x_rows,
    int width) {
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
template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
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
  const T* kb = k + (int64_t)b * Tk * k_ld + (int64_t)kvh * d;
  const T* vb = v + (int64_t)b * Tk * v_ld + (int64_t)kvh * dv;
  float* dkb = dk + ((int64_t)b * Tk + k0) * k_ld + (int64_t)kvh * d;
  float* dvb = dv_out + ((int64_t)b * Tk + k0) * v_ld + (int64_t)kvh * dv;
  const int n_keys = min(kTile, Tk - k0);
  for (int i = threadIdx.x; i < n_keys * d; i += kThreads)
    dkb[i / d * k_ld + i % d] = 0.f;
  for (int i = threadIdx.x; i < n_keys * dv; i += kThreads)
    dvb[i / dv * v_ld + i % dv] = 0.f;
  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const T* qb = q + (int64_t)b * S * q_ld + (int64_t)h * d;
    const T* gb = dout + (int64_t)b * S * g_ld + (int64_t)h * dv;
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
template <typename T>
__global__ void __launch_bounds__(kThreads)
wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
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
  const T* qb = q + (int64_t)b * S * q_ld + (int64_t)h * d;
  const T* gb = dout + (int64_t)b * S * g_ld + (int64_t)h * dv;
  const T* kb = k + (int64_t)b * Tk * k_ld + (int64_t)kvh * d;
  const T* vb = v + (int64_t)b * Tk * v_ld + (int64_t)kvh * dv;
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

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int S, int Tk, int H, int KV, int d, int dv,
               int causal, float scale, cudaStream_t stream) {
  const int cols = dv < kGroup ? dv : kGroup;
  const int bytes = (int)sizeof(float) * fwd_smem_floats(cols);
  static const int configured = (int)cudaFuncSetAttribute(
      wide_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(float) * fwd_smem_floats(kGroup));
  if (configured != 0) return configured;
  const dim3 grid((unsigned)((S + kRows - 1) / kRows) * B * H,
                  (dv + kGroup - 1) / kGroup);
  wide_fwd_kernel<T><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, lse, S, Tk, H, KV, d,
      dv, causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, float* dq, float* dk,
               float* dv_out, int B, int S, int Tk, int H, int KV, int d,
               int dv, int causal, float scale, cudaStream_t stream) {
  wide_dkdv_kernel<T><<<(unsigned)((Tk + kTile - 1) / kTile) * B * KV,
                        kThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, dk,
      dv_out, S, Tk, H, KV, d, dv, causal, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wide_dq_kernel<T><<<(unsigned)((S + kTile - 1) / kTile) * B * H, kThreads,
                      0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, dq,
      S, Tk, H, KV, d, dv, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out [B, S, H, dv] in the inputs' type (is_bf16 != 0: bfloat16, else
// float32) from q [B, S, H, d], k [B, T, KV, d], v [B, T, KV, dv], all
// contiguous, H a multiple of KV, any d, dv >= 1; lse [B, H, S] fp32
// when not null.  Scores are q.k * scale.  Returns a CUDA error code.
int flash_attention_wide(const void* q, const void* k, const void* v,
                         void* out, void* lse, int B, int S, int T, int H,
                         int KV, int d, int dv, int causal, float scale,
                         int is_bf16, void* stream) {
  if (B < 1 || S < 1 || T < 1 || KV < 1 || H % KV != 0 || d < 1 || dv < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return is_bf16 ? launch_fwd<bf16>(q, k, v, out, (float*)lse, B, S, T, H,
                                    KV, d, dv, causal, scale, st)
                 : launch_fwd<float>(q, k, v, out, (float*)lse, B, S, T, H,
                                     KV, d, dv, causal, scale, st);
}

// dq [B, S, H, d], dk [B, T, KV, d], dv [B, T, KV, dv] in float32 from q,
// k, v, dO in the inputs' type (the forward's layouts), the forward's lse
// and D [B, H, S] fp32 and its scale.  Two launches: dK/dV, then dQ.
// Returns a CUDA error code.
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
      ? launch_bwd<bf16>(q, k, v, dout, (const float*)lse,
                         (const float*)delta, (float*)dq, (float*)dk,
                         (float*)dv, B, S, T, H, KV, d, dvw, causal, scale, st)
      : launch_bwd<float>(q, k, v, dout, (const float*)lse,
                          (const float*)delta, (float*)dq, (float*)dk,
                          (float*)dv, B, S, T, H, KV, d, dvw, causal, scale,
                          st);
}

// The forward's dynamic shared memory a block at value width dv.
int flash_attention_wide_smem_bytes(int dv) {
  return (int)sizeof(float) * fwd_smem_floats(dv < kGroup ? dv : kGroup);
}

}  // extern "C"
