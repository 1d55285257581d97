// Paged single-token decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/decode_attention/decode_attention.py:
// paged_decode_attention_kernel, the Pallas kernel whose grid walks
// (sequence, page) in order, dereferences the page table from scalar-prefetch
// memory and keeps the online-softmax state in VMEM scratch.
//
// Computes, per sequence row b and query head h: attention of q[b, h, :]
// over the first seq_lens[b] positions of the row's K/V history, stored as
// pages k_pages[page_table[b, p]] and v_pages[page_table[b, p]] ([page, D]
// each).  A score is the fp32 dot divided by sqrt(D) after the dot; the
// softmax is online with fp32 accumulation; out = acc / max(l, 1e-30), so a
// row of length 0 gives zeros.  Pages at or past seq_len are never read
// (their table entries may be -1).  One KV head is shared by all H query
// heads: a caller with grouped-query attention folds the KV heads into the
// rows (rows = sequences x KV heads, H = query heads per KV head).
//
// Bound: bytes.  Every K and V element below seq_len is read once and takes
// part in 2 * H flops; at H = 5 query heads per KV head that is about 2.5
// flops per byte of bf16 K/V, far below the ~295 the card needs before its
// arithmetic binds.
//
// Design: one block of 128 threads per (row, chunk of up to G query heads),
// looping over the row's pages in order.  A "worker" is a group of
// D / (16 / sizeof(T)) lanes that owns one token at a time: each lane loads
// one 16-byte vector of the token's K row and one of its V row (4 fp32 or 8
// bf16 values, converted to fp32 on load), the group sums its partial dots
// with shuffles, and every worker keeps its own running max, sum and
// [G, D] accumulator in fp32 registers over the tokens it owns, two tokens a
// step so that four loads are in flight per lane.  At the end the workers'
// states are merged through shared memory.  Split-K over pages, TMA and
// wgmma are not used.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 2;           // tokens per worker per step
constexpr float kNegInf = -1e30f;    // the Pallas kernel's NEG_INF

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* x) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float* x) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
              const T* __restrict__ v_pages,
              const int32_t* __restrict__ table,
              const int32_t* __restrict__ seq_lens, T* __restrict__ out,
              int H, int P, int page, int n_slots) {
  constexpr int E = Vec16<T>::N;        // elements per lane
  constexpr int LPT = D / E;            // lanes per worker
  static_assert(LPT >= 1 && LPT <= 32 && 32 % LPT == 0, "head dim");
  constexpr int NW = kThreads / LPT;    // workers per block
  constexpr int STEP = NW * kUnroll;    // tokens per block step
  __shared__ float q_s[G * D];
  __shared__ float m_s[NW * G];
  __shared__ float l_s[NW * G];
  __shared__ float acc_s[NW * G * D];

  const int row = blockIdx.x;
  const int h0 = blockIdx.y * G;
  const int gn = min(G, H - h0);        // heads of this chunk
  const int worker = threadIdx.x / LPT;
  const int sub = threadIdx.x % LPT;    // which 16-byte vector of the row
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const int g = i / D;
    q_s[i] = g < gn ? to_f32(q[((int64_t)row * H + h0 + g) * D + i % D])
                    : 0.f;
  }
  __syncthreads();

  const float inv_scale = 1.f / sqrtf((float)D);
  float m[G], l[G], acc[G][E];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[g][e] = 0.f;
  }
  const int len = seq_lens[row];
  const int32_t* trow = table + (int64_t)row * P;
  const int n_pages = len <= 0 ? 0 : min(P, (len + page - 1) / page);
  const int64_t page_elems = (int64_t)page * D;
  for (int pi = 0; pi < n_pages; ++pi) {
    const int slot = trow[pi];
    if (slot < 0 || slot >= n_slots) continue;   // the wrapper raises first
    const int n_valid = min(page, len - pi * page);
    const T* kb = k_pages + slot * page_elems + sub * E;
    const T* vb = v_pages + slot * page_elems + sub * E;
    // block-uniform trip count: every lane reaches every shuffle
    for (int base = 0; base < n_valid; base += STEP) {
      float kx[kUnroll][E], vx[kUnroll][E];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = base + worker * kUnroll + u;
        ok[u] = t < n_valid;
        if (ok[u]) {
          Vec16<T>::load(kb + (int64_t)t * D, kx[u]);
          Vec16<T>::load(vb + (int64_t)t * D, vx[u]);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) kx[u][e] = vx[u][e] = 0.f;
        }
      }
      float s[kUnroll][G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g >= gn) break;                       // uniform in the block
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e)
            part = fmaf(q_s[g * D + sub * E + e], kx[u][e], part);
#pragma unroll
          for (int off = LPT / 2; off > 0; off >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, off);
          s[u][g] = part * inv_scale;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g >= gn) break;
        float mn = m[g];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (ok[u]) mn = fmaxf(mn, s[u][g]);
        const float alpha = expf(m[g] - mn);
        float p[kUnroll];
        float ps = 0.f;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          p[u] = ok[u] ? expf(s[u][g] - mn) : 0.f;
          ps += p[u];
        }
        l[g] = l[g] * alpha + ps;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          float a = acc[g][e] * alpha;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) a = fmaf(p[u], vx[u][e], a);
          acc[g][e] = a;
        }
        m[g] = mn;
      }
    }
  }

  // merge the workers' (max, sum, accumulator) states
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (sub == 0) {
      m_s[worker * G + g] = m[g];
      l_s[worker * G + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      acc_s[(worker * G + g) * D + sub * E + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < gn * D; i += kThreads) {
    const int g = i / D;
    const int c = i % D;
    float M = kNegInf;
    for (int w = 0; w < NW; ++w) M = fmaxf(M, m_s[w * G + g]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < NW; ++w) {
      const float sc = expf(m_s[w * G + g] - M);
      L = fmaf(l_s[w * G + g], sc, L);
      A = fmaf(acc_s[(w * G + g) * D + c], sc, A);
    }
    store(out + ((int64_t)row * H + h0 + g) * D + c, A / fmaxf(L, 1e-30f));
  }
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, const void* table,
           const void* lens, void* out, int B, int H, int P, int page,
           int n_slots, cudaStream_t stream) {
  const dim3 grid(B, (H + G - 1) / G);
  decode_kernel<T, D, G><<<grid, kThreads, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int32_t*)table,
      (const int32_t*)lens, (T*)out, H, P, page, n_slots);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_heads(const void* q, const void* k, const void* v,
                 const void* table, const void* lens, void* out, int B,
                 int H, int P, int page, int n_slots, cudaStream_t stream) {
  // up to 8 query heads per block; 4 when there are few
  if (H > 4)
    return launch<T, D, 8>(q, k, v, table, lens, out, B, H, P, page, n_slots,
                           stream);
  return launch<T, D, 4>(q, k, v, table, lens, out, B, H, P, page, n_slots,
                         stream);
}

template <typename T>
int launch_dim(const void* q, const void* k, const void* v, const void* table,
               const void* lens, void* out, int B, int H, int D, int P,
               int page, int n_slots, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_heads<T, 16>(q, k, v, table, lens, out, B, H, P, page, n_slots, stream);
    case 32: return launch_heads<T, 32>(q, k, v, table, lens, out, B, H, P, page, n_slots, stream);
    case 64: return launch_heads<T, 64>(q, k, v, table, lens, out, B, H, P, page, n_slots, stream);
    case 128: return launch_heads<T, 128>(q, k, v, table, lens, out, B, H, P, page, n_slots, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B, H, D], k/v pages [n_slots, page, D] and out [B, H, D] of one type
// (bf16 != 0: bfloat16, else float32), page_table [B, P] and seq_lens [B]
// int32, all contiguous.  Returns a CUDA error code; cudaErrorInvalidValue
// for a head dim outside {16, 32, 64, 128}.
int decode_attention(const void* q, const void* k_pages, const void* v_pages,
                     const void* page_table, const void* seq_lens, void* out,
                     int B, int H, int D, int P, int page, int n_slots,
                     int bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return launch_dim<__nv_bfloat16>(q, k_pages, v_pages, page_table,
                                     seq_lens, out, B, H, D, P, page, n_slots,
                                     st);
  return launch_dim<float>(q, k_pages, v_pages, page_table, seq_lens, out, B,
                           H, D, P, page, n_slots, st);
}

}  // extern "C"
