// Paged decode attention for Hopper, float32 or bfloat16 pools in any of
// the three vendor page layouts (nbhd / nhbd / nhdb).
//
// Replaces: src/repro/kernels/paged_attention.py : paged_attention
//           (_paged_kernel, the Pallas TPU PagedAttention with a
//           scalar-prefetched block table).
//
// What bounds it on this card: bytes. One decode token reads every K/V
// row of its sequence once and does 2 multiply-adds per element per query
// head in the group, a few operations per byte against the H100's ~295
// operations-per-byte ridge, so the floor is the cache size over 3.35 TB/s.
//
// Design: one block per (KV head, sequence). The block reads its own
// block-table row and walks the pages up to ceil(seq_len / block_size)
// (from the first page inside the sliding window, when there is one),
// staging each page's K and V rows for its KV head in shared memory as
// float32. The grp query heads that share the KV head are scored against
// the same staged page, so K/V are read from device memory once per
// group. The softmax is online in float32 (running max, sum and output
// accumulator across pages), so no score vector the length of the
// sequence is kept. The pool is read through its (block, token, head,
// dim) strides, which is how one kernel serves all three layouts; the
// staging loop walks whichever of token or dim is contiguous in memory so
// neighbouring threads read neighbouring addresses. Idle decode slots
// point at the engine's scratch block with seq_len 1 and read only that
// page. Later work: split the page walk across blocks for long contexts.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MAXGRP_D = 16 * THREADS;  // query heads per group x head_dim
constexpr int MAXE = MAXGRP_D / THREADS;

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ table,
                    const int* __restrict__ lens, T* __restrict__ o,
                    int grp, int D, int BS, int max_pages,
                    long long q_sb, long long q_sh,
                    long long p_sn, long long p_st, long long p_sh, long long p_sd,
                    long long o_sb, long long o_sh, float scale, int window) {
  extern __shared__ float sm[];
  const int LD = D + 1;
  float* Qs = sm;                    // [grp][D]
  float* Ks = Qs + grp * D;          // [BS][D + 1]
  float* Vs = Ks + BS * LD;          // [BS][D + 1]
  float* Ss = Vs + BS * LD;          // [grp][BS] scores, then probabilities
  float* Ms = Ss + grp * BS;         // [grp] running max
  float* Ls = Ms + grp;              // [grp] running sum
  float* As = Ls + grp;              // [grp] rescale of this page

  const int tid = threadIdx.x;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int seq_len = lens[b];
  const int nq = grp * D;

  for (int e = tid; e < nq; e += THREADS) {
    const int g = e / D, c = e - g * D;
    Qs[e] = rt::to_f(q[b * q_sb + (long long)(kvh * grp + g) * q_sh + c]);
  }
  if (tid < grp) {
    Ms[tid] = rt::kNegInf;
    Ls[tid] = 0.f;
  }
  float acc[MAXE];
#pragma unroll
  for (int i = 0; i < MAXE; ++i) acc[i] = 0.f;

  const int n_pages = min((seq_len + BS - 1) / BS, max_pages);
  const int p0 = window > 0 ? max(0, seq_len - window) / BS : 0;
  const int* trow = table + (long long)b * max_pages;
  __syncthreads();

  for (int p = p0; p < n_pages; ++p) {
    const long long base = (long long)trow[p] * p_sn + (long long)kvh * p_sh;
    const T* kb = kp + base;
    const T* vb = vp + base;
    if (p_sd == 1) {                         // dim contiguous: walk dims fastest
      for (int e = tid; e < BS * D; e += THREADS) {
        const int t = e / D, c = e - t * D;
        Ks[t * LD + c] = rt::to_f(kb[t * p_st + c]);
        Vs[t * LD + c] = rt::to_f(vb[t * p_st + c]);
      }
    } else {                                 // token contiguous (nhdb)
      for (int e = tid; e < BS * D; e += THREADS) {
        const int c = e / BS, t = e - c * BS;
        Ks[t * LD + c] = rt::to_f(kb[t * p_st + c * p_sd]);
        Vs[t * LD + c] = rt::to_f(vb[t * p_st + c * p_sd]);
      }
    }
    __syncthreads();

    for (int e = tid; e < grp * BS; e += THREADS) {
      const int g = e / BS, t = e - g * BS;
      const int pos = p * BS + t;
      bool ok = pos < seq_len;
      if (window > 0) ok = ok && (pos >= seq_len - window);
      float s = 0.f;
      const float* qr = Qs + g * D;
      const float* kr = Ks + t * LD;
      for (int c = 0; c < D; ++c) s += qr[c] * kr[c];
      Ss[e] = ok ? s * scale : -INFINITY;
    }
    __syncthreads();

    if (tid < grp) {
      float* sr = Ss + tid * BS;
      const float m_old = Ms[tid];
      float mx = m_old;
      for (int t = 0; t < BS; ++t) mx = fmaxf(mx, sr[t]);
      float sum = 0.f;
      for (int t = 0; t < BS; ++t) {
        const float pv = expf(sr[t] - mx);   // masked rows: exp(-inf) = 0
        sr[t] = pv;
        sum += pv;
      }
      const float a = expf(m_old - mx);
      Ls[tid] = Ls[tid] * a + sum;
      Ms[tid] = mx;
      As[tid] = a;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < MAXE; ++i) {
      const int e = tid + i * THREADS;
      if (e < nq) {
        const int g = e / D, c = e - g * D;
        const float* pr = Ss + g * BS;
        float a2 = acc[i] * As[g];
        for (int t = 0; t < BS; ++t) a2 += pr[t] * Vs[t * LD + c];
        acc[i] = a2;
      }
    }
    __syncthreads();                         // before the next page overwrites K/V
  }

#pragma unroll
  for (int i = 0; i < MAXE; ++i) {
    const int e = tid + i * THREADS;
    if (e < nq) {
      const int g = e / D, c = e - g * D;
      const float l = fmaxf(Ls[g], 1e-30f);
      o[b * o_sb + (long long)(kvh * grp + g) * o_sh + c] = rt::from_f<T>(acc[i] / l);
    }
  }
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* lens, void* o, int B, int H, int KVH, int D, int BS,
           int max_pages, long long q_sb, long long q_sh, long long p_sn,
           long long p_st, long long p_sh, long long p_sd, long long o_sb,
           long long o_sh, float scale, int window, cudaStream_t stream) {
  const int grp = H / KVH;
  const size_t smem = sizeof(float) *
      (size_t)(grp * D + 2 * BS * (D + 1) + grp * BS + 3 * grp);
  cudaError_t err = rt::allow_smem(paged_decode_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(KVH, B);
  paged_decode_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), table, lens, static_cast<T*>(o), grp, D, BS,
      max_pages, q_sb, q_sh, p_sn, p_st, p_sh, p_sd, o_sb, o_sh, scale, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rt_paged_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* seq_lens, void* o, int dtype, int B, int H, int KVH, int D,
    int BS, int max_pages, long long q_sb, long long q_sh, long long p_sn,
    long long p_st, long long p_sh, long long p_sd, long long o_sb,
    long long o_sh, float scale, int window, void* stream) {
  if (KVH <= 0 || H % KVH != 0 || D <= 0 || (H / KVH) * D > MAXGRP_D || BS <= 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(seq_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    return launch<float>(q, k_pool, v_pool, tb, ln, o, B, H, KVH, D, BS,
                         max_pages, q_sb, q_sh, p_sn, p_st, p_sh, p_sd, o_sb,
                         o_sh, scale, window, s);
  if (dtype == rt::kBF16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, tb, ln, o, B, H, KVH, D, BS,
                                 max_pages, q_sb, q_sh, p_sn, p_st, p_sh, p_sd,
                                 o_sb, o_sh, scale, window, s);
  return (int)cudaErrorInvalidValue;
}
