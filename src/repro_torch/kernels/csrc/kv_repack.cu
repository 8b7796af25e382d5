// Page gather / scatter between a paged KV pool and canonical pages, and
// the overlay scatter of the D-side re-page of the P->D handoff, for Hopper.
//
// Replaces: src/repro/kernels/kv_repack.py
//   gather_pages          (_gather_kernel): pool pages at block_ids, any of
//                         nbhd / nhbd / nhdb -> canonical (nb, bs, kv, hd),
//                         cast to the output dtype;
//   scatter_pages         (_scatter_kernel): canonical pages -> the pool's
//                         layout at block_ids, cast, in place;
//   scatter_pages_overlay (_scatter_overlay_kernel): the same, keeping the
//                         rows outside a streamed chunk's span.
// `repack` (paper Fig. 3) composes gather and scatter in kv_repack.py.
//
// What bounds them on this card: bytes. Each moves every covered element
// once (one read, one write) and computes nothing but a cast, so the floor
// is the bytes moved over 3.35 TB/s.
//
// Design: one block per (page, layer): the leading layer axis lets one
// launch move every layer of a pool, where the reference vmaps a per-layer
// kernel. Threads walk the destination page in its own memory order
// (contiguous, coalesced stores) and read the source page through the
// strides of the matching axes, casting on the way (round to nearest even
// through rt::cvt, as torch/ml_dtypes cast). Page ids are read by each
// block from the id list; the gather writes a separate buffer, so a copy
// from one page of a pool to another (the prefix cache's copy-on-write)
// is a gather followed by a scatter on the same stream, never one kernel
// reading and writing the same pool.
//
// Overlay: the canon is either whole pages or the streamed rows alone:
// `canon_off` (an element offset, negative for the latter) moves the page
// origin so that a chunk landing mid-page is read where it lies, with no
// padded copy. Rows outside the flat span [front, front + seq_len) are
// simply not written: because the pool is updated in place, that leaves
// exactly what the reference's read-merge-write would, so the pool stays
// bit-identical to the plain version. The plain scatter is the same code
// with the row test compiled out.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// kRows: test each row against [front, front + seq_len) (overlay); without
// it every row of every page is written (scatter_pages).
template <typename Tp, typename Tc, bool kRows>
__global__ void __launch_bounds__(THREADS)
scatter_kernel(Tp* __restrict__ pool, const Tc* __restrict__ canon,
               const int* __restrict__ ids, int BS,
               long long pool_sl, long long pool_sn,
               int D0, int D1, int D2, int tok_axis,
               long long c_s0, long long c_s1, long long c_s2,
               long long canon_sl, long long canon_sp, long long canon_off,
               int front, int seq_len) {
  const int pg = blockIdx.x;
  const int layer = blockIdx.y;
  Tp* dst = pool + layer * pool_sl + (long long)ids[pg] * pool_sn;
  // element offset of this page's row 0 in canon; only covered rows are read
  const long long base = layer * canon_sl + (long long)pg * canon_sp + canon_off;
  const int n = D0 * D1 * D2;
  const int lo = front - pg * BS;              // covered rows of this page:
  const int hi = front + seq_len - pg * BS;    // lo <= t < hi
  for (int e = threadIdx.x; e < n; e += THREADS) {
    const int i2 = e % D2;
    const int r = e / D2;
    const int i1 = r % D1;
    const int i0 = r / D1;
    if constexpr (kRows) {
      const int t = tok_axis == 0 ? i0 : (tok_axis == 1 ? i1 : i2);
      if (t < lo || t >= hi) continue;
    }
    dst[e] = rt::cvt<Tp>(canon[base + i0 * c_s0 + i1 * c_s1 + i2 * c_s2]);
  }
}

template <typename Tp, typename Tc, bool kRows>
int launch_scatter(void* pool, const void* canon, const int* ids, int L,
                   int nb, int BS, long long pool_sl, long long pool_sn,
                   int D0, int D1, int D2, int tok_axis, long long c_s0,
                   long long c_s1, long long c_s2, long long canon_sl,
                   long long canon_sp, long long canon_off, int front,
                   int seq_len, cudaStream_t stream) {
  dim3 grid(nb, L);
  scatter_kernel<Tp, Tc, kRows><<<grid, THREADS, 0, stream>>>(
      static_cast<Tp*>(pool), static_cast<const Tc*>(canon), ids, BS, pool_sl,
      pool_sn, D0, D1, D2, tok_axis, c_s0, c_s1, c_s2, canon_sl, canon_sp,
      canon_off, front, seq_len);
  return (int)cudaGetLastError();
}

// Pool pages -> canonical (bs, kv, hd) pages. Threads walk the output page
// contiguously and read the pool page through its (token, head, dim)
// strides p_st, p_sh, p_sd.
template <typename To, typename Tp>
__global__ void __launch_bounds__(THREADS)
gather_kernel(To* __restrict__ out, const Tp* __restrict__ pool,
              const int* __restrict__ ids, int BS, int KV, int HD,
              long long pool_sl, long long pool_sn, long long p_st,
              long long p_sh, long long p_sd, long long out_sl,
              long long out_sp) {
  const int pg = blockIdx.x;
  const int layer = blockIdx.y;
  const Tp* src = pool + layer * pool_sl + (long long)ids[pg] * pool_sn;
  To* dst = out + layer * out_sl + (long long)pg * out_sp;
  const int n = BS * KV * HD;
  for (int e = threadIdx.x; e < n; e += THREADS) {
    const int d = e % HD;
    const int r = e / HD;
    const int h = r % KV;
    const int t = r / KV;
    dst[e] = rt::cvt<To>(src[t * p_st + h * p_sh + d * p_sd]);
  }
}

template <typename To, typename Tp>
int launch_gather(void* out, const void* pool, const int* ids, int L, int nb,
                  int BS, int KV, int HD, long long pool_sl, long long pool_sn,
                  long long p_st, long long p_sh, long long p_sd,
                  long long out_sl, long long out_sp, cudaStream_t stream) {
  dim3 grid(nb, L);
  gather_kernel<To, Tp><<<grid, THREADS, 0, stream>>>(
      static_cast<To*>(out), static_cast<const Tp*>(pool), ids, BS, KV, HD,
      pool_sl, pool_sn, p_st, p_sh, p_sd, out_sl, out_sp);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rt_scatter_pages_overlay(
    void* pool, const void* canon, const void* block_ids, int pool_dtype,
    int canon_dtype, int L, int nb, int BS, long long pool_sl,
    long long pool_sn, int D0, int D1, int D2, int tok_axis, long long c_s0,
    long long c_s1, long long c_s2, long long canon_sl, long long canon_sp,
    long long canon_off, int front, int seq_len, void* stream) {
  if (tok_axis < 0 || tok_axis > 2 || BS <= 0 || L > 65535)
    return (int)cudaErrorInvalidValue;
  if (L <= 0 || nb <= 0 || seq_len <= 0) return 0;
  const int* ids = static_cast<const int*>(block_ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_OVERLAY(TP, TC)                                                   \
  return launch_scatter<TP, TC, true>(pool, canon, ids, L, nb, BS, pool_sl,  \
                                      pool_sn, D0, D1, D2, tok_axis, c_s0,   \
                                      c_s1, c_s2, canon_sl, canon_sp,        \
                                      canon_off, front, seq_len, s)
  if (pool_dtype == rt::kF32 && canon_dtype == rt::kF32) RT_OVERLAY(float, float);
  if (pool_dtype == rt::kF32 && canon_dtype == rt::kBF16) RT_OVERLAY(float, __nv_bfloat16);
  if (pool_dtype == rt::kBF16 && canon_dtype == rt::kF32) RT_OVERLAY(__nv_bfloat16, float);
  if (pool_dtype == rt::kBF16 && canon_dtype == rt::kBF16)
    RT_OVERLAY(__nv_bfloat16, __nv_bfloat16);
#undef RT_OVERLAY
  return (int)cudaErrorInvalidValue;
}

extern "C" int rt_scatter_pages(
    void* pool, const void* canon, const void* block_ids, int pool_dtype,
    int canon_dtype, int L, int nb, int BS, long long pool_sl,
    long long pool_sn, int D0, int D1, int D2, long long c_s0, long long c_s1,
    long long c_s2, long long canon_sl, long long canon_sp, void* stream) {
  if (BS <= 0 || L > 65535) return (int)cudaErrorInvalidValue;
  if (L <= 0 || nb <= 0) return 0;
  const int* ids = static_cast<const int*>(block_ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_SCATTER(TP, TC)                                                   \
  return launch_scatter<TP, TC, false>(pool, canon, ids, L, nb, BS, pool_sl, \
                                       pool_sn, D0, D1, D2, 0, c_s0, c_s1,   \
                                       c_s2, canon_sl, canon_sp, 0, 0,       \
                                       nb * BS, s)
  if (pool_dtype == rt::kF32 && canon_dtype == rt::kF32) RT_SCATTER(float, float);
  if (pool_dtype == rt::kF32 && canon_dtype == rt::kBF16) RT_SCATTER(float, __nv_bfloat16);
  if (pool_dtype == rt::kBF16 && canon_dtype == rt::kF32) RT_SCATTER(__nv_bfloat16, float);
  if (pool_dtype == rt::kBF16 && canon_dtype == rt::kBF16)
    RT_SCATTER(__nv_bfloat16, __nv_bfloat16);
#undef RT_SCATTER
  return (int)cudaErrorInvalidValue;
}

extern "C" int rt_gather_pages(
    void* out, const void* pool, const void* block_ids, int out_dtype,
    int pool_dtype, int L, int nb, int BS, int KV, int HD, long long pool_sl,
    long long pool_sn, long long p_st, long long p_sh, long long p_sd,
    long long out_sl, long long out_sp, void* stream) {
  if (BS <= 0 || KV <= 0 || HD <= 0 || L > 65535)
    return (int)cudaErrorInvalidValue;
  if (L <= 0 || nb <= 0) return 0;
  const int* ids = static_cast<const int*>(block_ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_GATHER(TO, TP)                                                    \
  return launch_gather<TO, TP>(out, pool, ids, L, nb, BS, KV, HD, pool_sl,   \
                               pool_sn, p_st, p_sh, p_sd, out_sl, out_sp, s)
  if (out_dtype == rt::kF32 && pool_dtype == rt::kF32) RT_GATHER(float, float);
  if (out_dtype == rt::kF32 && pool_dtype == rt::kBF16) RT_GATHER(float, __nv_bfloat16);
  if (out_dtype == rt::kBF16 && pool_dtype == rt::kF32) RT_GATHER(__nv_bfloat16, float);
  if (out_dtype == rt::kBF16 && pool_dtype == rt::kBF16)
    RT_GATHER(__nv_bfloat16, __nv_bfloat16);
#undef RT_GATHER
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
