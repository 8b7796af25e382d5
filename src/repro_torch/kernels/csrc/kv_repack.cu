// Overlay scatter of canonical KV pages into a paged pool (the D-side
// re-page of the P->D handoff), for Hopper.
//
// Replaces: src/repro/kernels/kv_repack.py : scatter_pages_overlay
//           (_scatter_overlay_kernel, the Pallas TPU kernel that merges a
//           streamed chunk's partial head/tail pages in place).
//
// What bounds it on this card: bytes. It moves each covered element once
// (read canon, write pool) and computes nothing but a cast, so its floor
// is the bytes moved over 3.35 TB/s.
//
// Design: one block per (page, layer): the leading layer axis lets one
// launch re-page every layer of a block group, where the reference vmaps
// a per-layer kernel. Threads walk the destination page in the pool's own
// memory order (contiguous, coalesced stores) and gather from the
// canonical (bs, kv, hd) page through the strides of the matching axes,
// casting to the pool dtype on the way (round to nearest even, as
// torch/ml_dtypes cast). The canon is either whole pages or the streamed
// rows alone: `canon_off` (an element offset, negative for the latter)
// moves the page origin so that a chunk landing mid-page is read where it
// lies, with no padded copy. Rows outside the flat span [front, front +
// seq_len) are simply not written: because the pool is updated in place,
// that leaves exactly what the reference's read-merge-write would, so the
// pool stays bit-identical to the plain version.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename Tp, typename Tc>
__global__ void __launch_bounds__(THREADS)
overlay_kernel(Tp* __restrict__ pool, const Tc* __restrict__ canon,
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
    const int t = tok_axis == 0 ? i0 : (tok_axis == 1 ? i1 : i2);
    if (t < lo || t >= hi) continue;
    dst[e] = rt::cvt<Tp>(canon[base + i0 * c_s0 + i1 * c_s1 + i2 * c_s2]);
  }
}

template <typename Tp, typename Tc>
int launch(void* pool, const void* canon, const int* ids, int L, int nb, int BS,
           long long pool_sl, long long pool_sn, int D0, int D1, int D2,
           int tok_axis, long long c_s0, long long c_s1, long long c_s2,
           long long canon_sl, long long canon_sp, long long canon_off,
           int front, int seq_len, cudaStream_t stream) {
  dim3 grid(nb, L);
  overlay_kernel<Tp, Tc><<<grid, THREADS, 0, stream>>>(
      static_cast<Tp*>(pool), static_cast<const Tc*>(canon), ids, BS, pool_sl,
      pool_sn, D0, D1, D2, tok_axis, c_s0, c_s1, c_s2, canon_sl, canon_sp,
      canon_off, front, seq_len);
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
  return launch<TP, TC>(pool, canon, ids, L, nb, BS, pool_sl, pool_sn, D0,  \
                        D1, D2, tok_axis, c_s0, c_s1, c_s2, canon_sl,        \
                        canon_sp, canon_off, front, seq_len, s)
  if (pool_dtype == rt::kF32 && canon_dtype == rt::kF32) RT_OVERLAY(float, float);
  if (pool_dtype == rt::kF32 && canon_dtype == rt::kBF16) RT_OVERLAY(float, __nv_bfloat16);
  if (pool_dtype == rt::kBF16 && canon_dtype == rt::kF32) RT_OVERLAY(__nv_bfloat16, float);
  if (pool_dtype == rt::kBF16 && canon_dtype == rt::kBF16)
    RT_OVERLAY(__nv_bfloat16, __nv_bfloat16);
#undef RT_OVERLAY
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
