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
// Every kernel takes a leading layer axis, so one launch moves every layer
// of a pool, where the reference vmaps a per-layer kernel. Page ids are
// read by each block from the id list. The gather writes a separate
// buffer, so a copy from one page of a pool to another (the prefix cache's
// copy-on-write) is a gather followed by a scatter on the same stream,
// never one kernel reading and writing the same pool. Casts round to
// nearest even through rt::cvt, as torch/ml_dtypes cast.
//
// scatter_pages: many blocks per page and 16-byte accesses. Each (page,
// layer) is cut into chunks of 16 KiB of pool (page_scatter_kernel), so the
// copy-on-write shape (one 256 KiB page in each of 32 layers) launches 512
// blocks, not 32. Where the page's innermost axis is the canonical one (hd
// for nbhd and nhbd), each thread moves VEC elements per access: 8 bf16 or
// 4 f32 in 16 bytes, fewer where a pointer or stride allows less; the
// wrapper picks VEC, the largest power of two that divides every offset
// the kernel forms (kv_repack.py:vector_width). nhdb keeps the token
// innermost: tile_scatter_kernel stages a (32 token x 128 dim) tile in
// shared memory, read along hd with VEC-wide loads and written along the
// token with consecutive threads on consecutive addresses, so both sides
// stay coalesced.
//
// gather_pages is the scatter's mirror image: 16 KiB chunks of a pool page
// per block (page_gather_kernel), threads walking the canonical output in
// its memory order with VEC elements per access, where the pool page's hd
// is its unit-stride axis; otherwise (nhdb, where the token is) through a
// (32 token x 128 dim) tile in shared memory, read along the token and
// written along hd (tile_gather_kernel). The wrapper picks VEC from the
// pool's and the output's alignments (kv_repack.py:gather_vector_width).
//
// scatter_pages_overlay: the scatter's design with the overlay's row test.
// Its canon is either whole pages or the streamed rows alone: `canon_off`
// (an element offset, negative for the latter) moves the page origin so
// that a chunk landing mid-page is read where it lies, with no padded
// copy. Rows outside the flat span [front, front + seq_len) are not
// written: because the pool is updated in place, that leaves exactly what
// the reference's read-merge-write would, so the pool stays bit-identical
// to the plain version. Each page is cut into chunks of whole tokens, T of
// them (about 16 KiB of pool; a token tile of TT in nhdb), and the grid
// holds only the chunks that cover a row of the span: in the flat order
// (page, chunk) they are one contiguous run, [first, first + count), which
// the wrapper computes (kv_repack.py:overlay_plan). A block clips its
// chunk to the span once, so the row test costs nothing per access and
// canon addresses are formed for covered rows only. Where the page's hd
// is unit-stride (nbhd, nhbd: page_overlay_kernel) each access moves VEC
// elements, 16 bytes where the alignments allow (overlay_vector_width);
// nhdb goes through a shared-memory tile as tile_scatter_kernel does
// (tile_overlay_kernel).
#include <climits>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;

// VEC elements of T, moved as one access of VEC * sizeof(T) bytes.
template <int BYTES> struct RawOf;
template <> struct RawOf<2> { using T = unsigned short; };
template <> struct RawOf<4> { using T = unsigned int; };
template <> struct RawOf<8> { using T = uint2; };
template <> struct RawOf<16> { using T = uint4; };

template <typename T, int VEC>
union Vec {
  typename RawOf<sizeof(T) * VEC>::T raw;
  T v[VEC];
};

// Load VEC elements of From at p (aligned to the access), cast to To.
template <typename To, typename From, int VEC>
__device__ __forceinline__ Vec<To, VEC> load_cvt(const From* p) {
  Vec<From, VEC> x;
  x.raw = *reinterpret_cast<const decltype(x.raw)*>(p);
  Vec<To, VEC> y;
#pragma unroll
  for (int i = 0; i < VEC; ++i) y.v[i] = rt::cvt<To>(x.v[i]);
  return y;
}

constexpr int CHUNK_BYTES = 16 * 1024;     // pool bytes per block
constexpr int TT = 32, TD = 128;           // nhdb tile: tokens x dims

// scatter_pages, page (D0, D1, HD) with hd innermost (nbhd: D0 = bs,
// D1 = kv; nhbd: D0 = kv, D1 = bs). Block x: (page, chunk); y: layer.
// canon axis strides c_s0, c_s1 match D0, D1; hd's stride is 1 when
// VEC > 1 (the wrapper's choice), c_sd otherwise.
template <typename Tp, typename Tc, int VEC>
__global__ void __launch_bounds__(THREADS)
page_scatter_kernel(Tp* __restrict__ pool, const Tc* __restrict__ canon,
                    const int* __restrict__ ids, int chunks, int chunk_elems,
                    int page_elems, int D1, int HD, long long pool_sl,
                    long long pool_sn, long long c_s0, long long c_s1,
                    long long c_sd, long long canon_sl, long long canon_sp) {
  const int pg = blockIdx.x / chunks;
  const int e0 = (blockIdx.x % chunks) * chunk_elems;
  const int e1 = min(e0 + chunk_elems, page_elems);
  const int layer = blockIdx.y;
  Tp* dst = pool + layer * pool_sl + (long long)ids[pg] * pool_sn;
  const Tc* src = canon + layer * canon_sl + (long long)pg * canon_sp;
#pragma unroll 4
  for (int e = e0 + threadIdx.x * VEC; e < e1; e += THREADS * VEC) {
    const int d = e % HD;
    const int r = e / HD;
    const long long at = (r / D1) * c_s0 + (r % D1) * c_s1 + d * c_sd;
    const Vec<Tp, VEC> y = load_cvt<Tp, Tc, VEC>(src + at);
    *reinterpret_cast<decltype(y.raw)*>(dst + e) = y.raw;
  }
}

// scatter_pages into nhdb pages (kv, hd, bs): the canonical (bs, hd) slab
// of one head is transposed through a (TT x TD) tile in shared memory.
// Block x: (page, head, token tile, dim tile); y: layer.
template <typename Tp, typename Tc, int VEC>
__global__ void __launch_bounds__(THREADS)
tile_scatter_kernel(Tp* __restrict__ pool, const Tc* __restrict__ canon,
                    const int* __restrict__ ids, int BS, int KV, int HD,
                    long long pool_sl, long long pool_sn, long long c_st,
                    long long c_sh, long long c_sd, long long canon_sl,
                    long long canon_sp) {
  constexpr int LD = TD + 4 / sizeof(Tp);    // odd row stride in words
  __shared__ Tp tile[TT * LD];
  const int n_tt = (BS + TT - 1) / TT, n_td = (HD + TD - 1) / TD;
  int x = blockIdx.x;
  const int td = x % n_td; x /= n_td;
  const int tt = x % n_tt; x /= n_tt;
  const int hh = x % KV;
  const int pg = x / KV;
  const int layer = blockIdx.y;
  const int t0 = tt * TT, d0 = td * TD;
  const Tc* src = canon + layer * canon_sl + (long long)pg * canon_sp +
                  hh * c_sh;
  for (int i = threadIdx.x * VEC; i < TT * TD; i += THREADS * VEC) {
    const int t = i / TD, d = i % TD;
    if (t0 + t < BS && d0 + d < HD) {
      const Vec<Tp, VEC> y =
          load_cvt<Tp, Tc, VEC>(src + (t0 + t) * c_st + (d0 + d) * c_sd);
#pragma unroll
      for (int j = 0; j < VEC; ++j) tile[t * LD + d + j] = y.v[j];
    }
  }
  __syncthreads();
  Tp* dst = pool + layer * pool_sl + (long long)ids[pg] * pool_sn +
            (long long)hh * HD * BS;
  for (int i = threadIdx.x; i < TT * TD; i += THREADS) {
    const int d = i / TT, t = i % TT;
    if (t0 + t < BS && d0 + d < HD)
      dst[(d0 + d) * BS + t0 + t] = tile[t * LD + d];
  }
}

// Calls f(std::integral_constant<int, V>{}) for V = vec: 1, 2, 4, or 8
// where VMAX allows it; any other vec is an invalid value.
template <int VMAX, typename F>
int with_vec(int vec, F f) {
  switch (vec) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8:
      if constexpr (VMAX >= 8) return f(std::integral_constant<int, 8>{});
      break;
  }
  return (int)cudaErrorInvalidValue;
}

// The overlay's chunk: flat chunk g = first + x holds tokens [t0, t0 + T)
// of page g / n_c; its covered tokens are [lo, hi), empty if lo >= hi.
struct OverlayChunk {
  int pg, lo, hi;
  __device__ OverlayChunk(int g, int BS, int T, int n_c, int front, int end)
      : pg(g / n_c) {
    const int t0 = (g % n_c) * T;
    lo = max(t0, front - pg * BS);
    hi = min(min(t0 + T, BS), end - pg * BS);
  }
};

// scatter_pages_overlay into pages with hd innermost (nbhd: (bs, kv, hd);
// nhbd: (kv, bs, hd)). Block x: a covered chunk; y: layer. Threads walk the
// chunk's covered tokens in the page's memory order, VEC elements per
// access; canon is read through its (token, head, dim) strides c_st, c_sh,
// c_sd (c_sd is 1 when VEC > 1, the wrapper's choice). Canon element of
// page row t: layer * canon_sl + pg * canon_sp + canon_off + t * c_st + ...
template <typename Tp, typename Tc, int VEC>
__global__ void __launch_bounds__(THREADS)
page_overlay_kernel(Tp* __restrict__ pool, const Tc* __restrict__ canon,
                    const int* __restrict__ ids, int BS, int KV, int HD,
                    bool nbhd, long long pool_sl, long long pool_sn,
                    long long c_st, long long c_sh, long long c_sd,
                    long long canon_sl, long long canon_sp,
                    long long canon_off, int front, int end, int T, int n_c,
                    int first) {
  const OverlayChunk c(first + blockIdx.x, BS, T, n_c, front, end);
  if (c.lo >= c.hi) return;
  const int layer = blockIdx.y;
  // (a0, a1, d): (token, head, dim) in nbhd, (head, token, dim) in nhbd,
  // tokens counted from lo
  const int n_tok = c.hi - c.lo;
  const int D1 = nbhd ? KV : n_tok;
  const long long p_s0 = nbhd ? (long long)KV * HD : (long long)BS * HD;
  const long long c_s0 = nbhd ? c_st : c_sh, c_s1 = nbhd ? c_sh : c_st;
  Tp* dst = pool + layer * pool_sl + (long long)ids[c.pg] * pool_sn +
            (long long)c.lo * (nbhd ? KV * HD : HD);
  // row lo is covered, so this offset lies inside canon
  const Tc* src = canon + (layer * canon_sl + c.pg * canon_sp + canon_off +
                           c.lo * c_st);
  const int n = n_tok * KV * HD;
#pragma unroll 4
  for (int e = threadIdx.x * VEC; e < n; e += THREADS * VEC) {
    const int d = e % HD;
    const int r = e / HD;
    const int a0 = r / D1, a1 = r - a0 * D1;
    const Vec<Tp, VEC> y =
        load_cvt<Tp, Tc, VEC>(src + a0 * c_s0 + a1 * c_s1 + d * c_sd);
    *reinterpret_cast<decltype(y.raw)*>(dst + a0 * p_s0 + a1 * HD + d) =
        y.raw;
  }
}

// scatter_pages_overlay into nhdb pages (kv, hd, bs): one head's covered
// (token, hd) rows of a chunk of T <= TT tokens are read along hd, VEC
// elements per access, into a (TT x TD) tile in shared memory, then
// written along the token with consecutive threads on consecutive
// addresses. Block x: (covered chunk, head, dim tile); y: layer.
template <typename Tp, typename Tc, int VEC>
__global__ void __launch_bounds__(THREADS)
tile_overlay_kernel(Tp* __restrict__ pool, const Tc* __restrict__ canon,
                    const int* __restrict__ ids, int BS, int KV, int HD,
                    long long pool_sl, long long pool_sn, long long c_st,
                    long long c_sh, long long c_sd, long long canon_sl,
                    long long canon_sp, long long canon_off, int front,
                    int end, int T, int n_c, int first) {
  constexpr int LD = TD + 4 / sizeof(Tp);    // odd row stride in words
  __shared__ Tp tile[TT * LD];
  const int n_td = (HD + TD - 1) / TD;
  int x = blockIdx.x;
  const int td = x % n_td; x /= n_td;
  const int hh = x % KV;
  const OverlayChunk c(first + x / KV, BS, T, n_c, front, end);
  if (c.lo >= c.hi) return;                  // the whole block, before the barrier
  const int layer = blockIdx.y;
  const int n_tok = c.hi - c.lo, d0 = td * TD;
  const Tc* src = canon + (layer * canon_sl + c.pg * canon_sp + canon_off +
                           c.lo * c_st + hh * c_sh + d0 * c_sd);
  for (int i = threadIdx.x * VEC; i < n_tok * TD; i += THREADS * VEC) {
    const int t = i / TD, d = i % TD;
    if (d0 + d < HD) {
      const Vec<Tp, VEC> y = load_cvt<Tp, Tc, VEC>(src + t * c_st + d * c_sd);
#pragma unroll
      for (int j = 0; j < VEC; ++j) tile[t * LD + d + j] = y.v[j];
    }
  }
  __syncthreads();
  Tp* dst = pool + layer * pool_sl + (long long)ids[c.pg] * pool_sn +
            ((long long)hh * HD + d0) * BS + c.lo;
  for (int i = threadIdx.x; i < n_tok * TD; i += THREADS) {
    const int d = i / n_tok, t = i % n_tok;
    if (d0 + d < HD) dst[(long long)d * BS + t] = tile[t * LD + d];
  }
}

template <typename Tp, typename Tc, int VEC>
int launch_overlay(void* pool, const void* canon, const int* ids, int L,
                   int BS, int KV, int HD, int layout, long long pool_sl,
                   long long pool_sn, long long c_st, long long c_sh,
                   long long c_sd, long long canon_sl, long long canon_sp,
                   long long canon_off, int front, int end, int T, int first,
                   int count, cudaStream_t stream) {
  Tp* p = static_cast<Tp*>(pool);
  const Tc* c = static_cast<const Tc*>(canon);
  const int n_c = (BS + T - 1) / T;
  if (layout == 2) {                                         // nhdb
    const long long blocks = (long long)count * KV * ((HD + TD - 1) / TD);
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    tile_overlay_kernel<Tp, Tc, VEC>
        <<<dim3((unsigned)blocks, L), THREADS, 0, stream>>>(
            p, c, ids, BS, KV, HD, pool_sl, pool_sn, c_st, c_sh, c_sd,
            canon_sl, canon_sp, canon_off, front, end, T, n_c, first);
  } else {                                                   // nbhd, nhbd
    page_overlay_kernel<Tp, Tc, VEC><<<dim3(count, L), THREADS, 0, stream>>>(
        p, c, ids, BS, KV, HD, layout == 0, pool_sl, pool_sn, c_st, c_sh,
        c_sd, canon_sl, canon_sp, canon_off, front, end, T, n_c, first);
  }
  return (int)cudaGetLastError();
}

template <typename Tp, typename Tc, int VEC>
int launch_scatter(void* pool, const void* canon, const int* ids, int L,
                   int nb, int BS, int KV, int HD, int layout,
                   long long pool_sl, long long pool_sn, long long c_st,
                   long long c_sh, long long c_sd, long long canon_sl,
                   long long canon_sp, cudaStream_t stream) {
  Tp* p = static_cast<Tp*>(pool);
  const Tc* c = static_cast<const Tc*>(canon);
  if (layout == 2) {                                         // nhdb
    const int blocks = nb * KV * ((BS + TT - 1) / TT) * ((HD + TD - 1) / TD);
    tile_scatter_kernel<Tp, Tc, VEC><<<dim3(blocks, L), THREADS, 0, stream>>>(
        p, c, ids, BS, KV, HD, pool_sl, pool_sn, c_st, c_sh, c_sd, canon_sl,
        canon_sp);
  } else {                                                   // nbhd, nhbd
    const int page_elems = BS * KV * HD;
    const int chunk_elems = CHUNK_BYTES / (int)sizeof(Tp);
    const int chunks = (page_elems + chunk_elems - 1) / chunk_elems;
    const bool nbhd = layout == 0;
    page_scatter_kernel<Tp, Tc, VEC>
        <<<dim3(nb * chunks, L), THREADS, 0, stream>>>(
            p, c, ids, chunks, chunk_elems, page_elems, nbhd ? KV : BS, HD,
            pool_sl, pool_sn, nbhd ? c_st : c_sh, nbhd ? c_sh : c_st, c_sd,
            canon_sl, canon_sp);
  }
  return (int)cudaGetLastError();
}

template <typename Tp, typename Tc>
int scatter_vec(int vec, void* pool, const void* canon, const int* ids, int L,
                int nb, int BS, int KV, int HD, int layout, long long pool_sl,
                long long pool_sn, long long c_st, long long c_sh,
                long long c_sd, long long canon_sl, long long canon_sp,
                cudaStream_t stream) {
  constexpr int VMAX = 16 / (sizeof(Tp) > sizeof(Tc) ? sizeof(Tp) : sizeof(Tc));
  return with_vec<VMAX>(vec, [&](auto v) {
    return launch_scatter<Tp, Tc, decltype(v)::value>(
        pool, canon, ids, L, nb, BS, KV, HD, layout, pool_sl, pool_sn, c_st,
        c_sh, c_sd, canon_sl, canon_sp, stream);
  });
}

template <typename Tp, typename Tc>
int overlay_vec(int vec, void* pool, const void* canon, const int* ids, int L,
                int BS, int KV, int HD, int layout, long long pool_sl,
                long long pool_sn, long long c_st, long long c_sh,
                long long c_sd, long long canon_sl, long long canon_sp,
                long long canon_off, int front, int end, int T, int first,
                int count, cudaStream_t stream) {
  constexpr int VMAX = 16 / (sizeof(Tp) > sizeof(Tc) ? sizeof(Tp) : sizeof(Tc));
  return with_vec<VMAX>(vec, [&](auto v) {
    return launch_overlay<Tp, Tc, decltype(v)::value>(
        pool, canon, ids, L, BS, KV, HD, layout, pool_sl, pool_sn, c_st, c_sh,
        c_sd, canon_sl, canon_sp, canon_off, front, end, T, first, count,
        stream);
  });
}

// gather_pages from pages with hd innermost (p_sd == 1: nbhd, nhbd).
// Block x: (page, chunk); y: layer. Threads walk the canonical output in
// its memory order, VEC elements per access, and read the pool page
// through its token and head strides p_st, p_sh.
template <typename To, typename Tp, int VEC>
__global__ void __launch_bounds__(THREADS)
page_gather_kernel(To* __restrict__ out, const Tp* __restrict__ pool,
                   const int* __restrict__ ids, int chunks, int chunk_elems,
                   int page_elems, int KV, int HD, long long pool_sl,
                   long long pool_sn, long long p_st, long long p_sh,
                   long long out_sl, long long out_sp) {
  const int pg = blockIdx.x / chunks;
  const int e0 = (blockIdx.x % chunks) * chunk_elems;
  const int e1 = min(e0 + chunk_elems, page_elems);
  const int layer = blockIdx.y;
  const Tp* src = pool + layer * pool_sl + (long long)ids[pg] * pool_sn;
  To* dst = out + layer * out_sl + (long long)pg * out_sp;
#pragma unroll 4
  for (int e = e0 + threadIdx.x * VEC; e < e1; e += THREADS * VEC) {
    const int d = e % HD;
    const int r = e / HD;
    const Vec<To, VEC> y =
        load_cvt<To, Tp, VEC>(src + (r / KV) * p_st + (r % KV) * p_sh + d);
    *reinterpret_cast<decltype(y.raw)*>(dst + e) = y.raw;
  }
}

// gather_pages from pages whose hd is not the unit-stride axis (nhdb: the
// token is): one head's (bs, hd) slab is read along the token with
// consecutive threads on consecutive addresses into a (TT x TD) tile in
// shared memory, then written along hd, VEC elements per access.
// Block x: (page, head, token tile, dim tile); y: layer.
template <typename To, typename Tp, int VEC>
__global__ void __launch_bounds__(THREADS)
tile_gather_kernel(To* __restrict__ out, const Tp* __restrict__ pool,
                   const int* __restrict__ ids, int BS, int KV, int HD,
                   long long pool_sl, long long pool_sn, long long p_st,
                   long long p_sh, long long p_sd, long long out_sl,
                   long long out_sp) {
  constexpr int LD = TD + 4 / sizeof(To);    // odd row stride in words
  __shared__ To tile[TT * LD];
  const int n_tt = (BS + TT - 1) / TT, n_td = (HD + TD - 1) / TD;
  int x = blockIdx.x;
  const int td = x % n_td; x /= n_td;
  const int tt = x % n_tt; x /= n_tt;
  const int hh = x % KV;
  const int pg = x / KV;
  const int layer = blockIdx.y;
  const int t0 = tt * TT, d0 = td * TD;
  const Tp* src = pool + layer * pool_sl + (long long)ids[pg] * pool_sn +
                  hh * p_sh;
  for (int i = threadIdx.x; i < TT * TD; i += THREADS) {
    const int d = i / TT, t = i % TT;
    if (t0 + t < BS && d0 + d < HD)
      tile[t * LD + d] = rt::cvt<To>(src[(t0 + t) * p_st + (d0 + d) * p_sd]);
  }
  __syncthreads();
  To* dst = out + layer * out_sl + (long long)pg * out_sp + (long long)hh * HD;
  for (int i = threadIdx.x * VEC; i < TT * TD; i += THREADS * VEC) {
    const int t = i / TD, d = i % TD;
    if (t0 + t < BS && d0 + d < HD) {
      Vec<To, VEC> y;
#pragma unroll
      for (int j = 0; j < VEC; ++j) y.v[j] = tile[t * LD + d + j];
      *reinterpret_cast<decltype(y.raw)*>(
          dst + (long long)(t0 + t) * KV * HD + d0 + d) = y.raw;
    }
  }
}

template <typename To, typename Tp, int VEC>
int launch_gather(void* out, const void* pool, const int* ids, int L, int nb,
                  int BS, int KV, int HD, long long pool_sl, long long pool_sn,
                  long long p_st, long long p_sh, long long p_sd,
                  long long out_sl, long long out_sp, cudaStream_t stream) {
  To* o = static_cast<To*>(out);
  const Tp* p = static_cast<const Tp*>(pool);
  if (p_sd != 1) {
    const int blocks = nb * KV * ((BS + TT - 1) / TT) * ((HD + TD - 1) / TD);
    tile_gather_kernel<To, Tp, VEC><<<dim3(blocks, L), THREADS, 0, stream>>>(
        o, p, ids, BS, KV, HD, pool_sl, pool_sn, p_st, p_sh, p_sd, out_sl,
        out_sp);
  } else {
    const int page_elems = BS * KV * HD;
    const int chunk_elems = CHUNK_BYTES / (int)sizeof(Tp);
    const int chunks = (page_elems + chunk_elems - 1) / chunk_elems;
    page_gather_kernel<To, Tp, VEC>
        <<<dim3(nb * chunks, L), THREADS, 0, stream>>>(
            o, p, ids, chunks, chunk_elems, page_elems, KV, HD, pool_sl,
            pool_sn, p_st, p_sh, out_sl, out_sp);
  }
  return (int)cudaGetLastError();
}

template <typename To, typename Tp>
int gather_vec(int vec, void* out, const void* pool, const int* ids, int L,
               int nb, int BS, int KV, int HD, long long pool_sl,
               long long pool_sn, long long p_st, long long p_sh,
               long long p_sd, long long out_sl, long long out_sp,
               cudaStream_t stream) {
  constexpr int VMAX = 16 / (sizeof(To) > sizeof(Tp) ? sizeof(To) : sizeof(Tp));
  return with_vec<VMAX>(vec, [&](auto v) {
    return launch_gather<To, Tp, decltype(v)::value>(
        out, pool, ids, L, nb, BS, KV, HD, pool_sl, pool_sn, p_st, p_sh, p_sd,
        out_sl, out_sp, stream);
  });
}

}  // namespace

// canon strides by canonical axis (token, head, dim) in elements, and the
// page origin's offset canon_off; layout 0 nbhd, 1 nhbd, 2 nhdb. The wrapper
// plans the grid (kv_repack.py:overlay_plan): chunks of T tokens (T <= TT in
// nhdb), the covered ones flat chunks [first, first + count); vec: elements
// per access (1, 2, 4, or 8 for bf16 -> bf16), from the alignments.
extern "C" int rt_scatter_pages_overlay(
    void* pool, const void* canon, const void* block_ids, int pool_dtype,
    int canon_dtype, int L, int nb, int BS, int KV, int HD, int layout,
    long long pool_sl, long long pool_sn, long long c_st, long long c_sh,
    long long c_sd, long long canon_sl, long long canon_sp,
    long long canon_off, int front, int seq_len, int T, int first, int count,
    int vec, void* stream) {
  if (BS <= 0 || KV <= 0 || HD <= 0 || L > 65535 || layout < 0 ||
      layout > 2 || vec <= 0 || HD % vec != 0 || T <= 0 || T > BS ||
      (layout == 2 && T > TT) || first < 0 || count < 0 ||
      (long long)first + count > (long long)nb * ((BS + T - 1) / T))
    return (int)cudaErrorInvalidValue;
  if (L <= 0 || count == 0 || seq_len <= 0) return 0;
  const int* ids = static_cast<const int*>(block_ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int end = front + seq_len;
#define RT_OVERLAY(TP, TC)                                                   \
  return overlay_vec<TP, TC>(vec, pool, canon, ids, L, BS, KV, HD, layout,   \
                             pool_sl, pool_sn, c_st, c_sh, c_sd, canon_sl,   \
                             canon_sp, canon_off, front, end, T, first,      \
                             count, s)
  if (pool_dtype == rt::kF32 && canon_dtype == rt::kF32) RT_OVERLAY(float, float);
  if (pool_dtype == rt::kF32 && canon_dtype == rt::kBF16) RT_OVERLAY(float, __nv_bfloat16);
  if (pool_dtype == rt::kBF16 && canon_dtype == rt::kF32) RT_OVERLAY(__nv_bfloat16, float);
  if (pool_dtype == rt::kBF16 && canon_dtype == rt::kBF16)
    RT_OVERLAY(__nv_bfloat16, __nv_bfloat16);
#undef RT_OVERLAY
  return (int)cudaErrorInvalidValue;
}

// canon strides by canonical axis (token, head, dim) in elements; layout
// 0 nbhd, 1 nhbd, 2 nhdb; vec: elements per access (1, 2, 4, or 8 for
// bf16 -> bf16), chosen by the wrapper from the alignments.
extern "C" int rt_scatter_pages(
    void* pool, const void* canon, const void* block_ids, int pool_dtype,
    int canon_dtype, int L, int nb, int BS, int KV, int HD, int layout,
    long long pool_sl, long long pool_sn, long long c_st, long long c_sh,
    long long c_sd, long long canon_sl, long long canon_sp, int vec,
    void* stream) {
  if (BS <= 0 || KV <= 0 || HD <= 0 || L > 65535 || layout < 0 || layout > 2 ||
      vec <= 0 || HD % vec != 0)
    return (int)cudaErrorInvalidValue;
  if (L <= 0 || nb <= 0) return 0;
  const int* ids = static_cast<const int*>(block_ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_SCATTER(TP, TC)                                                   \
  return scatter_vec<TP, TC>(vec, pool, canon, ids, L, nb, BS, KV, HD,       \
                             layout, pool_sl, pool_sn, c_st, c_sh, c_sd,     \
                             canon_sl, canon_sp, s)
  if (pool_dtype == rt::kF32 && canon_dtype == rt::kF32) RT_SCATTER(float, float);
  if (pool_dtype == rt::kF32 && canon_dtype == rt::kBF16) RT_SCATTER(float, __nv_bfloat16);
  if (pool_dtype == rt::kBF16 && canon_dtype == rt::kF32) RT_SCATTER(__nv_bfloat16, float);
  if (pool_dtype == rt::kBF16 && canon_dtype == rt::kBF16)
    RT_SCATTER(__nv_bfloat16, __nv_bfloat16);
#undef RT_SCATTER
  return (int)cudaErrorInvalidValue;
}

// vec: elements per access (1, 2, 4, or 8 for bf16 -> bf16), chosen by the
// wrapper from the alignments; pages whose hd stride is not 1 go through
// the shared-memory tile.
extern "C" int rt_gather_pages(
    void* out, const void* pool, const void* block_ids, int out_dtype,
    int pool_dtype, int L, int nb, int BS, int KV, int HD, long long pool_sl,
    long long pool_sn, long long p_st, long long p_sh, long long p_sd,
    long long out_sl, long long out_sp, int vec, void* stream) {
  if (BS <= 0 || KV <= 0 || HD <= 0 || L > 65535 || vec <= 0 || HD % vec != 0)
    return (int)cudaErrorInvalidValue;
  if (L <= 0 || nb <= 0) return 0;
  const int* ids = static_cast<const int*>(block_ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_GATHER(TO, TP)                                                    \
  return gather_vec<TO, TP>(vec, out, pool, ids, L, nb, BS, KV, HD, pool_sl, \
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
