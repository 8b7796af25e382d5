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
// The design is about keeping enough bytes in flight on every SM.
//
// The split (flash-decoding). The Pallas kernel carries the running max,
// sum and output across a sequential page axis of its grid; here that axis
// is cut across blocks. Each block of paged_split_kernel takes one (page
// range, KV head, sequence): `pps` pages from split * pps, clipped to the
// sequence's pages (from the first page inside the sliding window, when
// there is one). The wrapper picks the number of splits from what the host
// knows without a sync (the block table's width, the batch, the KV heads
// and the SM count), so at the main path's shape 8 sequences x 32 heads
// become over a thousand blocks, and one 2048-token sequence still fills
// the card. A block whose range lies past its sequence exits at once.
// With one split the block writes the output itself; otherwise it writes
// float32 partials (its max m, sum l and unnormalised P.V) and
// paged_combine_kernel merges the splits of each (sequence, head) with the
// usual rescaling by exp(m_s - max m), in float32, rounding once at the
// store. The combine reads seq_lens on the device, so it visits only the
// splits that hold pages.
//
// The head split. One block serves the query heads of its KV head, so K
// and V are read once per group; a group wider than the lanes' registers
// hold (more than 2048 flattened (head, dim) query elements: RecurrentGemma's
// 16 heads x 256 on one KV head) is cut into `hs` blocks of grp / hs heads
// each (grid axis y = KV head x hs), each of which reads the KV head's
// pages (the second read may come from L2).
//
// Loads in flight. The block's 128 threads stage each page's K and V rows
// of its KV head into a ring of 3 shared-memory stages (fewer where 3 do
// not fit) with cp.async, 16 bytes per thread per copy where the pool's
// alignment allows (fewer bytes otherwise), neighbouring threads on
// neighbouring addresses; the copies of page i + 2 are issued before page
// i is used, so at the main shape about 32 KB per block (4 blocks per SM)
// are in flight while the warps compute. Token-innermost pages (nhdb) are
// read along the token and transposed into the same row-major stage
// through registers, without cp.async: a simpler path.
//
// Arithmetic, all float32. q lives in registers: lane l of every warp
// holds elements j*128 + 4l .. 4l+3 of the block's flattened (head, dim)
// query, head dims padded to 32, 64, 128 or 256. Each warp scores its own
// rows of the page (a row's dot product is 4 products per lane and a
// shuffle reduction over the lanes of its head) and keeps its own online
// softmax state (running max and sum, computed across the lanes, no single
// thread owning it) and accumulator; the block merges its 4 warps at the
// end through shared memory. The pool is
// addressed through its (block, token, head, dim) strides, which is how one
// kernel serves all three layouts. Idle decode slots point at the
// engine's scratch block with seq_len 1 and read only that page.
#include "common.cuh"

namespace {

constexpr int NW = 4;                    // warps per block
constexpr int THREADS = NW * 32;
constexpr int SMEM_MAX = 227 * 1024;
constexpr unsigned FULL = 0xffffffffu;

using rt::cp_async;
using rt::cp_commit;
using rt::cp_wait;
using rt::row4;

// One page of one KV head, K and V, into row-major [BS][P] stages. cb > 0:
// token rows of d contiguous elements, cb bytes per cp.async; cb == 0: any
// strides, read along the token and transposed through registers.
template <typename T>
__device__ __forceinline__ void stage_page(T* sk, T* sv, const T* kb,
                                           const T* vb, int BS, int d, int P,
                                           long long p_st, long long p_sd,
                                           int cb) {
  if (cb > 0) {
    const int ce = cb / (int)sizeof(T);
    const int cpr = d / ce;
    for (int i = threadIdx.x; i < BS * cpr; i += THREADS) {
      const int t = i / cpr, c = (i - t * cpr) * ce;
      cp_async(sk + t * P + c, kb + t * p_st + c, cb);
      cp_async(sv + t * P + c, vb + t * p_st + c, cb);
    }
  } else {
    for (int i = threadIdx.x; i < BS * d; i += THREADS) {
      const int c = i / BS, t = i - c * BS;
      sk[t * P + c] = kb[t * p_st + c * p_sd];
      sv[t * P + c] = vb[t * p_st + c * p_sd];
    }
  }
}

// HD: head dim padded to 32/64/128/256; NJ: 128-element chunks of the
// block's flattened query per lane (a power of two >= grp * HD / 128),
// where grp is the block's query heads: a KV head's group over hs.
template <typename T, int HD, int NJ>
__global__ void __launch_bounds__(THREADS)
paged_split_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                   const T* __restrict__ vp, const int* __restrict__ table,
                   const int* __restrict__ lens, T* __restrict__ o,
                   float* __restrict__ part_acc, float* __restrict__ part_ml,
                   int H, int grp, int hs, int d, int BS, int max_pages,
                   int pps, int P, int nst, int cb, long long q_sb,
                   long long q_sh,
                   long long p_sn, long long p_st, long long p_sh,
                   long long p_sd, long long o_sb, long long o_sh,
                   float scale, int window) {
  constexpr int LPH = HD >= 128 ? 32 : HD / 4;    // lanes per head
  constexpr int CPH = HD >= 128 ? HD / 128 : 1;   // chunks per head
  constexpr int R = NJ >= 4 ? 1 : 4 / NJ;         // rows a warp scores at once
  static_assert(NJ % CPH == 0, "a head spans whole chunks");
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);

  const int split = blockIdx.x, kvh = blockIdx.y / hs, b = blockIdx.z;
  const int h0 = blockIdx.y * grp;          // this block's first query head
  const int S = gridDim.x;
  const int seq_len = lens[b];
  const int n_pages = min((seq_len + BS - 1) / BS, max_pages);
  const int p0 = window > 0 ? max(0, seq_len - window) / BS : 0;
  const int pa = max(split * pps, p0);
  const int pb = min((split + 1) * pps, n_pages);
  if (pa >= pb && S > 1) return;            // no page here; the combine skips it
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nq = grp * HD;

  float qr[NJ][4], acc[NJ][4], m[NJ], l[NJ];
  int col[NJ];
  bool live[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int e = j * 128 + lane * 4;
    const int g = e / HD, c = e % HD;
    col[j] = c;
    live[j] = e < nq;
    const T* qg = q + b * q_sb + (long long)(h0 + g) * q_sh;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qr[j][i] = live[j] && c + i < d ? rt::to_f(qg[c + i]) : 0.f;
      acc[j][i] = 0.f;
    }
    m[j] = rt::kNegInf;
    l[j] = 0.f;
  }

  const int stage = 2 * BS * P;             // elements per stage: K then V
  const int* trow = table + (long long)b * max_pages;
  const int n = pb - pa;
  auto issue = [&](int k) {
    T* sk = ring + (k % nst) * stage;
    const long long base = (long long)trow[pa + k] * p_sn + (long long)kvh * p_sh;
    stage_page(sk, sk + BS * P, kp + base, vp + base, BS, d, P, p_st, p_sd, cb);
  };
  for (int k = 0; k < nst - 1; ++k) {
    if (k < n) issue(k);
    cp_commit();
  }
  for (int it = 0; it < n; ++it) {
    if (nst == 1) {                         // one stage: nothing in flight
      issue(it);
      cp_commit();
    }
    if (nst == 3) cp_wait<1>(); else cp_wait<0>();
    __syncthreads();                        // page it staged; slot of it-1 free
    if (nst > 1) {
      if (it + nst - 1 < n) issue(it + nst - 1);
      cp_commit();
    }
    const T* sk = ring + (it % nst) * stage;
    const T* sv = sk + BS * P;
    const int pbase = (pa + it) * BS;
    for (int t0 = warp * R; t0 < BS; t0 += NW * R) {
      float s[R][NJ];
      bool ok[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int t = t0 + r, pos = pbase + t;
        ok[r] = t < BS && pos < seq_len && (window <= 0 || pos >= seq_len - window);
        const T* kr = sk + min(t, BS - 1) * P;
        float part[NJ];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float x[4] = {0.f, 0.f, 0.f, 0.f};
          if (live[j]) row4(kr, col[j], d, x);
          part[j] = qr[j][0] * x[0] + qr[j][1] * x[1] + qr[j][2] * x[2] +
                    qr[j][3] * x[3];
        }
        if constexpr (CPH > 1) {
#pragma unroll
          for (int j0 = 0; j0 < NJ; j0 += CPH) {
            float sum = 0.f;
#pragma unroll
            for (int k = 0; k < CPH; ++k) sum += part[j0 + k];
#pragma unroll
            for (int k = 0; k < CPH; ++k) part[j0 + k] = sum;
          }
        }
#pragma unroll
        for (int off = LPH / 2; off > 0; off /= 2)
#pragma unroll
          for (int j = 0; j < NJ; ++j) part[j] += __shfl_xor_sync(FULL, part[j], off);
#pragma unroll
        for (int j = 0; j < NJ; ++j) s[r][j] = ok[r] ? part[j] * scale : -INFINITY;
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float mx = m[j];
#pragma unroll
        for (int r = 0; r < R; ++r) mx = fmaxf(mx, s[r][j]);
        const float alpha = __expf(m[j] - mx);
        float sum = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          s[r][j] = __expf(s[r][j] - mx);   // masked rows: exp(-inf) = 0
          sum += s[r][j];
        }
        l[j] = l[j] * alpha + sum;
        m[j] = mx;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] *= alpha;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!ok[r]) continue;               // rows past the sequence may hold anything
        const T* vr = sv + (t0 + r) * P;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (!live[j]) continue;
          float x[4];
          row4(vr, col[j], d, x);
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] = fmaf(s[r][j], x[i], acc[j][i]);
        }
      }
    }
    if (nst == 1) __syncthreads();          // before the next page overwrites it
  }
  cp_wait<0>();
  __syncthreads();                          // the ring is free: merge the warps

  float* Mw = reinterpret_cast<float*>(smem);   // [NW][grp]
  float* Lw = Mw + NW * grp;                    // [NW][grp]
  float* Aw = Lw + NW * grp;                    // [NW][grp * HD]
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (!live[j]) continue;
    const int e = j * 128 + lane * 4;
    if (lane % LPH == 0 && j % CPH == 0) {
      Mw[warp * grp + e / HD] = m[j];
      Lw[warp * grp + e / HD] = l[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) Aw[warp * nq + e + i] = acc[j][i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nq; e += THREADS) {
    const int g = e / HD, c = e % HD;
    if (c >= d) continue;
    float M = rt::kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, Mw[w * grp + g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = __expf(Mw[w * grp + g] - M);
      L += Lw[w * grp + g] * f;
      A += Aw[w * nq + e] * f;
    }
    const int h = h0 + g;
    if (S == 1) {
      o[b * o_sb + (long long)h * o_sh + c] = rt::from_f<T>(A / fmaxf(L, 1e-30f));
    } else {
      const long long row = ((long long)b * S + split) * H + h;
      part_acc[row * d + c] = A;
      if (c == 0) {
        part_ml[2 * row] = M;
        part_ml[2 * row + 1] = L;
      }
    }
  }
}

// Merge the splits of each (sequence, query head): block (h, b).
template <typename T>
__global__ void __launch_bounds__(128)
paged_combine_kernel(const float* __restrict__ part_acc,
                     const float* __restrict__ part_ml,
                     const int* __restrict__ lens, T* __restrict__ o, int H,
                     int d, int BS, int max_pages, int pps, int S,
                     long long o_sb, long long o_sh, int window) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int seq_len = lens[b];
  const int n_pages = min((seq_len + BS - 1) / BS, max_pages);
  const int p0 = window > 0 ? max(0, seq_len - window) / BS : 0;
  const int s0 = p0 / pps;
  const int s1 = n_pages > 0 ? (n_pages - 1) / pps : -1;   // splits with pages
  const long long row0 = (long long)b * S * H + h;
  float M = rt::kNegInf;
  for (int s = s0; s <= s1; ++s) M = fmaxf(M, part_ml[2 * (row0 + (long long)s * H)]);
  float L = 0.f;
  for (int s = s0; s <= s1; ++s) {
    const long long row = row0 + (long long)s * H;
    L += part_ml[2 * row + 1] * __expf(part_ml[2 * row] - M);
  }
  const float inv = 1.f / fmaxf(L, 1e-30f);
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float A = 0.f;
    for (int s = s0; s <= s1; ++s) {
      const long long row = row0 + (long long)s * H;
      A += part_acc[row * d + c] * __expf(part_ml[2 * row] - M);
    }
    o[b * o_sb + (long long)h * o_sh + c] = rt::from_f<T>(A * inv);
  }
}

struct Args {
  const void *q, *kp, *vp;
  const int *table, *lens;
  void* o;
  float *part_acc, *part_ml;
  int B, H, KVH, hs, d, BS, max_pages, S, pps, P, nst, cb;
  long long q_sb, q_sh, p_sn, p_st, p_sh, p_sd, o_sb, o_sh;
  float scale;
  int window;
  cudaStream_t stream;
};

template <typename T, int HD, int NJ>
int launch(const Args& a, size_t smem) {
  static const cudaError_t attr = rt::allow_smem(paged_split_kernel<T, HD, NJ>, SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  paged_split_kernel<T, HD, NJ><<<dim3(a.S, a.KVH * a.hs, a.B), THREADS, smem,
                                  a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kp),
      static_cast<const T*>(a.vp), a.table, a.lens, static_cast<T*>(a.o),
      a.part_acc, a.part_ml, a.H, a.H / (a.KVH * a.hs), a.hs, a.d, a.BS,
      a.max_pages, a.pps, a.P, a.nst, a.cb, a.q_sb, a.q_sh, a.p_sn, a.p_st,
      a.p_sh, a.p_sd, a.o_sb, a.o_sh, a.scale, a.window);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.S == 1) return (int)err;
  paged_combine_kernel<T><<<dim3(a.H, a.B), 128, 0, a.stream>>>(
      a.part_acc, a.part_ml, a.lens, static_cast<T*>(a.o), a.H, a.d, a.BS,
      a.max_pages, a.pps, a.S, a.o_sb, a.o_sh, a.window);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int by_chunks(int nj, const Args& a, size_t smem) {
  if (nj <= 1) {
    if constexpr (HD <= 128) return launch<T, HD, 1>(a, smem);
  }
  if (nj <= 2) return launch<T, HD, 2>(a, smem);
  if (nj <= 4) return launch<T, HD, 4>(a, smem);
  if (nj <= 8) return launch<T, HD, 8>(a, smem);
  if (nj <= 16) return launch<T, HD, 16>(a, smem);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch(const Args& a) {
  const int grp = a.H / (a.KVH * a.hs);     // query heads per block
  const int HD = a.d <= 32 ? 32 : a.d <= 64 ? 64 : a.d <= 128 ? 128 : 256;
  const int nj = (grp * HD + 127) / 128;
  if (grp * HD > 16 * 128 || a.P % 4 != 0) return (int)cudaErrorInvalidValue;
  const size_t ring = (size_t)a.nst * 2 * a.BS * a.P * sizeof(T);
  const size_t merge = sizeof(float) * (size_t)NW * (2 * grp + grp * HD);
  const size_t smem = ring > merge ? ring : merge;
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (HD == 32) return by_chunks<T, 32>(nj, a, smem);
  if (HD == 64) return by_chunks<T, 64>(nj, a, smem);
  if (HD == 128) return by_chunks<T, 128>(nj, a, smem);
  return by_chunks<T, 256>(nj, a, smem);
}

}  // namespace

// n_splits blocks of pps pages per (KV head, sequence) and each of its hs
// slices of grp / hs query heads; part_acc (B,
// n_splits, H, D) and part_ml (B, n_splits, H, 2) float32 scratch when
// n_splits > 1. P: staged row pitch in elements; nst: ring stages (1 to
// 3); cb: bytes per cp.async (16, 8 or 4), 0 to stage through registers.
extern "C" int rt_paged_attention(
    const void* q, const void* k_pool, const void* v_pool, const void* table,
    const void* seq_lens, void* o, void* part_acc, void* part_ml, int dtype,
    int B, int H, int KVH, int HS, int D, int BS, int max_pages, int n_splits,
    int pps, int P, int nst, int cb, long long q_sb, long long q_sh,
    long long p_sn, long long p_st, long long p_sh, long long p_sd,
    long long o_sb, long long o_sh, float scale, int window, void* stream) {
  if (KVH <= 0 || HS <= 0 || H % (KVH * HS) != 0 || KVH * HS > 65535 ||
      D <= 0 || D > 256 || BS <= 0 ||
      n_splits <= 0 || pps <= 0 || n_splits > 65535 || nst < 1 || nst > 3 ||
      P < D || (cb != 0 && (cb != 4 && cb != 8 && cb != 16)) ||
      (n_splits > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  Args a{q, k_pool, v_pool, static_cast<const int*>(table),
         static_cast<const int*>(seq_lens), o, static_cast<float*>(part_acc),
         static_cast<float*>(part_ml), B, H, KVH, HS, D, BS, max_pages,
         n_splits, pps, P, nst, cb, q_sb, q_sh, p_sn, p_st, p_sh, p_sd, o_sb,
         o_sh, scale, window, static_cast<cudaStream_t>(stream)};
  if (dtype == rt::kF32) return dispatch<float>(a);
  if (dtype == rt::kBF16) return dispatch<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}
