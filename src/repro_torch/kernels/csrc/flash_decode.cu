// Decode attention over a dense position-tagged cache, for Hopper: a ring
// buffer (a sliding layer's window-sized cache, slot = position % capacity,
// the ring starting anywhere) or a full-capacity cache, K/V in float32,
// bfloat16 or float8 e4m3.
//
// Replaces: src/repro/kernels/flash_attention.py : flash_attention
//           (_flash_kernel, the Pallas TPU flash attention), on the decode
//           step's caches. The reference decodes those in jnp
//           (src/repro/models/layers.py : attention_decode,
//           cache_attention_mask + sdpa); the port's flash kernel reads a
//           cache only where slot == position and only in bfloat16 or
//           float32, so a ring or a float8 cache comes here.
//
// What it computes, per query row i at absolute position q_offset + i:
// softmax over the slots s with pos[b, s] >= 0, pos[b, s] <= q_pos and,
// under a window, q_pos - pos[b, s] < window, of q . k_s * scale, times
// v_s. Each slot's position is read from the cache's pos row, so the slot
// order does not matter and a ring and a full-capacity cache take the same
// code. Scores, the softmax and the sums are float32; float8 K/V are
// widened exactly (every e4m3 value is a float32 value) with no scale,
// which is the reference's cast; the output rounds once to q's dtype.
//
// What bounds it on this card: bytes. One query row per KV head's group
// reads every slot's K and V row once and does 2 multiply-adds per element
// per query head of the group: a few operations per byte against the
// H100's ~295 operations-per-byte ridge, so the floor is the cache over
// 3.35 TB/s. A wgmma tile of 64 query rows would be nearly all padding for
// one row. The design is the paged kernel's (csrc/paged_attention.cu),
// with the page table replaced by contiguous slot tiles and the length by
// the position tags:
//
// The split (flash-decoding). Each block of decode_split_kernel takes one
// (slot range, KV head, sequence x query row): `tps` tiles of TILE slots
// from split * tps * TILE, clipped to the capacity. The wrapper picks the
// number of splits from the capacity, the batch, the KV heads and the SM
// count (split_plan, shared with the paged kernel), so a batch of 2 still
// fills the card. With one split the block writes the output; otherwise
// it writes float32 partials (max m, sum l, unnormalised P.V) and
// decode_combine_kernel merges the splits of each (row, head) with the
// rescaling exp(m_s - max m), rounding once at the store. A split whose
// slots are all masked contributes m = -1e30, l = 0 and weighs nothing; a
// row that sees no slot gives zeros.
//
// The head split. A block serves the query heads of its KV head, so K and
// V are read once per group; a group wider than 2048 flattened (head,
// padded dim) elements (RecurrentGemma's 16 heads x 256 on one KV head) is
// cut into `hs` blocks of grp / hs heads each.
//
// Loads in flight. The block's 128 threads stage each tile's K and V rows
// of its KV head and the tile's position tags into a ring of 3
// shared-memory stages with cp.async (16 bytes per copy where the cache's
// alignment allows, 8 or 4 otherwise; the tags 4 bytes each); the copies
// of tile i + 2 are issued before tile i is used.
//
// Arithmetic, all float32, as in the paged kernel: lane l of every warp
// holds elements j*128 + 4l .. 4l+3 of the block's flattened (head, dim)
// query; each warp scores its own rows of the tile (4 products per lane
// and a shuffle reduction over the lanes of a head) with its own online
// softmax state; the block merges its 4 warps through shared memory.
#include "common.cuh"

#include <cuda_fp16.h>
#include <cuda_fp8.h>

namespace {

constexpr int NW = 4;                    // warps per block
constexpr int THREADS = NW * 32;
constexpr int SMEM_MAX = 227 * 1024;
constexpr int NST = 3;                   // ring stages
constexpr unsigned FULL = 0xffffffffu;

enum KvType : int { kKvF32 = 0, kKvBF16 = 1, kKvE4M3 = 2 };

using rt::cp_async;
using rt::cp_commit;
using rt::cp_wait;
using rt::row4;

__device__ __forceinline__ float e4m3_to_f(unsigned char x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(
      static_cast<__nv_fp8_storage_t>(x), __NV_E4M3)));
}

// Elements c .. c+3 of a staged e4m3 row as float32 (exact); zero past d.
__device__ __forceinline__ void row4(const __nv_fp8_e4m3* r, int c, int d,
                                     float* x) {
  const unsigned char* b = reinterpret_cast<const unsigned char*>(r);
  if (c + 4 <= d) {
    const unsigned v = *reinterpret_cast<const unsigned*>(b + c);
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = e4m3_to_f((v >> (8 * i)) & 0xffu);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = c + i < d ? e4m3_to_f(b[c + i]) : 0.f;
  }
}

// One tile of one KV head: `rows` slots' K and V rows (d contiguous
// elements each, cb bytes per cp.async) into row-major [TILE][P] stages,
// and their position tags.
template <typename T>
__device__ __forceinline__ void stage_tile(T* sk, T* sv, int* sp, const T* kb,
                                           const T* vb, const int* pb, int rows,
                                           int d, int P, long long c_ss,
                                           int cb) {
  const int ce = cb / (int)sizeof(T);
  const int cpr = d / ce;
  for (int i = threadIdx.x; i < rows * cpr; i += THREADS) {
    const int t = i / cpr, c = (i - t * cpr) * ce;
    cp_async(sk + t * P + c, kb + t * c_ss + c, cb);
    cp_async(sv + t * P + c, vb + t * c_ss + c, cb);
  }
  for (int t = threadIdx.x; t < rows; t += THREADS) cp_async(sp + t, pb + t, 4);
}

// HD: head dim padded to 64/128/256; NJ: 128-element chunks of the block's
// flattened query per lane (a power of two >= grp * HD / 128), where grp
// is the block's query heads: a KV head's group over hs.
template <typename TQ, typename TKV, int HD, int NJ>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kc,
                    const TKV* __restrict__ vc, const int* __restrict__ pos,
                    TQ* __restrict__ o, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int Sq, int H, int grp,
                    int hs, int d, int cap, int tile, int tps, int P, int cb,
                    long long q_sb, long long q_ss, long long q_sh,
                    long long c_sb, long long c_ss, long long c_sh,
                    long long pos_sb, long long o_sb, long long o_ss,
                    long long o_sh, float scale, int window, int q_offset) {
  constexpr int LPH = HD >= 128 ? 32 : HD / 4;    // lanes per head
  constexpr int CPH = HD >= 128 ? HD / 128 : 1;   // chunks per head
  constexpr int R = NJ >= 4 ? 1 : 4 / NJ;         // rows a warp scores at once
  static_assert(NJ % CPH == 0, "a head spans whole chunks");
  extern __shared__ __align__(16) unsigned char smem[];

  const int split = blockIdx.x, kvh = blockIdx.y / hs;
  const int b = blockIdx.z / Sq, row = blockIdx.z - b * Sq;
  const int h0 = blockIdx.y * grp;          // this block's first query head
  const int S = gridDim.x;
  const int qpos = q_offset + row;
  const int s0 = split * tps * tile;
  const int s1 = min(s0 + tps * tile, cap);
  const int n = (s1 - s0 + tile - 1) / tile;
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
    const TQ* qg = q + b * q_sb + row * q_ss + (long long)(h0 + g) * q_sh;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qr[j][i] = live[j] && c + i < d ? rt::to_f(qg[c + i]) : 0.f;
      acc[j][i] = 0.f;
    }
    m[j] = rt::kNegInf;
    l[j] = 0.f;
  }

  // a stage: K tile, V tile ([tile][P] each), then the tile's tags
  const int kv_elems = tile * P;
  const size_t stage_bytes = 2 * (size_t)kv_elems * sizeof(TKV) + tile * sizeof(int);
  const long long base = (long long)b * c_sb + (long long)kvh * c_sh;
  const int* prow = pos + (long long)b * pos_sb;
  auto stage_k = [&](int k) {
    return reinterpret_cast<TKV*>(smem + (size_t)(k % NST) * stage_bytes);
  };
  auto issue = [&](int k) {
    TKV* sk = stage_k(k);
    const int t0 = s0 + k * tile;
    stage_tile(sk, sk + kv_elems, reinterpret_cast<int*>(sk + 2 * kv_elems),
               kc + base + t0 * c_ss, vc + base + t0 * c_ss, prow + t0,
               min(tile, s1 - t0), d, P, c_ss, cb);
  };
  for (int k = 0; k < NST - 1; ++k) {
    if (k < n) issue(k);
    cp_commit();
  }
  for (int it = 0; it < n; ++it) {
    cp_wait<NST - 2>();
    __syncthreads();                        // tile it staged; slot of it-1 free
    if (it + NST - 1 < n) issue(it + NST - 1);
    cp_commit();
    const TKV* sk = stage_k(it);
    const TKV* sv = sk + kv_elems;
    const int* sp = reinterpret_cast<const int*>(sk + 2 * kv_elems);
    const int rows = min(tile, s1 - (s0 + it * tile));
    for (int t0 = warp * R; t0 < rows; t0 += NW * R) {
      float s[R][NJ];
      bool ok[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int t = t0 + r;
        const int p = t < rows ? sp[t] : -1;
        ok[r] = p >= 0 && p <= qpos && (window <= 0 || qpos - p < window);
        const TKV* kr = sk + min(t, rows - 1) * P;
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
          s[r][j] = __expf(s[r][j] - mx);   // masked slots: exp(-inf) = 0
          sum += s[r][j];
        }
        l[j] = l[j] * alpha + sum;
        m[j] = mx;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] *= alpha;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (!ok[r]) continue;               // masked slots may hold anything
        const TKV* vr = sv + (t0 + r) * P;
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
      o[b * o_sb + row * o_ss + (long long)h * o_sh + c] =
          rt::from_f<TQ>(L > 0.f ? A / L : 0.f);
    } else {
      const long long r = ((long long)blockIdx.z * S + split) * H + h;
      part_acc[r * d + c] = A;
      if (c == 0) {
        part_ml[2 * r] = M;
        part_ml[2 * r + 1] = L;
      }
    }
  }
}

// Merge the splits of each (sequence x query row, query head): block
// (h, b * Sq + row).
template <typename TQ>
__global__ void __launch_bounds__(128)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml, TQ* __restrict__ o,
                      int Sq, int H, int d, int S, long long o_sb,
                      long long o_ss, long long o_sh) {
  const int h = blockIdx.x, z = blockIdx.y;
  const int b = z / Sq, row = z - b * Sq;
  const long long row0 = (long long)z * S * H + h;
  float M = rt::kNegInf;
  for (int s = 0; s < S; ++s) M = fmaxf(M, part_ml[2 * (row0 + (long long)s * H)]);
  float L = 0.f;
  for (int s = 0; s < S; ++s) {
    const long long r = row0 + (long long)s * H;
    L += part_ml[2 * r + 1] * __expf(part_ml[2 * r] - M);
  }
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float A = 0.f;
    for (int s = 0; s < S; ++s) {
      const long long r = row0 + (long long)s * H;
      A += part_acc[r * d + c] * __expf(part_ml[2 * r] - M);
    }
    o[b * o_sb + row * o_ss + (long long)h * o_sh + c] =
        rt::from_f<TQ>(L > 0.f ? A / L : 0.f);
  }
}

struct Args {
  const void *q, *k, *v;
  const int* pos;
  void* o;
  float *part_acc, *part_ml;
  int B, Sq, H, KVH, hs, d, cap, tile, S, tps, P, cb;
  long long q_sb, q_ss, q_sh, c_sb, c_ss, c_sh, pos_sb, o_sb, o_ss, o_sh;
  float scale;
  int window, q_offset;
  cudaStream_t stream;
};

template <typename TQ, typename TKV, int HD, int NJ>
int launch(const Args& a, size_t smem) {
  static const cudaError_t attr =
      rt::allow_smem(decode_split_kernel<TQ, TKV, HD, NJ>, SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  decode_split_kernel<TQ, TKV, HD, NJ>
      <<<dim3(a.S, a.KVH * a.hs, a.B * a.Sq), THREADS, smem, a.stream>>>(
          static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
          static_cast<const TKV*>(a.v), a.pos, static_cast<TQ*>(a.o),
          a.part_acc, a.part_ml, a.Sq, a.H, a.H / (a.KVH * a.hs), a.hs, a.d,
          a.cap, a.tile, a.tps, a.P, a.cb, a.q_sb, a.q_ss, a.q_sh,
          a.c_sb, a.c_ss, a.c_sh, a.pos_sb, a.o_sb, a.o_ss, a.o_sh, a.scale,
          a.window, a.q_offset);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.S == 1) return (int)err;
  decode_combine_kernel<TQ><<<dim3(a.H, a.B * a.Sq), 128, 0, a.stream>>>(
      a.part_acc, a.part_ml, static_cast<TQ*>(a.o), a.Sq, a.H, a.d, a.S,
      a.o_sb, a.o_ss, a.o_sh);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV, int HD>
int by_chunks(int nj, const Args& a, size_t smem) {
  if (nj <= 1) {
    if constexpr (HD <= 128) return launch<TQ, TKV, HD, 1>(a, smem);
  }
  if (nj <= 2) return launch<TQ, TKV, HD, 2>(a, smem);
  if (nj <= 4) return launch<TQ, TKV, HD, 4>(a, smem);
  if (nj <= 8) return launch<TQ, TKV, HD, 8>(a, smem);
  if (nj <= 16) return launch<TQ, TKV, HD, 16>(a, smem);
  return (int)cudaErrorInvalidValue;
}

template <typename TQ, typename TKV>
int dispatch(const Args& a) {
  const int grp = a.H / (a.KVH * a.hs);     // query heads per block
  const int HD = a.d <= 64 ? 64 : a.d <= 128 ? 128 : 256;
  const int nj = (grp * HD + 127) / 128;
  if (grp * HD > 16 * 128 || (a.P * (int)sizeof(TKV)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t stage = 2 * (size_t)a.tile * a.P * sizeof(TKV) + a.tile * sizeof(int);
  const size_t ring = (size_t)NST * stage;
  const size_t merge = sizeof(float) * (size_t)NW * (2 * grp + grp * HD);
  const size_t smem = ring > merge ? ring : merge;
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (HD == 64) return by_chunks<TQ, TKV, 64>(nj, a, smem);
  if (HD == 128) return by_chunks<TQ, TKV, 128>(nj, a, smem);
  return by_chunks<TQ, TKV, 256>(nj, a, smem);
}

}  // namespace

// q (B, Sq, H, D) at (sq, h) element strides q_ss, q_sh; K/V (B, cap, KVH,
// D) at (b, slot, head) strides c_sb, c_ss, c_sh, the head dim contiguous;
// pos (B, cap) int32 at row stride pos_sb; o (B, Sq, H, D) in q's dtype.
// n_splits blocks of tps tiles of `tile` slots per (KV head, sequence x
// row) and each of its hs slices of grp / hs query heads; part_acc (B*Sq,
// n_splits, H, D) and part_ml (B*Sq, n_splits, H, 2) float32 scratch when
// n_splits > 1. P: staged row pitch in elements (16-byte rows); cb: bytes
// per cp.async (16, 8 or 4). q_dtype 0 float32 / 1 bfloat16; kv_dtype 0
// float32 / 1 bfloat16 / 2 float8 e4m3 (with a bfloat16 q).
extern "C" int rt_flash_decode(
    const void* q, const void* k, const void* v, const void* pos, void* o,
    void* part_acc, void* part_ml, int q_dtype, int kv_dtype, int B, int Sq,
    int H, int KVH, int HS, int D, int cap, int tile, int n_splits, int tps,
    int P, int cb, long long q_sb, long long q_ss, long long q_sh,
    long long c_sb, long long c_ss, long long c_sh, long long pos_sb,
    long long o_sb, long long o_ss, long long o_sh, float scale, int window,
    int q_offset, void* stream) {
  if (KVH <= 0 || HS <= 0 || H % (KVH * HS) != 0 || KVH * HS > 65535 ||
      D <= 0 || D > 256 || cap <= 0 || tile <= 0 || Sq <= 0 ||
      n_splits <= 0 || tps <= 0 || n_splits > 65535 ||
      (long long)B * Sq > 65535 || P < D ||
      (cb != 4 && cb != 8 && cb != 16) ||
      (long long)n_splits * tps * tile < cap ||
      (n_splits > 1 && (part_acc == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  Args a{q, k, v, static_cast<const int*>(pos), o,
         static_cast<float*>(part_acc), static_cast<float*>(part_ml), B, Sq,
         H, KVH, HS, D, cap, tile, n_splits, tps, P, cb, q_sb, q_ss,
         q_sh, c_sb, c_ss, c_sh, pos_sb, o_sb, o_ss, o_sh, scale, window,
         q_offset, static_cast<cudaStream_t>(stream)};
  if (q_dtype == rt::kF32 && kv_dtype == kKvF32) return dispatch<float, float>(a);
  if (q_dtype == rt::kBF16 && kv_dtype == kKvBF16)
    return dispatch<__nv_bfloat16, __nv_bfloat16>(a);
  if (q_dtype == rt::kBF16 && kv_dtype == kKvE4M3)
    return dispatch<__nv_bfloat16, __nv_fp8_e4m3>(a);
  return (int)cudaErrorInvalidValue;
}
