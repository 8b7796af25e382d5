// Decode attention over a dense position-tagged cache, for Hopper: a ring
// buffer (a sliding layer's window-sized cache, slot = position % capacity,
// the ring starting anywhere) or a full-capacity cache, K/V in float32,
// bfloat16 or float8 e4m3.
//
// Replaces: src/repro/kernels/flash_attention.py : flash_attention
//           (_flash_kernel, the Pallas TPU flash attention), on the decode
//           step's caches. The reference decodes those in jnp
//           (src/repro/models/layers.py : attention_decode,
//           cache_attention_mask + sdpa). The port sends a decode step of
//           one query row here on every dense cache (models/layers.py :
//           attention_decode), and a chunk of several rows here when its
//           cache is a ring or float8 (flash reads a cache only where
//           slot == position, and only in bfloat16 or float32).
//
// What it computes, per query row i at absolute position q_offset + i:
// softmax over the slots s with pos[b, s] >= 0, pos[b, s] <= q_pos and,
// under a window, q_pos - pos[b, s] < window, of q . k_s * scale, times
// v_s. Each slot's position is read from the cache's pos row, so the slot
// order does not matter and a ring and a full-capacity cache take the same
// code. Scores, the softmax statistics and the sums are float32; float8
// K/V are widened exactly (every e4m3 value is a bfloat16 value) with no
// scale, which is the reference's cast; a row that sees no slot gives
// zeros, and a slot that no row sees is selected away together with its V
// (it may hold anything, NaN included); the output rounds once to q's
// dtype.
//
// What bounds it on this card: bytes. One query row per KV head's group
// reads every slot's K and V row once and does 2 multiply-adds per element
// per query head of the group: at most 32 operations per byte (16 heads on
// one KV head in bfloat16) against the H100's ~295 operations-per-byte
// ridge, so the floor is the cache over 3.35 TB/s: 0.2004 ms for
// Qwen1.5-32B's float8 cache (2 x 32,896 slots x 40 KV heads x 128),
// 0.0801 ms for Qwen3-4B's bfloat16 one (8 KV heads), 0.0100 and 0.0013 ms
// for Mixtral's and RecurrentGemma's rings.
//
// What held the first design back (a block of 4 warps per (slot range, KV
// head, head share), float32 on the CUDA cores): lane l held elements
// j*128 + 4l .. 4l+3 of the block's flattened (head, dim) query, so every
// slot's score cost NJ partial products and log2(lanes per head) rounds of
// shuffles per chunk (80 shuffles a slot at RecurrentGemma's 8 x 256
// share, one slot at a time); a group wider than 2048 flattened elements
// was cut across blocks; the split plan (the paged kernel's, at least 4
// tiles of 32 slots a split) left RecurrentGemma's ring 64 blocks on 132
// SMs; float8 was widened one byte at a time through half to float32
// (about ten issue slots an element, as much time as the bytes).
//
// The design now, for a bfloat16 q over bfloat16 or float8 K/V
// (decode_mma_kernel):
// - Scores on the tensor cores. A block serves one (slot range, KV head,
//   sequence x query row); its 4 warps each take 16 slots of every staged
//   tile (2 warps at head dim 256, below). The KV group's query heads are
//   the rows of an mma.sync m16n8k16 bf16 -> f32 A operand, padded to 16,
//   loaded once into registers; a group wider than 16 takes further
//   16-row tiles in a loop, each streaming the block's slots again, so no
//   head split is needed. S = Q K^T is two n8 tiles a warp; a bf16 x bf16
//   product is exact in float32, so the scores differ from the scalar
//   code's only in summation order. The masking and the online softmax
//   (running max and sum per A row, exp2 with scale * log2 e folded in)
//   then work per row with two quad shuffles.
// - P.V on the tensor cores too (the S accumulator layout is the A
//   fragment layout). Over bf16 V, P rounded once to bf16, as the port's
//   flash kernel does; the output's error stays within
//   scaled_dot_product_attention's (chip_smoke.py, FLASH_VS_SDPA). Over
//   e4m3 V, whose bytes the hardware widens to f16 exactly (below), P
//   goes in as an f16 head and the f16 of its remainder, two products
//   into one sum: P to about 22 bits, so the float8 serve step tracks the
//   plain route as the first design's float32 products did (one f16
//   rounding of P moved tiny bf16 models' logits by a step). The float32
//   sum l adds the unrounded P. At head dim
//   256 a warp's 16 x 256 float32 output would take 128 registers, so two
//   warps share each 16-slot group and split the head dim for P.V (each
//   recomputes the group's scores; 32 slots a tile). A warp rescales its
//   output only when a row's running max moved.
// - Fragments without ldmatrix where the bytes disagree. The k order of a
//   product is free as long as A and B agree, and so is the slot order of
//   S as long as P.V's k order follows it. So lane (g, c) reads 16
//   contiguous bytes of a K row with one 128-bit shared load (8 bf16 or 16
//   e4m3 elements: 2 or 4 k-steps) and the A fragment is loaded from q in
//   the matching order; S column n of tile t holds slot
//   8t + n/2 + 4 (n % 2), so a lane's 4 columns are slots c, c+4, c+8,
//   c+12 — the same 4 slots its P.V B fragment needs. bf16 V comes in
//   through ldmatrix.trans with those slots as its rows; e4m3 V as four
//   32-bit loads (4 dims of each of the lane's 4 slots), transposed with
//   eight byte permutes into 4 slots of each of 4 dims. Each tile's Q K^T
//   runs as two independent chains of k-steps.
// - e4m3 widened four bytes a 32-bit word, in registers, straight into
//   the B fragments. K (against a bf16 q): bytes (0, 2) and (1, 3) become
//   two bf16 pairs by placing each byte's sign, exponent and mantissa in
//   a bf16's fields (logic ops) and one bf16x2 multiply by 2^120 (the
//   exponent biases' difference), which is exact, subnormals included;
//   the NaN code (0x7f / 0xff) is made NaN again under a rarely taken
//   branch. V: two cvt.rn.f16x2.e4m3x2 a word. Every e4m3 value is exact
//   in bf16 and in f16, so the products are those of the float32
//   widening. (The bit trick for V as well was slower on row 1f.)
// - Loads: each tile's K rows, V rows and tags go into a ring of 2-4
//   shared-memory stages with cp.async, 16 bytes a copy where the cache's
//   alignment allows. The launch bounds let 3 blocks share an SM up to
//   head dim 128 (2 at 256), and the host picks the most stages whose
//   ring leaves room for them (kernels/flash_decode.py : launch_plan),
//   so 70-105 KB are in flight per SM. cp.async rather than TMA: the row
//   pitches are padded so that the fragment loads above are free of bank
//   conflicts (K rows 16 bytes past a multiple of 32; bf16 V rows an odd
//   multiple of 16 bytes for ldmatrix; e4m3 V rows 32 past a multiple of
//   128), which a TMA box cannot, and a tensor map per call would cost
//   host time.
// - A split plan of its own (kernels/flash_decode.py : split_plan): the
//   slot tiles of each (sequence x row, KV head) are cut into splits so
//   that the grid holds at least 2 x 132 blocks where the cache has the
//   tiles, choosing among those the split that finishes in the fewest
//   block-rounds of the SMs' resident blocks times the tiles a block
//   streams; RecurrentGemma's 2048-slot ring gets 64 splits of one tile.
//   With one split the block writes the output; otherwise it writes
//   float32 partials (max m, sum l, unnormalised P.V) and
//   decode_combine_kernel merges the splits of each (row, head) with the
//   rescaling exp(m_s - max m), its threads sharing the splits, rounding
//   once at the store. A split whose slots are all masked contributes
//   m = -1e30, l = 0 and weighs nothing; a warp skips a 16-slot group
//   that no row sees.
// - Partials out, combine apart: a cache whose slots are cut across the
//   ranks of a model axis (the launch layer's capacity-sharded decode
//   caches) is read by one call a rank that stops at the partials (o ==
//   nullptr: even one split writes them, m in natural-log units as the
//   combine reads it), and rt_decode_combine merges the splits of every
//   rank, concatenated, with the same decode_combine_kernel. Nothing of
//   the arithmetic changes.
// - V narrower than K (dv <= d, each with its own strides): MLA's latent
//   expanded to every head gives K of 192 and V of 128 (a view of the
//   expansion). K's padded head dim HD sets the Q K^T k-steps and V's
//   HDV the P.V n-tiles, the V stage pitch and the merge buffer, so the
//   <bf16, 256, 128> instance streams 128 V columns, not 256; a warp
//   then holds 16 x 128 float32 outputs, so the slot groups are not
//   split (WD 1, tiles of 64 slots). The instances with HDV == HD keep
//   their arithmetic. The float32 scalar kernel stages V's dv columns at
//   K's pitch and stores dv of them.
//
// float32 q and K/V (decode_split_kernel: the sweep's and the card tests'
// 2e-5 cases, on no main-path phase) keep the scalar code: bf16 products
// cannot meet 2e-5, and TF32 would change what it computes. Its block
// serves a (slot range, KV head, head share) with 4 warps, lane l holding
// elements j*128 + 4l .. 4l+3 of the share's flattened (head, dim) query,
// a share of at most 2048 flattened elements; tiles of 32 slots through a
// 3-stage cp.async ring; each warp scores its own rows of the tile with
// its own online softmax state and the block merges its 4 warps through
// shared memory.
#include "common.cuh"

#include <cuda_fp16.h>
#include <cstdint>

namespace {

constexpr int NW = 4;                    // warps per block
constexpr int THREADS = NW * 32;
constexpr int SMEM_MAX = 227 * 1024;
constexpr int NST = 3;                   // the scalar kernel's ring stages
constexpr unsigned FULL = 0xffffffffu;

enum KvType : int { kKvF32 = 0, kKvBF16 = 1, kKvE4M3 = 2 };

using rt::cp_async;
using rt::cp_commit;
using rt::cp_wait;
using rt::row4;

// ------------------------------------------------------------------------
// float32: the scalar kernel
// ------------------------------------------------------------------------
// One tile of one KV head: `rows` slots' K rows (d contiguous elements,
// slot stride k_ss) and V rows (the first dv <= d of them, slot stride
// v_ss), cb bytes per cp.async, into row-major [TILE][P] stages, and
// their position tags.
template <typename T>
__device__ __forceinline__ void stage_tile(T* sk, T* sv, int* sp, const T* kb,
                                           const T* vb, const int* pb, int rows,
                                           int d, int dv, int P,
                                           long long k_ss, long long v_ss,
                                           int cb) {
  const int ce = cb / (int)sizeof(T);
  const int cpr = d / ce;
  for (int i = threadIdx.x; i < rows * cpr; i += THREADS) {
    const int t = i / cpr, c = (i - t * cpr) * ce;
    cp_async(sk + t * P + c, kb + t * k_ss + c, cb);
    if (c < dv) cp_async(sv + t * P + c, vb + t * v_ss + c, cb);
  }
  for (int t = threadIdx.x; t < rows; t += THREADS) cp_async(sp + t, pb + t, 4);
}

// HD: K's head dim d padded to 64/128/256 (V's dv <= d takes the same
// lanes, zero past dv); NJ: 128-element chunks of the block's flattened
// query per lane (a power of two >= grp * HD / 128), where grp is the
// block's query heads: a KV head's group over hs.
template <typename TQ, typename TKV, int HD, int NJ>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ kc,
                    const TKV* __restrict__ vc, const int* __restrict__ pos,
                    TQ* __restrict__ o, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int Sq, int H, int grp,
                    int hs, int d, int dv, int cap, int tile, int tps, int P,
                    int cb, long long q_sb, long long q_ss, long long q_sh,
                    long long c_sb, long long c_ss, long long c_sh,
                    long long v_sb, long long v_ss, long long v_sh,
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
  const long long kbase = (long long)b * c_sb + (long long)kvh * c_sh;
  const long long vbase = (long long)b * v_sb + (long long)kvh * v_sh;
  const int* prow = pos + (long long)b * pos_sb;
  auto stage_k = [&](int k) {
    return reinterpret_cast<TKV*>(smem + (size_t)(k % NST) * stage_bytes);
  };
  auto issue = [&](int k) {
    TKV* sk = stage_k(k);
    const int t0 = s0 + k * tile;
    stage_tile(sk, sk + kv_elems, reinterpret_cast<int*>(sk + 2 * kv_elems),
               kc + kbase + t0 * c_ss, vc + vbase + t0 * v_ss, prow + t0,
               min(tile, s1 - t0), d, dv, P, c_ss, v_ss, cb);
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
          row4(vr, col[j], dv, x);
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
    if (c >= dv) continue;
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
    if (S == 1 && o != nullptr) {
      o[b * o_sb + row * o_ss + (long long)h * o_sh + c] =
          rt::from_f<TQ>(L > 0.f ? A / L : 0.f);
    } else {
      const long long r = ((long long)blockIdx.z * S + split) * H + h;
      part_acc[r * dv + c] = A;
      if (c == 0) {
        part_ml[2 * r] = M;
        part_ml[2 * r + 1] = L;
      }
    }
  }
}

// Merge the splits of each (sequence x query row, query head): block
// (h, b * Sq + row) of COMBINE_THREADS threads. The threads take the
// splits' maxima and weighted sums in parallel (a block reduction), keep
// each split's weight exp(m_s - max m) in shared memory when S <=
// COMBINE_CACHED, and sum the partials of a dim over the splits with
// independent loads.
constexpr int COMBINE_THREADS = 256;
constexpr int COMBINE_CACHED = 8192;     // splits whose weights fit 32 KB

__device__ __forceinline__ float block_reduce(float x, float* red, bool mx) {
  for (int off = 16; off > 0; off /= 2) {
    const float y = __shfl_xor_sync(FULL, x, off);
    x = mx ? fmaxf(x, y) : x + y;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                          // red is free
  if (lane == 0) red[warp] = x;
  __syncthreads();
  x = red[0];
  for (int w = 1; w < COMBINE_THREADS / 32; ++w)
    x = mx ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

template <typename TQ>
__global__ void __launch_bounds__(COMBINE_THREADS)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_ml, TQ* __restrict__ o,
                      int Sq, int H, int d, int S, long long o_sb,
                      long long o_ss, long long o_sh) {
  __shared__ float red[COMBINE_THREADS / 32];
  extern __shared__ float wts[];            // [S] when S <= COMBINE_CACHED
  const int h = blockIdx.x, z = blockIdx.y;
  const int b = z / Sq, row = z - b * Sq;
  const long long row0 = (long long)z * S * H + h;
  const bool cached = S <= COMBINE_CACHED;
  float M = rt::kNegInf;
  for (int s = threadIdx.x; s < S; s += COMBINE_THREADS)
    M = fmaxf(M, part_ml[2 * (row0 + (long long)s * H)]);
  M = block_reduce(M, red, true);
  float L = 0.f;
  for (int s = threadIdx.x; s < S; s += COMBINE_THREADS) {
    const long long r = row0 + (long long)s * H;
    const float w = __expf(part_ml[2 * r] - M);
    if (cached) wts[s] = w;
    L += part_ml[2 * r + 1] * w;
  }
  L = block_reduce(L, red, false);          // its barriers publish wts
  for (int c = threadIdx.x; c < d; c += COMBINE_THREADS) {
    float A = 0.f;
#pragma unroll 8
    for (int s = 0; s < S; ++s) {
      const long long r = row0 + (long long)s * H;
      const float w = cached ? wts[s] : __expf(part_ml[2 * r] - M);
      A += part_acc[r * d + c] * w;
    }
    o[b * o_sb + row * o_ss + (long long)h * o_sh + c] =
        rt::from_f<TQ>(L > 0.f ? A / L : 0.f);
  }
}

// ------------------------------------------------------------------------
// bfloat16 q over bfloat16 or float8 e4m3 K/V: the tensor-core kernel
// ------------------------------------------------------------------------
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr uint32_t kTwo120 = 0x7b807b80u;   // bf16x2 (2^120, 2^120)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint4 lds128(const unsigned char* p) {
  uint4 r;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "r"(smem_u32(p)));
  return r;
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  uint32_t r;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(r) : "r"(smem_u32(p)));
  return r;
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const unsigned char* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// D += A B: m16n8k16, bf16 operands, float32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A B: m16n8k16, f16 operands, float32 accumulators.
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.f16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// Four e4m3 bytes as two f16 pairs (b0, b1) and (b2, b3), by the
// hardware's conversion: exact (every e4m3 value is an f16 value), NaN
// kept.
__device__ __forceinline__ void e4m3x4_f16(uint32_t x, uint32_t& lo,
                                           uint32_t& hi) {
  asm("{\n.reg .b16 l, h;\nmov.b32 {l, h}, %2;\n"
      "cvt.rn.f16x2.e4m3x2 %0, l;\ncvt.rn.f16x2.e4m3x2 %1, h;\n}\n"
      : "=r"(lo), "=r"(hi) : "r"(x));
}

__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// Four e4m3 bytes b0..b3 of x as two bf16 pairs, exactly: lo = (b0, b2),
// hi = (b1, b3). Each byte's sign goes to bit 15 of its half and its
// exponent and mantissa to bits 4..10 — a bf16 worth the e4m3 value times
// 2^-120, subnormals included — and one multiply by 2^120 restores it.
// The NaN code (magnitude 0x7f) comes out as 480 there and is made NaN.
__device__ __forceinline__ void widen4(uint32_t x, uint32_t& lo, uint32_t& hi) {
  lo = bf16x2_mul(((x << 8) & 0x80008000u) | ((x << 4) & 0x07f007f0u),
                  kTwo120);
  hi = bf16x2_mul((x & 0x80008000u) | ((x >> 4) & 0x07f007f0u), kTwo120);
  const uint32_t nan = ((x & 0x7f7f7f7fu) + 0x01010101u) & 0x80808080u;
  if (nan) {
    lo |= ((nan >> 7) & 0x00010001u) * 0x7fc0u;
    hi |= ((nan >> 15) & 0x00010001u) * 0x7fc0u;
  }
}

template <typename T> struct KvBytes;
template <> struct KvBytes<__nv_bfloat16> { static constexpr int v = 2; };
template <> struct KvBytes<unsigned char> { static constexpr int v = 1; };

// One instance: K/V element TKV (bf16, or unsigned char for e4m3), K's
// head dim padded to HD and V's to HDV <= HD (MLA's 192 / 128 runs as 256
// / 128). WD warps share a 16-slot group and split V's head dim for P.V
// (2 at 256, so a warp's output is 16 x 128 float32); WS = 4 / WD slot
// groups a tile.
template <typename TKV, int HD, int HDV>
struct Mma {
  static constexpr int ES = KvBytes<TKV>::v;        // bytes an element
  static constexpr int WD = HDV == 256 ? 2 : 1;
  static constexpr int WS = NW / WD;
  static constexpr int TILE = 16 * WS;              // slots a stage
  static constexpr int DW = HDV / WD;               // dims a warp's P.V
  static constexpr int E = 16 / ES;                 // elements a 16-byte load
  static constexpr int KSL = E / 4;                 // k-steps a 16-byte load
  static constexpr int NCH = HD * ES / 64;          // 64-byte chunks a K row
  static constexpr int KS = HD / 16;                // k-steps of Q K^T
  static constexpr int NT = DW / 8;                 // n8 tiles of P.V
  // blocks an SM holds by registers (<= 170 a thread at 3, 255 at 2)
  static constexpr int MINB = HD == 256 ? 2 : 3;
  static_assert(NCH * KSL == KS, "chunks cover the head dim");
  static_assert(HDV <= HD, "V no wider than K");
};

// S tile t's column n holds slot 8t + n/2 + 4 (n % 2) of the warp's group.
__device__ __forceinline__ int s_slot(int t, int n) {
  return 8 * t + (n >> 1) + 4 * (n & 1);
}

// The lane's 4 slots of a 16-slot group (S columns 2c, 2c+1 of tiles 0
// and 1; P.V k rows 2c, 2c+1, 2c+8, 2c+9): c + 4i.
template <typename C, bool MASKED>
__device__ __forceinline__ void pv_group(float (&o)[C::NT][4],
                                         const uint32_t (&pa)[4],
                                         const uint32_t (&pl)[4],
                                         const unsigned char* sv, int pvb,
                                         int grp0, int col0, int lane,
                                         uint32_t vm01, uint32_t vm23) {
  const int g = lane >> 2, c = lane & 3;
  if constexpr (C::ES == 2) {
    // ldmatrix.x4.trans: matrices (k rows 0-7 | 8-15) x (dims n0 | n0+8);
    // lane l gives row l % 8 of matrix l / 8
    const int mi = lane >> 3, ri = lane & 7;
    const int slot = grp0 + 8 * (mi & 1) + (ri >> 1) + 4 * (ri & 1);
    const unsigned char* base = sv + slot * pvb + 2 * (col0 + 8 * (mi >> 1));
#pragma unroll
    for (int np = 0; np < C::NT / 2; ++np) {
      uint32_t r[4];
      ldsm_x4_trans(r, base + 32 * np);
      if constexpr (MASKED) {
        r[0] &= vm01; r[1] &= vm23; r[2] &= vm01; r[3] &= vm23;
      }
      mma_bf16(o[2 * np], pa, r[0], r[1]);
      mma_bf16(o[2 * np + 1], pa, r[2], r[3]);
    }
  } else {
    // 4 dims of each of the lane's 4 slots, transposed to 4 slots of each
    // of 4 dims: n-tile 4j + t, column g holds dim col0 + 32j + 4g + t
    const unsigned char* base = sv + (grp0 + c) * pvb + col0 + 4 * g;
#pragma unroll
    for (int j = 0; j < C::DW / 32; ++j) {
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = lds32(base + 4 * i * pvb + 32 * j);
      const uint32_t a = __byte_perm(w[0], w[1], 0x5140);
      const uint32_t b = __byte_perm(w[2], w[3], 0x5140);
      const uint32_t e = __byte_perm(w[0], w[1], 0x7362);
      const uint32_t f = __byte_perm(w[2], w[3], 0x7362);
      const uint32_t x[4] = {__byte_perm(a, b, 0x5410), __byte_perm(a, b, 0x7632),
                             __byte_perm(e, f, 0x5410), __byte_perm(e, f, 0x7632)};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        uint32_t lo, hi;     // slots (c, c+4) and (c+8, c+12) of one dim
        e4m3x4_f16(x[t], lo, hi);
        if constexpr (MASKED) { lo &= vm01; hi &= vm23; }
        mma_f16(o[4 * j + t], pa, lo, hi);     // P's f16 head, then
        mma_f16(o[4 * j + t], pl, lo, hi);     // its remainder
      }
    }
  }
  (void)g;
}

// The dim that column n of P.V's n-tile nt holds, within the warp's slice.
template <int ES>
__device__ __forceinline__ int o_dim(int nt, int n) {
  if constexpr (ES == 2) return 8 * nt + n;
  else return 32 * (nt >> 2) + 4 * n + (nt & 3);
}

// Block (split, KV head, sequence x query row). The slots
// [split * tps * TILE, +tps * TILE) clipped to cap, in a ring of nst
// stages: K rows [TILE][pk], V rows [TILE][pv] (elements), tags [TILE].
// K rows are d wide, V rows dv <= d.
template <typename TKV, int HD, int HDV>
__global__ void __launch_bounds__(THREADS, Mma<TKV, HD, HDV>::MINB)
decode_mma_kernel(const __nv_bfloat16* __restrict__ q,
                  const TKV* __restrict__ kc, const TKV* __restrict__ vc,
                  const int* __restrict__ pos, __nv_bfloat16* __restrict__ o,
                  float* __restrict__ part_acc, float* __restrict__ part_ml,
                  int Sq, int H, int grp, int d, int dv, int cap, int tps,
                  int pk, int pv, int nst, int cb, long long q_sb,
                  long long q_ss, long long q_sh, long long c_sb,
                  long long c_ss, long long c_sh, long long v_sb,
                  long long v_ss, long long v_sh, long long pos_sb,
                  long long o_sb, long long o_ss, long long o_sh, float scale,
                  int window, int q_offset) {
  using C = Mma<TKV, HD, HDV>;
  constexpr int ES = C::ES, TILE = C::TILE;
  extern __shared__ __align__(16) unsigned char smem[];

  const int split = blockIdx.x, kvh = blockIdx.y;
  const int b = blockIdx.z / Sq, row = blockIdx.z - b * Sq;
  const int S = gridDim.x;
  const int qpos = q_offset + row;
  const int s0 = split * tps * TILE;
  const int s1 = min(s0 + tps * TILE, cap);
  const int n = (s1 - s0 + TILE - 1) / TILE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int sg = warp % C::WS, ds = warp / C::WS;   // slot group, dim slice
  const float sl2 = scale * kLog2e;

  const int pkb = pk * ES, pvb = pv * ES;
  const int kv_bytes = TILE * (pkb + pvb);
  const int stage_bytes = kv_bytes + TILE * (int)sizeof(int);
  const unsigned char* kg = reinterpret_cast<const unsigned char*>(
      kc + (long long)b * c_sb + (long long)kvh * c_sh);
  const unsigned char* vg = reinterpret_cast<const unsigned char*>(
      vc + (long long)b * v_sb + (long long)kvh * v_sh);
  const int* prow = pos + (long long)b * pos_sb;
  const long long kss = c_ss * ES, vss = v_ss * ES;   // bytes a slot
  const int rb = d * ES;                              // K's row bytes

  auto stage = [&](int k) { return smem + (size_t)(k % nst) * stage_bytes; };
  // `rows` slots' rows of `row_b` bytes (slot stride ss bytes) from src
  // into dst at pitch pb, cb bytes a copy
  auto copy_rows = [&](unsigned char* dst, int pb, const unsigned char* src,
                       long long ss, int row_b, int t0, int rows) {
    const int cpr = row_b / cb;
    if (THREADS % cpr == 0) {               // a thread keeps its column
      const int ct = threadIdx.x / cpr, co = (threadIdx.x - ct * cpr) * cb;
      for (int t = ct; t < rows; t += THREADS / cpr)
        cp_async(dst + t * pb + co, src + (t0 + t) * ss + co, cb);
    } else {
      for (int i = threadIdx.x; i < rows * cpr; i += THREADS) {
        const int t = i / cpr, off = (i - t * cpr) * cb;
        cp_async(dst + t * pb + off, src + (t0 + t) * ss + off, cb);
      }
    }
  };
  auto issue = [&](int k) {
    unsigned char* sk = stage(k);
    unsigned char* sv = sk + TILE * pkb;
    int* sp = reinterpret_cast<int*>(sk + kv_bytes);
    const int t0 = s0 + k * TILE, rows = min(TILE, s1 - t0);
    copy_rows(sk, pkb, kg, kss, rb, t0, rows);
    copy_rows(sv, pvb, vg, vss, dv * ES, t0, rows);
    for (int t = threadIdx.x; t < TILE; t += THREADS) {
      if (t < rows) cp_async(sp + t, prow + t0 + t, 4);
      else sp[t] = -1;                    // past the capacity: seen by none
    }
  };
  auto wait_ring = [&]() {
    if (nst == 2) cp_wait<0>();
    else if (nst == 3) cp_wait<1>();
    else cp_wait<2>();
  };

  for (int m0 = 0; m0 < grp; m0 += 16) {            // 16-row tiles of heads
    const int h0 = kvh * grp + m0, mrows = min(16, grp - m0);
    // K's columns past d are read by the products: zero them in every stage
    if (rb < HD * ES) {
      const int pad = HD * ES - rb;
      for (int i = threadIdx.x; i < nst * TILE * pad; i += THREADS) {
        const int r = i / pad;
        stage(r / TILE)[(r % TILE) * pkb + rb + (i - r * pad)] = 0;
      }
    }
    // A: rows g and g+8, in the k order of the K fragments (see s_slot)
    uint32_t qa[C::KS][4];
    {
      const __nv_bfloat16* qb = q + b * q_sb + row * q_ss;
#pragma unroll
      for (int ks = 0; ks < C::KS; ++ks) {
        const int e0 = (ks / C::KSL) * 4 * C::E + c * C::E + (ks % C::KSL) * 4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = g + 8 * h;
          // elements e0 .. e0+3 of row r: one 8-byte load where it can
          uint32_t x01 = 0u, x23 = 0u;
          if (r < mrows) {
            const __nv_bfloat16* qr = qb + (long long)(h0 + r) * q_sh + e0;
            if (e0 + 4 <= d && (reinterpret_cast<uintptr_t>(qr) & 7) == 0) {
              const uint2 v = *reinterpret_cast<const uint2*>(qr);
              x01 = v.x;
              x23 = v.y;
            } else {
              uint32_t e[4];
#pragma unroll
              for (int i = 0; i < 4; ++i)
                e[i] = e0 + i < d ? __bfloat16_as_ushort(qr[i]) : 0u;
              x01 = e[0] | e[1] << 16;
              x23 = e[2] | e[3] << 16;
            }
          }
          // bf16: (e0, e0+1) then (e0+2, e0+3); e4m3: (e0, e0+2), (e0+1, e0+3)
          if constexpr (ES == 2) {
            qa[ks][h] = x01;
            qa[ks][2 + h] = x23;
          } else {
            qa[ks][h] = __byte_perm(x01, x23, 0x5410);
            qa[ks][2 + h] = __byte_perm(x01, x23, 0x7632);
          }
        }
      }
    }
    float acc[C::NT][4], m[2] = {rt::kNegInf, rt::kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

    for (int k = 0; k < nst - 1; ++k) {
      if (k < n) issue(k);
      cp_commit();
    }
    for (int it = 0; it < n; ++it) {
      wait_ring();
      __syncthreads();                      // tile it staged; slot of it-1 free
      if (it + nst - 1 < n) issue(it + nst - 1);
      cp_commit();
      const unsigned char* sk = stage(it);
      const unsigned char* sv = sk + TILE * pkb;
      const int* sp = reinterpret_cast<const int*>(sk + kv_bytes);
      const int grp0 = sg * 16;
      bool vis[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = sp[grp0 + c + 4 * i];
        vis[i] = p >= 0 && p <= qpos && (window <= 0 || qpos - p < window);
      }
      const bool mine = vis[0] || vis[1] || vis[2] || vis[3];
      if (!__any_sync(FULL, mine)) continue;          // no row sees the group
      const bool all = __all_sync(FULL, vis[0] && vis[1] && vis[2] && vis[3]);

      // S = Q K^T over the group's 16 slots: two n8 tiles, each summed
      // in two independent chains of k-steps (odd and even)
      float sc[2][4], s2[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[t][e] = s2[t][e] = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const unsigned char* kr = sk + (grp0 + s_slot(t, g)) * pkb + 16 * c;
#pragma unroll
        for (int ch = 0; ch < C::NCH; ++ch) {
          const uint4 w = lds128(kr + 64 * ch);
          const uint32_t wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int s = 0; s < C::KSL; ++s) {
            uint32_t b0, b1;
            if constexpr (ES == 2) {
              b0 = wv[2 * s];
              b1 = wv[2 * s + 1];
            } else {
              widen4(wv[s], b0, b1);
            }
            const int ks = ch * C::KSL + s;
            mma_bf16(ks % 2 ? s2[t] : sc[t], qa[ks], b0, b1);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[t][e] += s2[t][e];
      }
      // mask, online softmax per A row (g: e 0,1; g+8: e 2,3)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[t][e] = vis[2 * t + (e & 1)] ? sc[t][e] * sl2 : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[t][e]);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
        const float mn = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f(m[r] - mn);
        m[r] = mn;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[t][e] = exp2f(sc[t][e] - m[e >> 1]);    // masked: exp2(-inf) = 0
          rs[e >> 1] += sc[t][e];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
      // the running max rarely moves once the first slots are in: skip
      // the rescale (alpha is exactly 1) when no row's did
      if (__any_sync(FULL, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt) {
          acc[nt][0] *= alpha[0]; acc[nt][1] *= alpha[0];
          acc[nt][2] *= alpha[1]; acc[nt][3] *= alpha[1];
        }
      }
      // P as the A operand: bf16 over bf16 V; over e4m3 V an f16 head
      // and the f16 of its remainder (P to about 22 bits, as the float32
      // products of the first design)
      uint32_t pa[4], pl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p0 = sc[i >> 1][2 * (i & 1)], p1 = sc[i >> 1][2 * (i & 1) + 1];
        if constexpr (ES == 1) {
          pa[i] = pack_f16(p0, p1);
          const float2 h = __half22float2(*reinterpret_cast<const __half2*>(&pa[i]));
          pl[i] = pack_f16(p0 - h.x, p1 - h.y);
        } else {
          pa[i] = pack_bf16(p0, p1);
          pl[i] = 0u;
        }
      }
      // O += P V over the warp's dim slice (V's columns past dv give
      // output columns that are never stored); a masked slot's V is
      // selected away (it may hold NaN)
      if (all) {
        pv_group<C, false>(acc, pa, pl, sv, pvb, grp0, ds * C::DW, lane, 0u,
                           0u);
      } else {
        const uint32_t vm01 = (vis[0] ? 0xffffu : 0u) | (vis[1] ? 0xffff0000u : 0u);
        const uint32_t vm23 = (vis[2] ? 0xffffu : 0u) | (vis[3] ? 0xffff0000u : 0u);
        pv_group<C, true>(acc, pa, pl, sv, pvb, grp0, ds * C::DW, lane, vm01,
                          vm23);
      }
    }
    cp_wait<0>();
    __syncthreads();                        // the ring is free: merge the warps

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(FULL, l[r], 1);
      l[r] += __shfl_xor_sync(FULL, l[r], 2);
    }
    float* Mw = reinterpret_cast<float*>(smem);       // [WS][16]
    float* Lw = Mw + C::WS * 16;                      // [WS][16]
    float* Aw = Lw + C::WS * 16;                      // [WS][16][HDV]
    if (ds == 0 && c == 0) {
      Mw[sg * 16 + g] = m[0]; Mw[sg * 16 + g + 8] = m[1];
      Lw[sg * 16 + g] = l[0]; Lw[sg * 16 + g + 8] = l[1];
    }
#pragma unroll
    for (int nt = 0; nt < C::NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1);
        const int dim = ds * C::DW + o_dim<ES>(nt, 2 * c + (e & 1));
        Aw[(sg * 16 + r) * HDV + dim] = acc[nt][e];
      }
    __syncthreads();
    for (int i = threadIdx.x; i < mrows * dv; i += THREADS) {
      const int r = i / dv, dim = i - r * dv;
      float M = rt::kNegInf;
#pragma unroll
      for (int w = 0; w < C::WS; ++w) M = fmaxf(M, Mw[w * 16 + r]);
      float L = 0.f, A = 0.f;
#pragma unroll
      for (int w = 0; w < C::WS; ++w) {
        const float f = exp2f(Mw[w * 16 + r] - M);
        L += Lw[w * 16 + r] * f;
        A += Aw[(w * 16 + r) * HDV + dim] * f;
      }
      const int h = h0 + r;
      if (S == 1 && o != nullptr) {
        o[b * o_sb + row * o_ss + (long long)h * o_sh + dim] =
            __float2bfloat16(L > 0.f ? A / L : 0.f);
      } else {
        const long long pr = ((long long)blockIdx.z * S + split) * H + h;
        part_acc[pr * dv + dim] = A;
        if (dim == 0) {
          part_ml[2 * pr] = M * kLn2;       // natural units, as the combine's
          part_ml[2 * pr + 1] = L;
        }
      }
    }
    __syncthreads();                        // the next head tile reuses smem
  }
}

struct Args {
  const void *q, *k, *v;
  const int* pos;
  void* o;
  float *part_acc, *part_ml;
  int B, Sq, H, KVH, hs, d, dv, cap, tile, S, tps, pk, pv, nst, cb;
  long long q_sb, q_ss, q_sh, c_sb, c_ss, c_sh, v_sb, v_ss, v_sh, pos_sb,
      o_sb, o_ss, o_sh;
  float scale;
  int window, q_offset;
  cudaStream_t stream;
};

// The combine on its own (rt_decode_combine), one split included.
template <typename TQ>
cudaError_t launch_combine(const Args& a) {
  const size_t smem = a.S <= COMBINE_CACHED ? sizeof(float) * a.S : 0;
  decode_combine_kernel<TQ>
      <<<dim3(a.H, a.B * a.Sq), COMBINE_THREADS, smem, a.stream>>>(
      a.part_acc, a.part_ml, static_cast<TQ*>(a.o), a.Sq, a.H, a.dv, a.S,
      a.o_sb, a.o_ss, a.o_sh);
  return cudaGetLastError();
}

// After the split kernel: merge its splits into o, unless one split wrote
// o itself or the call stops at the partials (o == nullptr).
template <typename TQ>
cudaError_t combine(const Args& a) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.S == 1 || a.o == nullptr) return err;
  return launch_combine<TQ>(a);
}

// float32: the scalar kernel (tiles of 32 slots, the 3-stage ring, rows of
// pitch pk == pv, hs head shares)
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
          a.dv, a.cap, a.tile, a.tps, a.pk, a.cb, a.q_sb, a.q_ss, a.q_sh,
          a.c_sb, a.c_ss, a.c_sh, a.v_sb, a.v_ss, a.v_sh, a.pos_sb, a.o_sb,
          a.o_ss, a.o_sh, a.scale, a.window, a.q_offset);
  return (int)combine<TQ>(a);
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

int dispatch_scalar(const Args& a) {
  const int grp = a.H / (a.KVH * a.hs);     // query heads per block
  const int HD = a.d <= 64 ? 64 : a.d <= 128 ? 128 : 256;
  const int nj = (grp * HD + 127) / 128;
  if (grp * HD > 16 * 128 || a.pk != a.pv || a.nst != NST ||
      (a.pk * (int)sizeof(float)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t stage = 2 * (size_t)a.tile * a.pk * sizeof(float) + a.tile * sizeof(int);
  const size_t ring = (size_t)NST * stage;
  const size_t merge = sizeof(float) * (size_t)NW * (2 * grp + grp * HD);
  const size_t smem = ring > merge ? ring : merge;
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (HD == 64) return by_chunks<float, float, 64>(nj, a, smem);
  if (HD == 128) return by_chunks<float, float, 128>(nj, a, smem);
  return by_chunks<float, float, 256>(nj, a, smem);
}

// bfloat16 q: the tensor-core kernel
template <typename TKV, int HD, int HDV>
int launch_mma(const Args& a) {
  using C = Mma<TKV, HD, HDV>;
  constexpr int ES = C::ES;
  if (a.tile != C::TILE || a.hs != 1 || a.pk < HD || a.pv < HDV ||
      (a.pk * ES) % 16 != 0 || (a.pv * ES) % 16 != 0 || a.nst < 2 ||
      a.nst > 4)
    return (int)cudaErrorInvalidValue;
  const size_t stage = (size_t)C::TILE * (a.pk + a.pv) * ES + C::TILE * sizeof(int);
  const size_t ring = (size_t)a.nst * stage;
  const size_t merge = sizeof(float) * (size_t)C::WS * 16 * (2 + HDV);
  const size_t smem = ring > merge ? ring : merge;
  if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr =
      rt::allow_smem(decode_mma_kernel<TKV, HD, HDV>, SMEM_MAX);
  if (attr != cudaSuccess) return (int)attr;
  decode_mma_kernel<TKV, HD, HDV>
      <<<dim3(a.S, a.KVH, a.B * a.Sq), THREADS, smem, a.stream>>>(
          static_cast<const __nv_bfloat16*>(a.q), static_cast<const TKV*>(a.k),
          static_cast<const TKV*>(a.v), a.pos,
          static_cast<__nv_bfloat16*>(a.o), a.part_acc, a.part_ml, a.Sq, a.H,
          a.H / a.KVH, a.d, a.dv, a.cap, a.tps, a.pk, a.pv, a.nst, a.cb,
          a.q_sb, a.q_ss, a.q_sh, a.c_sb, a.c_ss, a.c_sh, a.v_sb, a.v_ss,
          a.v_sh, a.pos_sb, a.o_sb, a.o_ss, a.o_sh, a.scale, a.window,
          a.q_offset);
  return (int)combine<__nv_bfloat16>(a);
}

// V's padded head dim, at most K's
template <typename TKV, int HD>
int by_v(const Args& a) {
  if (a.dv <= 64) return launch_mma<TKV, HD, 64>(a);
  if constexpr (HD >= 128)
    if (a.dv <= 128) return launch_mma<TKV, HD, 128>(a);
  if constexpr (HD == 256) return launch_mma<TKV, HD, 256>(a);
  return (int)cudaErrorInvalidValue;
}

template <typename TKV>
int dispatch_mma(const Args& a) {
  if (a.d <= 64) return by_v<TKV, 64>(a);
  if (a.d <= 128) return by_v<TKV, 128>(a);
  return by_v<TKV, 256>(a);
}

}  // namespace

// q (B, Sq, H, D) at (sq, h) element strides q_ss, q_sh; K (B, cap, KVH,
// D) at (b, slot, head) strides c_sb, c_ss, c_sh and V (B, cap, KVH, DV),
// DV <= D, at v_sb, v_ss, v_sh, each head dim contiguous; pos (B, cap)
// int32 at row stride pos_sb; o (B, Sq, H, DV) in q's dtype. n_splits
// blocks of tps tiles of `tile` slots per (KV head, sequence x row) —
// and, on the float32 kernel, each of its HS shares of H / (KVH * HS)
// query heads; part_acc (B*Sq, n_splits, H, DV) and part_ml (B*Sq,
// n_splits, H, 2) float32 scratch when n_splits > 1. PK / PV: staged K / V
// row pitch in elements (16-byte multiples); NST: ring stages; cb: bytes
// per cp.async (16, 8 or 4). q_dtype 0 float32 / 1 bfloat16; kv_dtype 0
// float32 / 1 bfloat16 / 2 float8 e4m3 (with a bfloat16 q). The host plan
// (kernels/flash_decode.py : launch_plan, split_plan) picks tile, HS, PK,
// PV, NST and the splits; this entry point refuses a plan its kernel does
// not take. With o == nullptr the call stops at the partials: every split
// writes (P.V, m, l) to part_acc / part_ml, one split included, and no
// combine runs (kernels/flash_decode.py : flash_decode_partial; the
// partials of several calls are merged by rt_decode_combine).
extern "C" int rt_flash_decode(
    const void* q, const void* k, const void* v, const void* pos, void* o,
    void* part_acc, void* part_ml, int q_dtype, int kv_dtype, int B, int Sq,
    int H, int KVH, int HS, int D, int DV, int cap, int tile, int n_splits,
    int tps, int PK, int PV, int NSTAGES, int cb, long long q_sb,
    long long q_ss, long long q_sh, long long c_sb, long long c_ss,
    long long c_sh, long long v_sb, long long v_ss, long long v_sh,
    long long pos_sb, long long o_sb, long long o_ss, long long o_sh,
    float scale, int window, int q_offset, void* stream) {
  if (KVH <= 0 || HS <= 0 || H % (KVH * HS) != 0 || KVH * HS > 65535 ||
      D <= 0 || D > 256 || DV <= 0 || DV > D || cap <= 0 || tile <= 0 ||
      Sq <= 0 || n_splits <= 0 || tps <= 0 || n_splits > 65535 ||
      (long long)B * Sq > 65535 || PK < D || PV < DV ||
      (cb != 4 && cb != 8 && cb != 16) ||
      (long long)n_splits * tps * tile < cap ||
      ((n_splits > 1 || o == nullptr) &&
       (part_acc == nullptr || part_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  Args a{q, k, v, static_cast<const int*>(pos), o,
         static_cast<float*>(part_acc), static_cast<float*>(part_ml), B, Sq,
         H, KVH, HS, D, DV, cap, tile, n_splits, tps, PK, PV, NSTAGES, cb,
         q_sb, q_ss, q_sh, c_sb, c_ss, c_sh, v_sb, v_ss, v_sh, pos_sb, o_sb,
         o_ss, o_sh, scale, window, q_offset,
         static_cast<cudaStream_t>(stream)};
  if (q_dtype == rt::kF32 && kv_dtype == kKvF32) return dispatch_scalar(a);
  if (q_dtype == rt::kBF16 && kv_dtype == kKvBF16)
    return dispatch_mma<__nv_bfloat16>(a);
  if (q_dtype == rt::kBF16 && kv_dtype == kKvE4M3)
    return dispatch_mma<unsigned char>(a);
  return (int)cudaErrorInvalidValue;
}

// Merge S partials of each (sequence x query row, query head) into o:
// decode_combine_kernel over part_acc (B*Sq, S, H, D) and part_ml (B*Sq,
// S, H, 2) float32 — the splits of one or more rt_flash_decode calls
// without o, concatenated on the split axis (a cache whose slots are cut
// across ranks: each rank's splits, then the next rank's). o (B, Sq, H, D)
// in q_dtype (0 float32 / 1 bfloat16) at element strides o_sb, o_ss, o_sh.
extern "C" int rt_decode_combine(const void* part_acc, const void* part_ml,
                                 void* o, int q_dtype, int B, int Sq, int H,
                                 int D, int S, long long o_sb, long long o_ss,
                                 long long o_sh, void* stream) {
  if (part_acc == nullptr || part_ml == nullptr || o == nullptr || H <= 0 ||
      H > 65535 || D <= 0 || D > 256 || Sq <= 0 || S <= 0 ||
      (long long)B * Sq > 65535)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  Args a{};
  a.part_acc = const_cast<float*>(static_cast<const float*>(part_acc));
  a.part_ml = const_cast<float*>(static_cast<const float*>(part_ml));
  a.o = o;
  a.B = B, a.Sq = Sq, a.H = H, a.d = a.dv = D, a.S = S;
  a.o_sb = o_sb, a.o_ss = o_ss, a.o_sh = o_sh;
  a.stream = static_cast<cudaStream_t>(stream);
  if (q_dtype == rt::kF32) return (int)launch_combine<float>(a);
  if (q_dtype == rt::kBF16) return (int)launch_combine<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}
