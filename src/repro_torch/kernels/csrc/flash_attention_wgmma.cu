// Flash attention forward (prefill) for Hopper in bfloat16: tensor cores
// through wgmma, tiles through TMA.
//
// Replaces: src/repro/kernels/flash_attention.py : flash_attention
//           (_flash_kernel, the Pallas TPU FlashAttention-2 schedule), for
//           bfloat16. float32 keeps the CUDA-core kernel in
//           flash_attention.cu: the tensor cores take float32 only as TF32,
//           which keeps about three decimal digits and cannot meet the
//           2e-5 float32 tolerance. rt_flash_attention picks the kernel by
//           dtype; neither is a fallback for the other.
//
// What bounds it on this card: operations. A chunk of Sq queries over n
// visible keys does 4·Sq·n·d flops per head against reading q, k, v once,
// far above the H100's ~295 flops per byte ridge, so the floor is the
// flops over the 989 TFLOP/s of the bf16 tensor cores.
//
// Design (FlashAttention-3's forward schedule, without its intra-warpgroup
// overlap): one block per (query tile, head, batch), the query tiles of a
// launch walked heaviest first (the last tile of a causal launch sees the
// most keys). A block is NWG consumer warpgroups of 64 query rows each and
// one producer warpgroup, of which one thread issues every load. Three
// instances (struct Cfg), picked by the head dims:
//   key dim <= 128:            2 consumers, 128-row Q tile, 128-key tiles;
//   <= 192, value dim <= 128:  the same tiles, MLA's 192 / 128;
//   up to 256 / 256:           1 consumer, 64-row Q tile, 64-key tiles
//                              (RecurrentGemma's 256 / 256).
// With two consumers setmaxnreg moves registers from the producer (24) to
// the consumers (240); the one-consumer instance runs 256 threads, whose
// launch bound already gives every thread up to 255 registers.
// - TMA loads the Q tile once, then K and V tiles of BN keys into a ring
//   of 2 stages. Each tile is stored as 64-column chunks of 128-byte rows
//   with the 128-byte swizzle. The key head dim (Q and K) is padded to DKP
//   columns (128, 192 or 256), the value head dim (V and O) to DVP (128 or
//   256). TMA's zero fill does the padding, so every head dim that is a
//   multiple of 16 runs the code of the instance that covers it. Shared
//   memory: at DKP 192, Q 48 KiB + 2 stages x (K 48 KiB + V 32 KiB) = 208
//   KiB; at 256 / 256 with 64-row tiles, Q 32 KiB + 2 x (32 + 32) = 160
//   KiB (128-row tiles would need 320 KiB, and a 64 x 256 float32 output
//   block is already 128 registers a thread). Full
//   barriers (TMA's transaction count: K and V tiles differ in bytes) and
//   empty barriers (one arrival per consumer thread) hand each stage over. The
//   tensor maps (Q and K over dk columns, V over dv) are built on the host
//   in the C entry point from the strides the
//   wrapper passes (cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint, so the library needs no -lcuda) and go in as
//   __grid_constant__ parameters. The maps bound the sequence axes at Sq
//   and kv_len, so rows and keys past them arrive as zeros.
// - S = Q·Kᵀ by wgmma m64nBNk16 with both operands in shared memory
//   (K-major), DKP / 16 k-steps, and float32 accumulators in registers. The causal, window
//   and kv_len masks are applied in registers, only on tiles that cross
//   the diagonal, the window edge or kv_len; tiles wholly outside them are
//   never loaded (flash_tile_range, mirrored by
//   kernels/flash_attention.py:tile_plan).
// - Online softmax on the accumulators: running max and sum per row in
//   registers, rescale by exp2((m_old - m_new)·scale·log2 e), row maxima
//   reduced over the four threads of a row with two shuffles; each thread
//   keeps a partial row sum, reduced once at the end.
// - O += P·V by wgmma m64nDVPk16 with P rounded to bf16 in registers (the A operand
//   from registers: the S accumulator layout is the A fragment layout)
//   and V in shared memory as a transposed (MN-major) B operand. O stays
//   in registers until the end, is divided by the row sum and stored as
//   bf16 pairs through the output strides. A row with no visible key has
//   a zero sum and writes zeros.
// Registers: under the 384-thread launch bound ptxas allocates the consumer
// code of the two-consumer instances within 168 registers whether or not
// setmaxnreg raises the budget at run time, so it serializes the wgmma chain
// (ptxas C7512) and spills 80 bytes; the 256 / 256 instance takes 202
// registers (its 128 output accumulators a thread among them), with no
// spill and no serialization. Two rewrites were tried on the H100 and not kept: overlapping one
// tile's softmax with the previous tile's P·V in the same warpgroup (3
// stages) was slower; P through shared memory instead of registers (no
// serialization, no spills) ran at the same speed, so the serialization is
// not what limits this kernel.
// q, k, v are read through (batch, head, seq) strides, so the model hands
// in its (B, S, H, d) activations and (B, cap, KV, d) cache transposed,
// with no copy; TMA needs each base pointer and stride 16-byte aligned
// (the wrapper checks and names the cause). GQA maps query head h to KV
// head h / grp.
#include <cuda.h>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int CW = 64;             // columns of one 128-byte swizzled row
constexpr int STAGES = 2;

// One instance: key head dim padded to DKP, value head dim to DVP, NWG
// consumer warpgroups of 64 query rows, key tiles of BN rows.
template <int DKP_, int DVP_, int NWG_, int BN_>
struct Cfg {
  static constexpr int DKP = DKP_, DVP = DVP_, NWG = NWG_, BN = BN_;
  static constexpr int BM = 64 * NWG;                       // query rows
  static constexpr int CONSUMERS = 128 * NWG;
  static constexpr int THREADS = CONSUMERS + 128;           // + producer
  static constexpr int NCHK = DKP / CW;                     // Q, K chunks
  static constexpr int NCHV = DVP / CW;                     // V chunks
  static constexpr uint32_t CHUNK_BYTES = BN * CW * 2;      // one chunk
  static constexpr uint32_t QK_BYTES = NCHK * CHUNK_BYTES;  // a Q or K tile
  static constexpr uint32_t V_BYTES = NCHV * CHUNK_BYTES;
  static constexpr uint32_t STAGE_BYTES = QK_BYTES + V_BYTES;
  static constexpr uint32_t TILES = QK_BYTES + STAGES * STAGE_BYTES;
  static constexpr size_t BYTES = TILES + 64 + 1024;        // + barriers, align
  static_assert(BM == BN, "the Q tile uses the K/V tile's box");
  static_assert(DKP % CW == 0 && DVP % CW == 0 && DKP >= DVP, "head dims");
  static_assert(BYTES <= 232448, "fits 227 KB");
};
using Cfg128 = Cfg<128, 128, 2, 128>;
using Cfg192 = Cfg<192, 128, 2, 128>;
using Cfg256 = Cfg<256, 256, 1, 64>;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`. A
// wait that has not completed after 2^26 polls (over a second) traps, so a
// broken hand-over fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. K-major operands (Q, K:
// the reduction axis contiguous) use only SBO, the 1024-byte stride between
// 8-row groups. The MN-major operand (V: the output axis contiguous) also
// uses LBO, the stride between its 64-column halves.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16
         | static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32
         | static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads of wgmma results above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

#define RT_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                 "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define RT_D32 RT_D8(0), RT_D8(8), RT_D8(16), RT_D8(24)
#define RT_D64 RT_D32, RT_D8(32), RT_D8(40), RT_D8(48), RT_D8(56)
#define RT_D128 RT_D64, RT_D8(64), RT_D8(72), RT_D8(80), RT_D8(88), \
                RT_D8(96), RT_D8(104), RT_D8(112), RT_D8(120)
#define RT_R32                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "     \
  "%30, %31}"
#define RT_R64                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "     \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "     \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "     \
  "%58, %59, %60, %61, %62, %63}"
#define RT_R128                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "    \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "     \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "     \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "     \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "     \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "     \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "     \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "   \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "   \
  "%124, %125, %126, %127}"

// d (64 rows x N f32, this warpgroup's rows; N = 128 or 64 by the size of
// d) = (accumulate ? d : 0) + A·B, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " RT_R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : RT_D64
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RT_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : RT_D32
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A·B, A (64x16 bf16) from registers, B MN-major in shared memory;
// N = 128 or 256 by the size of d.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " RT_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : RT_D64
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_rs(float (&d)[128], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " RT_R128
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : RT_D128
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Key tiles [t_begin, t_begin + n) a block of query rows [q0, q1) visits:
// every tile of BN keys holding a visible key of some row, no other.
// Mirrored by kernels/flash_attention.py:tile_plan.
template <int BN>
__device__ __forceinline__ void flash_tile_range(int q0, int q1, int q_offset,
                                                 int kv_len, int causal,
                                                 int window, int& t_begin,
                                                 int& n) {
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, q_offset + q1);
  int kv_start = 0;
  if (window > 0) kv_start = max(0, q_offset + q0 - window + 1);
  t_begin = kv_start / BN;
  n = kv_end > kv_start ? (kv_end + BN - 1) / BN - t_begin : 0;
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
flash_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o, int grp, int Sq, int DV,
                       long long o_sb, long long o_sh, long long o_ss,
                       float scale, int causal, int window, int q_offset,
                       int kv_len) {
  constexpr int BN = C::BN, BM = C::BM;
  constexpr int NS = BN / 8;          // 8-key column groups of an S tile
  constexpr int NO = C::DVP / 8;      // 8-column groups of the O tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;      // 128-byte swizzle atoms
  const uint32_t q_s = base;
  const uint32_t kv_s = base + C::QK_BYTES;         // stage s: K, then V
  const uint32_t bars = base + C::TILES;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * STAGES + s); };
  auto k_tile = [&](int s) { return kv_s + s * C::STAGE_BYTES; };
  auto v_tile = [&](int s) { return k_tile(s) + C::QK_BYTES; };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;  // heaviest tile first
  int t_begin, n_tiles;
  flash_tile_range<BN>(q0, min(q0 + BM, Sq), q_offset, kv_len, causal, window,
                       t_begin, n_tiles);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), C::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= C::CONSUMERS) {
    // ---------------------------------------------------------- producer
    if constexpr (C::NWG > 1)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == C::CONSUMERS) {
      const int kvh = h / grp;
      mbar_expect_tx(q_full, C::QK_BYTES);
      for (int c = 0; c < C::NCHK; ++c)
        tma_load(q_s + c * C::CHUNK_BYTES, &tq, q_full, c * CW, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        mbar_wait(empty(s), ((it / STAGES) & 1) ^ 1);
        const int kt0 = (t_begin + it) * BN;
        mbar_expect_tx(k_full(s), C::QK_BYTES);
        for (int c = 0; c < C::NCHK; ++c)
          tma_load(k_tile(s) + c * C::CHUNK_BYTES, &tk, k_full(s), c * CW,
                   kt0, kvh, b);
        mbar_expect_tx(v_full(s), C::V_BYTES);
        for (int c = 0; c < C::NCHV; ++c)
          tma_load(v_tile(s) + c * C::CHUNK_BYTES, &tv, v_full(s), c * CW,
                   kt0, kvh, b);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    if constexpr (C::NWG > 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = threadIdx.x / 128;
    const int lane = threadIdx.x % 32;
    const int row = wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
    const int qpos0 = q_offset + q0 + row;      // this thread's two rows:
    const int qpos1 = qpos0 + 8;                // row and row + 8
    const int wq_first = q_offset + q0 + wg * 64;
    const int wq_last = wq_first + 63;
    const float sl2 = scale * 1.4426950408889634f;

    float acc[C::DVP / 2];
#pragma unroll
    for (int i = 0; i < C::DVP / 2; ++i) acc[i] = 0.f;
    float m0 = rt::kNegInf, m1 = rt::kNegInf, l0 = 0.f, l1 = 0.f;

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % STAGES;
      const uint32_t phase = (it / STAGES) & 1;
      const int kt0 = (t_begin + it) * BN;
      float sc[BN / 2];
      mbar_wait(k_full(s), phase);
      wg_fence();
#pragma unroll
      for (int c = 0; c < C::NCHK; ++c) {
#pragma unroll
        for (int kk = 0; kk < CW / 16; ++kk) {
          const uint64_t da = make_desc(
              q_s + c * C::CHUNK_BYTES + wg * 64 * 128 + kk * 32, 16, 1024);
          const uint64_t db =
              make_desc(k_tile(s) + c * C::CHUNK_BYTES + kk * 32, 16, 1024);
          wgmma_ss(sc, da, db, (c | kk) != 0);
        }
      }
      wg_commit();
      wg_wait_all();
      fence_regs(sc);

      // masks, only where the tile crosses one of their edges
      if (kt0 + BN > kv_len || (causal && kt0 + BN - 1 > wq_first) ||
          (window > 0 && kt0 <= wq_last - window)) {
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = kt0 + 8 * j + 2 * (lane % 4) + e;
            bool ok0 = key < kv_len, ok1 = ok0;
            if (causal) { ok0 = ok0 && key <= qpos0; ok1 = ok1 && key <= qpos1; }
            if (window > 0) {
              ok0 = ok0 && qpos0 - key < window;
              ok1 = ok1 && qpos1 - key < window;
            }
            if (!ok0) sc[4 * j + e] = -INFINITY;
            if (!ok1) sc[4 * j + 2 + e] = -INFINITY;
          }
        }
      }

      // online softmax: new row maxima (raw scores), rescale, probabilities
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float a0 = exp2f((m0 - mx0) * sl2);
      const float a1 = exp2f((m1 - mx1) * sl2);
      m0 = mx0;
      m1 = mx1;
      const float mb0 = mx0 * sl2, mb1 = mx1 * sl2;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sc[4 * j + e] = exp2f(fmaf(sc[4 * j + e], sl2, -mb0));   // masked: 0
          sc[4 * j + 2 + e] = exp2f(fmaf(sc[4 * j + 2 + e], sl2, -mb1));
          ps0 += sc[4 * j + e];
          ps1 += sc[4 * j + 2 + e];
        }
      }
      l0 = l0 * a0 + ps0;
      l1 = l1 * a1 + ps1;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[4 * j] *= a0;
        acc[4 * j + 1] *= a0;
        acc[4 * j + 2] *= a1;
        acc[4 * j + 3] *= a1;
      }
      // P in bf16 as the A fragments of the BN / 16 k-steps of 16 keys
      uint32_t pa[BN / 4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pa[4 * kk + 0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pa[4 * kk + 1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pa[4 * kk + 2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pa[4 * kk + 3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }

      mbar_wait(v_full(s), phase);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t db = make_desc(v_tile(s) + kk * 16 * 128,
                                      C::CHUNK_BYTES, 1024);
        wgmma_rs(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                 pa[4 * kk + 3], db);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(empty(s));
    }

    // epilogue: row sums over the row's four threads, O / l, bf16 pairs
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;   // no visible key: zeros
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    const int qi0 = q0 + row, qi1 = qi0 + 8;
    __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      if (col < DV) {
        if (qi0 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + qi0 * o_ss + col) =
              __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
        if (qi1 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + qi1 * o_ss + col) =
              __floats2bfloat162_rn(acc[4 * j + 2] * inv1,
                                    acc[4 * j + 3] * inv1);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A 4-D map over (dim, seq, head, batch) with element strides (seq, head,
// batch), boxes of 64 columns x `rows` rows, 128-byte swizzle, zero fill.
bool make_map(CUtensorMap* map, const void* ptr, int D, int seq, int heads,
              int batch, long long s_seq, long long s_head, long long s_batch,
              int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)seq,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)s_seq * 2, (cuuint64_t)s_head * 2,
                                 (cuuint64_t)s_batch * 2};
  const cuuint32_t box[4] = {CW, (cuuint32_t)rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class C>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KVH, int Sq, int DK, int DV, long long q_sb, long long q_sh,
           long long q_ss, long long k_sb, long long k_sh, long long k_ss,
           long long v_sb, long long v_sh, long long v_ss, long long o_sb,
           long long o_sh, long long o_ss, float scale, int causal,
           int window, int q_offset, int kv_len, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  const int kv_rows = kv_len > 0 ? kv_len : 1;   // no tile is loaded at 0
  if (!make_map(&tq, q, DK, Sq, H, B, q_ss, q_sh, q_sb, C::BN) ||
      !make_map(&tk, k, DK, kv_rows, KVH, B, k_ss, k_sh, k_sb, C::BN) ||
      !make_map(&tv, v, DV, kv_rows, KVH, B, v_ss, v_sh, v_sb, C::BN))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel_wgmma<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(H, B, (Sq + C::BM - 1) / C::BM);
  flash_fwd_kernel_wgmma<C><<<grid, C::THREADS, C::BYTES, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), H / KVH, Sq, DV, o_sb, o_sh,
      o_ss, scale, causal, window, q_offset, kv_len);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16 launch, called by rt_flash_attention (flash_attention.cu). DK is
// the head dim of q and k, DV that of v and o. Every stride is in
// elements; the wrapper has checked TMA's 16-byte alignment.
int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int B, int H, int KVH, int Sq, int DK, int DV,
                         long long q_sb, long long q_sh, long long q_ss,
                         long long k_sb, long long k_sh, long long k_ss,
                         long long v_sb, long long v_sh, long long v_ss,
                         long long o_sb, long long o_sh, long long o_ss,
                         float scale, int causal, int window, int q_offset,
                         int kv_len, cudaStream_t stream) {
  if (DK % 16 != 0 || DV % 16 != 0 || DK > 256 || DV > DK)
    return (int)cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  auto run = [&](auto cfg) {
    return launch<decltype(cfg)>(q, k, v, o, B, H, KVH, Sq, DK, DV, q_sb, q_sh,
                                 q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
                                 o_sb, o_sh, o_ss, scale, causal, window,
                                 q_offset, kv_len, stream);
  };
  if (DK <= 128) return run(Cfg128{});
  if (DK <= 192 && DV <= 128) return run(Cfg192{});
  return run(Cfg256{});
}
