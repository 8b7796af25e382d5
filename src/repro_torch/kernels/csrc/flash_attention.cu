// Flash attention forward (prefill) for Hopper, float32 on the CUDA cores;
// the C entry point rt_flash_attention, which picks the kernel by dtype.
//
// Replaces: src/repro/kernels/flash_attention.py : flash_attention
//           (_flash_kernel, the Pallas TPU FlashAttention-2 schedule).
//
// Dispatch by dtype, not a fallback: bfloat16 runs the tensor-core kernel
// in flash_attention_wgmma.cu (wgmma + TMA). float32 runs this kernel,
// because the tensor cores take float32 only as TF32, which keeps about
// three decimal digits and cannot meet the 2e-5 float32 tolerance.
//
// What bounds it on this card: operations, about 2·Sq·n·(dk + dv) flops per
// head for n visible keys, against float32's 67 TFLOP/s on the CUDA cores.
//
// Design: one block per (64-row query tile, head, batch). The block walks
// 32-row K/V tiles staged in shared memory and keeps an online softmax
// (running max m, sum l, output accumulator) in registers, so the Sq×Skv
// score matrix never reaches device memory. 256 threads: four threads
// share one query row, each scores 8 keys of the tile and owns every
// fourth output column; the row's max and sum reduce with two warp
// shuffles. Q and K rows hold the key head dim dk (up to 256: MLA's 192 =
// 128 nope + 64 rope columns, RecurrentGemma's 256), V rows and the output
// the value head dim dv (up to dk); each thread owns dv / 4 output columns,
// held in CPT registers: an instance with CPT 32 takes dv up to 128, one
// with CPT 64 up to 256. Tiles wholly above the causal diagonal (taking the chunk's
// absolute `q_offset` into account) or wholly outside the sliding window
// are never loaded. GQA maps query head h to KV head h / grp by index.
// q, k, v and o are read through (batch, head, seq) strides with a unit
// stride on the head dimension, so the model hands in its (B, S, H, d)
// activations without a transpose copy. Shared rows are padded to dk + 1
// and dv + 1 floats (bank spread), so a launch takes what its head dims
// need: ~74 KB at dk = dv = 128, ~99 KB at dk 192 / dv 128, ~140 KB at
// 256 / 256, above the 48 KB default; the attribute is set once per
// process and instance, to the largest that instance takes.
#include "common.cuh"

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 32;           // keys per tile
constexpr int DKMAX = 256;       // largest key head dim (q, k)
constexpr int THREADS = 256;     // 4 threads per query row
constexpr int KPT = BK / 4;      // keys scored per thread per tile

// Shared bytes of a launch: Q [BQ][dk+1], K [BK][dk+1], V [BK][dv+1],
// P [BQ][BK+1] floats.
constexpr size_t smem_bytes(int dk, int dv) {
  return sizeof(float) * ((size_t)(BQ + BK) * (dk + 1) + (size_t)BK * (dv + 1)
                          + (size_t)BQ * (BK + 1));
}

// CPT: output columns owned per thread (value head dim up to 4 * CPT).
template <int CPT>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 int grp, int Sq, int DK, int DV,
                 long long q_sb, long long q_sh, long long q_ss,
                 long long k_sb, long long k_sh, long long k_ss,
                 long long v_sb, long long v_sh, long long v_ss,
                 long long o_sb, long long o_sh, long long o_ss,
                 float scale, int causal, int window, int q_offset, int kv_len) {
  extern __shared__ float smem[];
  const int LK = DK + 1, LV = DV + 1;   // padded shared row strides
  float* Qs = smem;                 // [BQ][LK]
  float* Ks = Qs + BQ * LK;         // [BK][LK]
  float* Vs = Ks + BK * LK;         // [BK][LV]
  float* Ps = Vs + BK * LV;         // [BQ][BK + 1]

  const int tid = threadIdx.x;
  const int row = tid >> 2;         // query row inside the tile
  const int quad = tid & 3;         // which quarter of the row's work
  const int qt0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / grp;

  const float* qb = q + b * q_sb + h * q_sh;
  const float* kb = k + b * k_sb + kvh * k_sh;
  const float* vb = v + b * v_sb + kvh * v_sh;

  for (int e = tid; e < BQ * DK; e += THREADS) {
    const int r = e / DK, c = e - r * DK;
    const int qi = qt0 + r;
    Qs[r * LK + c] = (qi < Sq) ? qb[(long long)qi * q_ss + c] : 0.f;
  }

  float acc[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) acc[i] = 0.f;
  float m_i = rt::kNegInf;
  float l_i = 0.f;

  const int qpos = q_offset + qt0 + row;                    // absolute position
  const int q_first = q_offset + qt0;
  const int q_last = q_offset + min(qt0 + BQ, Sq) - 1;
  int kv_end = kv_len;
  if (causal) kv_end = min(kv_end, q_last + 1);             // diagonal skip
  int kv_start = 0;
  if (window > 0) kv_start = max(0, q_first - window + 1);  // window skip
  const int t_begin = kv_start / BK;
  const int t_end = kv_end > kv_start ? (kv_end + BK - 1) / BK : t_begin;

  __syncthreads();
  for (int t = t_begin; t < t_end; ++t) {
    const int kt0 = t * BK;
    for (int e = tid; e < BK * DK; e += THREADS) {
      const int r = e / DK, c = e - r * DK;
      const int kj = kt0 + r;
      Ks[r * LK + c] = kj < kv_len ? kb[(long long)kj * k_ss + c] : 0.f;
    }
    for (int e = tid; e < BK * DV; e += THREADS) {
      const int r = e / DV, c = e - r * DV;
      const int kj = kt0 + r;
      Vs[r * LV + c] = kj < kv_len ? vb[(long long)kj * v_ss + c] : 0.f;
    }
    __syncthreads();

    float s[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) s[j] = 0.f;
    const float* qrow = Qs + row * LK;
    const float* kbase = Ks + (quad * KPT) * LK;
    for (int c = 0; c < DK; ++c) {
      const float qv = qrow[c];
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[j] += qv * kbase[j * LK + c];
    }
    float tmax = -INFINITY;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kj = kt0 + quad * KPT + j;
      bool ok = kj < kv_len;
      if (causal) ok = ok && (kj <= qpos);
      if (window > 0) ok = ok && (qpos - kj < window);
      s[j] = ok ? s[j] * scale : -INFINITY;
      tmax = fmaxf(tmax, s[j]);
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m_i, tmax);
    const float alpha = expf(m_i - m_new);
    float psum = 0.f;
    float* prow = Ps + row * (BK + 1);
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const float p = expf(s[j] - m_new);     // masked keys: exp(-inf) = 0
      prow[quad * KPT + j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l_i = l_i * alpha + psum;
    m_i = m_new;
    __syncwarp();                              // the row's 4 threads share a warp
#pragma unroll
    for (int i = 0; i < CPT; ++i) acc[i] *= alpha;
    for (int j = 0; j < BK; ++j) {
      const float p = prow[j];
      const float* vrow = Vs + j * LV + quad;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        if (quad + 4 * i < DV) acc[i] += p * vrow[4 * i];
      }
    }
    __syncthreads();                           // before the next tile overwrites K/V
  }

  const int qi = qt0 + row;
  if (qi < Sq) {
    const float l = fmaxf(l_i, 1e-30f);        // a row with no visible key writes 0
    float* orow = o + b * o_sb + h * o_sh + (long long)qi * o_ss;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = quad + 4 * i;
      if (c < DV) orow[c] = acc[i] / l;
    }
  }
}

// The float32 launch of the instance with CPT output columns a thread.
template <int CPT>
int launch_f32(const float* q, const float* k, const float* v, float* o,
               int B, int H, int KVH, int Sq, int DK, int DV, long long q_sb,
               long long q_sh, long long q_ss, long long k_sb, long long k_sh,
               long long k_ss, long long v_sb, long long v_sh, long long v_ss,
               long long o_sb, long long o_sh, long long o_ss, float scale,
               int causal, int window, int q_offset, int kv_len,
               cudaStream_t s) {
  static const cudaError_t attr =
      rt::allow_smem(flash_fwd_kernel<CPT>, smem_bytes(DKMAX, 4 * CPT));
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<CPT><<<grid, THREADS, smem_bytes(DK, DV), s>>>(
      q, k, v, o, H / KVH, Sq, DK, DV, q_sb, q_sh, q_ss, k_sb, k_sh, k_ss,
      v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale, causal, window, q_offset,
      kv_len);
  return (int)cudaGetLastError();
}

}  // namespace

// The bfloat16 kernel's launch (flash_attention_wgmma.cu).
int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int B, int H, int KVH, int Sq, int DK, int DV,
                         long long q_sb, long long q_sh, long long q_ss,
                         long long k_sb, long long k_sh, long long k_ss,
                         long long v_sb, long long v_sh, long long v_ss,
                         long long o_sb, long long o_sh, long long o_ss,
                         float scale, int causal, int window, int q_offset,
                         int kv_len, cudaStream_t stream);

// DK: head dim of q and k; DV: head dim of v and o (DV <= DK <= 256).
extern "C" int rt_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int B, int H, int KVH, int Sq, int DK, int DV,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    float scale, int causal, int window, int q_offset, int kv_len,
    void* stream) {
  if (DK > DKMAX || DK <= 0 || DV <= 0 || DV > DK || KVH <= 0 ||
      H % KVH != 0)
    return (int)cudaErrorInvalidValue;
  if (Sq <= 0 || B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kBF16)
    return flash_attention_bf16(q, k, v, o, B, H, KVH, Sq, DK, DV, q_sb, q_sh,
                                q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb,
                                o_sh, o_ss, scale, causal, window, q_offset,
                                kv_len, s);
  if (dtype != rt::kF32) return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  if (DV <= 128)
    return launch_f32<32>(qf, kf, vf, of, B, H, KVH, Sq, DK, DV, q_sb, q_sh,
                          q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb,
                          o_sh, o_ss, scale, causal, window, q_offset,
                          kv_len, s);
  return launch_f32<64>(qf, kf, vf, of, B, H, KVH, Sq, DK, DV, q_sb, q_sh,
                        q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh,
                        o_ss, scale, causal, window, q_offset, kv_len, s);
}
