// Flash attention forward (prefill) for Hopper, float32 or bfloat16.
//
// Replaces: src/repro/kernels/flash_attention.py : flash_attention
//           (_flash_kernel, the Pallas TPU FlashAttention-2 schedule).
//
// What bounds it on this card: operations. A prefill of S tokens does
// about 4·S²·d/2 multiply-adds per head under the causal mask against
// reading each of q, k, v once, far above the H100's ~295 operations per
// byte ridge. This first version runs the products on the CUDA cores in
// float32 (no wgmma yet), so it sits well below the tensor-core peak.
//
// Design: one block per (64-row query tile, head, batch). The block walks
// 32-row K/V tiles staged in shared memory as float32 and keeps an online
// softmax (running max m, sum l, output accumulator) in registers, so the
// Sq×Skv score matrix never reaches device memory. 256 threads: four
// threads share one query row, each scores 8 keys of the tile and owns
// every fourth output column; the row's max and sum reduce with two warp
// shuffles. Tiles wholly above the causal diagonal (taking the chunk's
// absolute `q_offset` into account) or wholly outside the sliding window
// are never loaded. GQA maps query head h to KV head h / grp by index.
// q, k, v and o are read through (batch, head, seq) strides with a unit
// stride on the head dimension, so the model hands in its (B, S, H, d)
// activations without a transpose copy. Shared memory (~74 KB) is above
// the 48 KB default and is opted into with cudaFuncSetAttribute.
#include "common.cuh"

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 32;           // keys per tile
constexpr int DMAX = 128;        // largest head_dim
constexpr int LDS = DMAX + 1;    // padded shared row stride (bank spread)
constexpr int THREADS = 256;     // 4 threads per query row
constexpr int KPT = BK / 4;      // keys scored per thread per tile
constexpr int CPT = DMAX / 4;    // output columns owned per thread

constexpr size_t kSmemBytes =
    sizeof(float) * (size_t)(BQ * LDS + 2 * BK * LDS + BQ * (BK + 1));

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int grp, int Sq, int D,
                 long long q_sb, long long q_sh, long long q_ss,
                 long long k_sb, long long k_sh, long long k_ss,
                 long long v_sb, long long v_sh, long long v_ss,
                 long long o_sb, long long o_sh, long long o_ss,
                 float scale, int causal, int window, int q_offset, int kv_len) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // [BQ][LDS]
  float* Ks = Qs + BQ * LDS;        // [BK][LDS]
  float* Vs = Ks + BK * LDS;        // [BK][LDS]
  float* Ps = Vs + BK * LDS;        // [BQ][BK + 1]

  const int tid = threadIdx.x;
  const int row = tid >> 2;         // query row inside the tile
  const int quad = tid & 3;         // which quarter of the row's work
  const int qt0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / grp;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kvh * k_sh;
  const T* vb = v + b * v_sb + kvh * v_sh;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, c = e - r * D;
    const int qi = qt0 + r;
    Qs[r * LDS + c] = (qi < Sq) ? rt::to_f(qb[(long long)qi * q_ss + c]) : 0.f;
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
  const int t_end = (kv_end + BK - 1) / BK;

  __syncthreads();
  for (int t = t_begin; t < t_end; ++t) {
    const int kt0 = t * BK;
    for (int e = tid; e < BK * D; e += THREADS) {
      const int r = e / D, c = e - r * D;
      const int kj = kt0 + r;
      const bool in = kj < kv_len;
      Ks[r * LDS + c] = in ? rt::to_f(kb[(long long)kj * k_ss + c]) : 0.f;
      Vs[r * LDS + c] = in ? rt::to_f(vb[(long long)kj * v_ss + c]) : 0.f;
    }
    __syncthreads();

    float s[KPT];
#pragma unroll
    for (int j = 0; j < KPT; ++j) s[j] = 0.f;
    const float* qrow = Qs + row * LDS;
    const float* kbase = Ks + (quad * KPT) * LDS;
    for (int c = 0; c < D; ++c) {
      const float qv = qrow[c];
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[j] += qv * kbase[j * LDS + c];
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
      const float* vrow = Vs + j * LDS + quad;
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        if (quad + 4 * i < D) acc[i] += p * vrow[4 * i];
      }
    }
    __syncthreads();                           // before the next tile overwrites K/V
  }

  const int qi = qt0 + row;
  if (qi < Sq) {
    const float l = fmaxf(l_i, 1e-30f);        // a row with no visible key writes 0
    T* orow = o + b * o_sb + h * o_sh + (long long)qi * o_ss;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = quad + 4 * i;
      if (c < D) orow[c] = rt::from_f<T>(acc[i] / l);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           int B, int H, int KVH, int Sq, int D,
           long long q_sb, long long q_sh, long long q_ss,
           long long k_sb, long long k_sh, long long k_ss,
           long long v_sb, long long v_sh, long long v_ss,
           long long o_sb, long long o_sh, long long o_ss,
           float scale, int causal, int window, int q_offset, int kv_len,
           cudaStream_t stream) {
  cudaError_t err = rt::allow_smem(flash_fwd_kernel<T>, kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T><<<grid, THREADS, kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H / KVH, Sq, D,
      q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
      scale, causal, window, q_offset, kv_len);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rt_flash_attention(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int B, int H, int KVH, int Sq, int D,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    float scale, int causal, int window, int q_offset, int kv_len,
    void* stream) {
  if (D > DMAX || D <= 0 || KVH <= 0 || H % KVH != 0) return (int)cudaErrorInvalidValue;
  if (Sq <= 0 || B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    return launch<float>(q, k, v, o, B, H, KVH, Sq, D, q_sb, q_sh, q_ss,
                         k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
                         scale, causal, window, q_offset, kv_len, s);
  if (dtype == rt::kBF16)
    return launch<__nv_bfloat16>(q, k, v, o, B, H, KVH, Sq, D, q_sb, q_sh, q_ss,
                                 k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh,
                                 o_ss, scale, causal, window, q_offset, kv_len, s);
  return (int)cudaErrorInvalidValue;
}
