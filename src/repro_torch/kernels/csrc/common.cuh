// Shared helpers for the port's hand-written kernels (sm_90a).
//
// Every kernel takes float32 or bfloat16 tensors. Arithmetic runs in
// float32; loads convert up with __bfloat162float and stores convert down
// with __float2bfloat16 (round to nearest even, the same rounding as
// torch's and ml_dtypes' casts), so a cast in a kernel gives the same bits
// as `.to(torch.bfloat16)`.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace rt {

enum DType : int { kF32 = 0, kBF16 = 1 };

constexpr float kNegInf = -1e30f;   // finite "minus infinity" of the running max

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Element cast between pool/canon types. Same-type moves copy the bits.
template <typename To, typename From>
__device__ __forceinline__ To cvt(From x) { return from_f<To>(to_f(x)); }
template <> __device__ __forceinline__ float cvt<float, float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16
cvt<__nv_bfloat16, __nv_bfloat16>(__nv_bfloat16 x) { return x; }

// cp.async of 16, 8 or 4 bytes from global into shared memory, its commit
// and wait (the split-KV decode kernels' staging).
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
                 : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Elements c .. c+3 of a staged row as float32; zero past d.
__device__ __forceinline__ void row4(const float* r, int c, int d, float* x) {
  if (c + 4 <= d) {
    const float4 v = *reinterpret_cast<const float4*>(r + c);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = c + i < d ? r[c + i] : 0.f;
  }
}
__device__ __forceinline__ void row4(const __nv_bfloat16* r, int c, int d,
                                     float* x) {
  if (c + 4 <= d) {
    const uint2 v = *reinterpret_cast<const uint2*>(r + c);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = c + i < d ? __bfloat162float(r[c + i]) : 0.f;
  }
}

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace rt
