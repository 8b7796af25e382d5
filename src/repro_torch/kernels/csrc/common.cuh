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

// Opt a kernel into more than 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace rt
