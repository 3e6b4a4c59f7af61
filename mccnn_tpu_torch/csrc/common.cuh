// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel is templated on the volume storage type (float or
// __nv_bfloat16) and accumulates in float. Conversions to bf16 round to
// nearest even, like torch's .to(torch.bfloat16) and JAX's astype.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mccnn {

// Cost held in padded disparity lanes (d >= ndisp); ops/common.py BIG_COST.
constexpr float kBigCost = 1e9f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Zero-filling asynchronous copies from device to shared memory (cp.async
// with a source size): when !valid nothing is read and the destination is
// filled with zeros, so `global` only has to be some mapped address.
__device__ __forceinline__ void copy_async_16(void* shared, const void* global,
                                              bool valid) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(shared));
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(global), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void copy_async_4(void* shared, const void* global,
                                             bool valid) {
  const unsigned addr =
      static_cast<unsigned>(__cvta_generic_to_shared(shared));
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr),
               "l"(global), "r"(bytes)
               : "memory");
}

// Whether every pointer is 16-byte aligned, as 16-byte copies and stores
// need.
template <typename... Pointers>
inline bool aligned_16(Pointers... pointers) {
  return ((reinterpret_cast<size_t>(pointers) % 16 == 0) && ...);
}

// Shared memory one block may use on Hopper (227 KB of the SM's 256 KB).
constexpr int kMaxSharedBytes = 232448;

// Raise a kernel's dynamic shared-memory limit (above 48 KB it must be asked
// for) at the kernel's first launch on each device instead of on every
// launch. For kernels whose `bytes` is a constant; `done` is a static array
// of the caller, one per kernel instantiation.
constexpr int kMaxDevices = 16;
template <typename Kernel>
inline cudaError_t allow_shared_once(Kernel kernel, size_t bytes,
                                     bool (&done)[kMaxDevices]) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool tracked = device >= 0 && device < kMaxDevices;
  if (tracked && done[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && tracked) done[device] = true;
  return err;
}

}  // namespace mccnn
