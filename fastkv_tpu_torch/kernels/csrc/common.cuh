// Helpers shared by the port's hand-written Hopper kernels.
//
// Each kernel library is built on its own with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes (fastkv_tpu_torch/kernels/build.py). The C entry points
// take raw device pointers and the caller's stream, and return
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fastkv {

// dtype codes passed from the wrappers
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round a float32 value to the storage type and back: the reference casts the
// softmax probabilities to V's dtype before the P.V product.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Reductions over the 16 lanes of a half warp (xor masks stay inside it).
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int m = 8; m >= 1; m >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int m = 8; m >= 1; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

}  // namespace fastkv

extern "C" const char* fastkv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
