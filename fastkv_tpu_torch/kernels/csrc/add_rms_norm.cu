// add_rms_norm: a decode step's residual add and RMSNorm, for Hopper.
//
// Replaces no TPU kernel. The JAX package leaves this step to XLA, which fuses
// it; in the port each norm was 8 small PyTorch launches in bf16 (the float32
// upcast, square, mean, + eps, rsqrt, two products, the cast back) and the
// residual add one more, at both norm sites of every decode layer: ~18
// launches a layer of a few KB each. This is a norm site in one launch.
//
// Two forms over rows x [B, D] (the decode step's [b, 1, D]), contiguous, bf16
// or float32, with a float32 weight w [D]:
//  * rms_norm: out = x * rsqrt(mean(x^2) + eps) * w;
//  * add_rms_norm (delta given): h = x + delta is written, and out is h's norm.
//
// The arithmetic is PyTorch's composition, rounded where it rounds: the
// residual add in float32, rounded to the storage type before it is squared
// (so h is bit for bit x + delta); the squares summed in float32, the sum
// times 1 / D, rsqrtf(var + eps); the row times that, then times w, each
// product rounded on its own (__fmul_rn: no FMA contraction), then the cast.
// The sum is taken in another order than PyTorch's reduction, so out is within
// one bf16 ulp of the plain version's (float32: within the sum's rounding).
//
// Bound on the H100: latency. At Mistral-Nemo-12B's width (D 5120, b 1) a call
// moves ~51 KB (x, delta, h and out in bf16, w in float32): ~15 ns at 3.35
// TB/s, against ~2 us for a launch. So one CTA a row, its block sized by D:
// each thread holds up to kVecs 16-byte vectors of the row, and issues every
// load it needs (the row's vectors, delta's, and w's) before it uses any, so
// a call waits on memory once; the sum of squares is a warp-shuffle reduction
// and one shared-memory pass; the row is never read twice.
#include "common.cuh"

namespace {

using fastkv::round_to;

constexpr int kVecs = 4;          // 16-byte vectors of the row a thread holds
// so kVecs vectors of the row and of w fit in registers; the widest row is then
// kMaxThreads x kVecs x 16 bytes (ops/add_rms_norm.py MAX_ROW_BYTES)
constexpr int kMaxThreads = 512;

struct Args {
  const void* x;      // [B, D]
  const void* delta;  // [B, D], or null: the norm alone
  const float* w;     // [D]
  void* h;            // [B, D]: x + delta (add form)
  void* out;          // [B, D]: the normed row
  int D;
  float eps;
};

// 16 bytes of T as floats, and back.
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int n = 4;
  __device__ __forceinline__ static void load(const float* p, float (&f)[n]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&f)[n]) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float (&f)[n]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < n / 2; ++k) {
      const float2 t = __bfloat1622float2(b[k]);
      f[2 * k] = t.x;
      f[2 * k + 1] = t.y;
    }
  }
  // round to nearest even, as the cast to bf16 rounds
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float (&f)[n]) {
    uint4 v;
    __nv_bfloat162* b = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int k = 0; k < n / 2; ++k) b[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
    *reinterpret_cast<uint4*>(p) = v;
  }
};

template <typename T, bool kAdd>
__global__ void __launch_bounds__(kMaxThreads) add_rms_norm_kernel(const Args a) {
  constexpr int P = Pack<T>::n;
  __shared__ float warp_sums[kMaxThreads / 32];
  const long long row = static_cast<long long>(blockIdx.x) * a.D;
  const int nvec = a.D / P;
  const T* x = static_cast<const T*>(a.x) + row;
  float v[kVecs][P], w[kVecs][P];
  // every load before any use: the row's vectors, delta's and w's in flight at once
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c >= nvec) continue;
    Pack<T>::load(x + c * P, v[i]);
#pragma unroll
    for (int j = 0; j < P; j += 4) {
      const float4 q = *reinterpret_cast<const float4*>(a.w + c * P + j);
      w[i][j] = q.x;
      w[i][j + 1] = q.y;
      w[i][j + 2] = q.z;
      w[i][j + 3] = q.w;
    }
    if (kAdd) {
      float d[P];
      Pack<T>::load(static_cast<const T*>(a.delta) + row + c * P, d);
#pragma unroll
      for (int j = 0; j < P; ++j) v[i][j] = round_to<T>(__fadd_rn(v[i][j], d[j]));
      Pack<T>::store(static_cast<T*>(a.h) + row + c * P, v[i]);
    }
  }
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    if (static_cast<int>(threadIdx.x + i * blockDim.x) >= nvec) continue;
#pragma unroll
    for (int j = 0; j < P; ++j) part = __fadd_rn(part, __fmul_rn(v[i][j], v[i][j]));
  }
  part = fastkv::warp_sum(part);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = part;
  __syncthreads();
  float sum = 0.f;
  for (int k = 0; k < static_cast<int>(blockDim.x >> 5); ++k)
    sum = __fadd_rn(sum, warp_sums[k]);
  // torch.mean's sum times 1 / D, then rsqrt(var + eps), as llama.rms_norm
  const float var = __fmul_rn(sum, __fdiv_rn(1.f, static_cast<float>(a.D)));
  const float inv = rsqrtf(__fadd_rn(var, a.eps));
  T* out = static_cast<T*>(a.out) + row;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c >= nvec) continue;
    float o[P];
#pragma unroll
    for (int j = 0; j < P; ++j) o[j] = __fmul_rn(__fmul_rn(v[i][j], inv), w[i][j]);
    Pack<T>::store(out + c * P, o);
  }
}

template <typename T>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int P = Pack<T>::n;
  if (a.D % P != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int nvec = a.D / P;
  const int threads = ((nvec + kVecs - 1) / kVecs + 31) / 32 * 32;
  if (threads > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  if (a.delta)
    add_rms_norm_kernel<T, true><<<B, threads, 0, stream>>>(a);
  else
    add_rms_norm_kernel<T, false><<<B, threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int add_rms_norm(int dtype, const void* x, const void* delta, const void* w, void* h,
                            void* out, int B, int D, float eps, void* stream) {
  if (B < 1 || D < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x, delta, static_cast<const float*>(w), h, out, D, eps};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == fastkv::kBFloat16) return launch<__nv_bfloat16>(a, B, s);
  if (dtype == fastkv::kFloat32) return launch<float>(a, B, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
