// decode_prologue: a decode layer's attention prologue, for Hopper.
//
// Replaces no TPU kernel. The JAX package leaves this step to XLA, which fuses
// it; in the port it was ~25 (Llama, Mistral) to ~37 (DeepSeek-V2) small
// PyTorch launches a layer between the q/k/v projections and the attention
// call, each reading a few KB, so a decode step paid ~1000 launches for it.
// This is the whole of that step in one launch a layer.
//
// Two forms, one launch each; both compute cos/sin themselves from the row's
// position (pos [B] int32) and inv_freq, so nothing comes from the host and
// the launch is captured into the step's CUDA graph. The new cache row goes
// to the row's slot (one int for every row, or slots [B] int64).
//  * rope_append (Llama, Mistral: rotate-half). CTA (x, b): x < H turns query
//    head x of row b in place; x >= H takes kv head x - H, turns k and writes
//    it and v into the cache, repeated into the g = CH / KH consecutive cache
//    heads of its kv head (a per-query-head cache, as SnapKV's methods keep,
//    has g > 1).
//  * latent_prologue (DeepSeek-V2, HF's pair layout: each interleaved pair
//    regrouped, evens then odds, before rotate-half). CTA (x, b): x < H turns
//    the rope part (the last r of each n + r) of query head x in place;
//    x == H RMS-normalises the latent kv_a[:R] with kv_norm into the k plane
//    and turns the shared rope key kv_a[R:] into the v plane; the MLA cache
//    has the one head. cos/sin are scaled by YaRN's mscale ratio (1.0 for
//    DeepSeek-V2-Lite).
//
// The arithmetic is PyTorch's composition, rounded where it rounds: the angle
// is float32 pos * inv_freq, cosf/sinf are the accurate functions (angles
// reach ~3e4 rad: no fast intrinsics), each product and sum is rounded on its
// own (__fmul_rn / __fadd_rn / __fsub_rn: no FMA contraction), and the result
// is cast to the storage type once. So the RoPE and the appends are bit for
// bit the plain version's (ops/decode_prologue.py). The latent's norm sums
// its squares in another order than PyTorch's reduction: within a bf16 ulp.
//
// Bound on the H100: one launch. At Mistral-Nemo-12B width (b = 1) a call
// moves ~24 KB (q read and written, k and v read, two cache rows written:
// ~7 ns at 3.35 TB/s); DeepSeek-V2-Lite's ~7 KB. So one CTA a (row, head),
// 128 threads, no tiling: the grid is H + KH (or H + 1) CTAs a row, and each
// thread takes a pair or a few elements.
#include "common.cuh"

namespace {

using fastkv::from_float;
using fastkv::to_float;

constexpr int kThreads = 128;
constexpr int kMaxRope = 256;  // rope width a CTA holds in shared memory (latent form)

struct Args {
  void* q;          // [B, H, ...] rows: q_sb, q_sh; the rope part from q_off, rope wide
  const void* k;    // rope_append: [B, KH, d] (k_sb, k_sh); latent: kv_a [B, R + rope] (k_sb)
  const void* v;    // rope_append: [B, KH, d] (v_sb, v_sh)
  const float* norm_w;  // latent: kv_norm [R]
  const int* pos;       // [B]
  const long long* slots;  // [B], or null: slot0 for every row
  long long slot0;
  const float* inv_freq;  // [rope / 2]
  void* k_cache;          // [B, CH, C, .] (latent: CH = 1)
  void* v_cache;
  int B, H, KH, CH, C, q_off, rope, R;
  long long q_sb, q_sh, k_sb, k_sh, v_sb, v_sh;
  long long kc_sb, kc_sh, kc_sc, vc_sb, vc_sh, vc_sc;
  float eps, mscale;
  cudaStream_t stream;
};

// cos and sin of row b's angle at frequency j, times the mscale ratio, each
// rounded as rope_cos_sin (and DeepSeek-V2's cos_sin) round them
__device__ __forceinline__ void cos_sin(const Args& a, float p, int j, float& c, float& s) {
  const float ang = __fmul_rn(p, a.inv_freq[j]);
  c = __fmul_rn(cosf(ang), a.mscale);
  s = __fmul_rn(sinf(ang), a.mscale);
}

// apply_rope's two halves: x1 c - x2 s and x2 c + x1 s
__device__ __forceinline__ float rot_lo(float x1, float x2, float c, float s) {
  return __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
}
__device__ __forceinline__ float rot_hi(float x1, float x2, float c, float s) {
  return __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s));
}

// Row b's slot; a slot outside the cache traps, as the indexed write it
// replaces does (device-side assert).
__device__ __forceinline__ long long slot_of(const Args& a, int b) {
  const long long slot = a.slots ? a.slots[b] : a.slot0;
  if (slot < 0 || slot >= a.C) __trap();
  return slot;
}

// Element i of the cache row at (b, head, slot) of a plane.
template <typename T>
__device__ __forceinline__ T* cache_row(void* plane, long long sb, long long sh, long long sc,
                                        int b, int head, long long slot) {
  return static_cast<T*>(plane) + b * sb + head * sh + slot * sc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) rope_append_kernel(const Args a) {
  const int b = blockIdx.y, x = blockIdx.x, d2 = a.rope / 2;
  const float p = static_cast<float>(a.pos[b]);
  if (x < a.H) {
    T* q = static_cast<T*>(a.q) + b * a.q_sb + x * a.q_sh;
    for (int j = threadIdx.x; j < d2; j += blockDim.x) {
      float c, s;
      cos_sin(a, p, j, c, s);
      const float x1 = to_float(q[j]), x2 = to_float(q[j + d2]);
      q[j] = from_float<T>(rot_lo(x1, x2, c, s));
      q[j + d2] = from_float<T>(rot_hi(x1, x2, c, s));
    }
    return;
  }
  const int kh = x - a.H, g = a.CH / a.KH;
  const long long slot = slot_of(a, b);
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kh * a.v_sh;
  for (int j = threadIdx.x; j < d2; j += blockDim.x) {
    float c, s;
    cos_sin(a, p, j, c, s);
    const float x1 = to_float(k[j]), x2 = to_float(k[j + d2]);
    const T lo = from_float<T>(rot_lo(x1, x2, c, s)), hi = from_float<T>(rot_hi(x1, x2, c, s));
    const T vlo = v[j], vhi = v[j + d2];
    for (int r = 0; r < g; ++r) {
      T* kc = cache_row<T>(a.k_cache, a.kc_sb, a.kc_sh, a.kc_sc, b, kh * g + r, slot);
      T* vc = cache_row<T>(a.v_cache, a.vc_sb, a.vc_sh, a.vc_sc, b, kh * g + r, slot);
      kc[j] = lo;
      kc[j + d2] = hi;
      vc[j] = vlo;
      vc[j + d2] = vhi;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) latent_prologue_kernel(const Args a) {
  __shared__ float turned[kMaxRope];
  __shared__ float warp_sums[kThreads / 32];
  const int b = blockIdx.y, x = blockIdx.x, r2 = a.rope / 2;
  const float p = static_cast<float>(a.pos[b]);
  if (x < a.H) {
    // in place: every pair is read before any is written back
    T* q = static_cast<T*>(a.q) + b * a.q_sb + x * a.q_sh + a.q_off;
    for (int j = threadIdx.x; j < r2; j += blockDim.x) {
      float c, s;
      cos_sin(a, p, j, c, s);
      const float x1 = to_float(q[2 * j]), x2 = to_float(q[2 * j + 1]);
      turned[j] = rot_lo(x1, x2, c, s);
      turned[j + r2] = rot_hi(x1, x2, c, s);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < a.rope; i += blockDim.x) q[i] = from_float<T>(turned[i]);
    return;
  }
  const long long slot = slot_of(a, b);
  const T* kv = static_cast<const T*>(a.k) + b * a.k_sb;
  float part = 0.f;
  for (int i = threadIdx.x; i < a.R; i += blockDim.x) {
    const float f = to_float(kv[i]);
    part = __fadd_rn(part, __fmul_rn(f, f));
  }
  part = fastkv::warp_sum(part);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = part;
  __syncthreads();
  float sum = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) sum = __fadd_rn(sum, warp_sums[w]);
  // torch.mean's sum times 1 / R, then rsqrt(var + eps), as llama.rms_norm
  const float var = __fmul_rn(sum, __fdiv_rn(1.f, static_cast<float>(a.R)));
  const float inv = rsqrtf(__fadd_rn(var, a.eps));
  T* kc = cache_row<T>(a.k_cache, a.kc_sb, 0, a.kc_sc, b, 0, slot);
  for (int i = threadIdx.x; i < a.R; i += blockDim.x)
    kc[i] = from_float<T>(__fmul_rn(__fmul_rn(to_float(kv[i]), inv), a.norm_w[i]));
  const T* pe = kv + a.R;
  T* vc = cache_row<T>(a.v_cache, a.vc_sb, 0, a.vc_sc, b, 0, slot);
  for (int j = threadIdx.x; j < r2; j += blockDim.x) {
    float c, s;
    cos_sin(a, p, j, c, s);
    const float x1 = to_float(pe[2 * j]), x2 = to_float(pe[2 * j + 1]);
    vc[j] = from_float<T>(rot_lo(x1, x2, c, s));
    vc[j + r2] = from_float<T>(rot_hi(x1, x2, c, s));
  }
}

bool bad_dtype(int dtype) { return dtype != fastkv::kBFloat16 && dtype != fastkv::kFloat32; }

}  // namespace

extern "C" int rope_append(int dtype, void* q, const void* k, const void* v, const void* pos,
                           const void* slots, long long slot0, const void* inv_freq,
                           void* k_cache, void* v_cache, int B, int H, int KH, int CH, int C,
                           int d, long long q_sb, long long q_sh, long long k_sb, long long k_sh,
                           long long v_sb, long long v_sh, long long kc_sb, long long kc_sh,
                           long long kc_sc, long long vc_sb, long long vc_sh, long long vc_sc,
                           void* stream) {
  if (bad_dtype(dtype) || KH < 1 || CH % KH != 0 || d % 2 != 0 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,     k,     v,     nullptr, static_cast<const int*>(pos),
               static_cast<const long long*>(slots), slot0,
               static_cast<const float*>(inv_freq), k_cache, v_cache,
               B,     H,     KH,    CH,      C,     0,     d,     0,
               q_sb,  q_sh,  k_sb,  k_sh,    v_sb,  v_sh,
               kc_sb, kc_sh, kc_sc, vc_sb,   vc_sh, vc_sc, 0.f,   1.f,
               static_cast<cudaStream_t>(stream)};
  const dim3 grid(H + KH, B);
  if (dtype == fastkv::kBFloat16)
    rope_append_kernel<__nv_bfloat16><<<grid, kThreads, 0, a.stream>>>(a);
  else
    rope_append_kernel<float><<<grid, kThreads, 0, a.stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int latent_prologue(int dtype, void* q, const void* kv_a, const void* kv_norm,
                               const void* pos, const void* slots, long long slot0,
                               const void* inv_freq, void* k_cache, void* v_cache, int B, int H,
                               int C, int nope, int rope, int R, long long q_sb, long long q_sh,
                               long long kv_sb, long long kc_sb, long long kc_sc,
                               long long vc_sb, long long vc_sc, float eps, float mscale,
                               void* stream) {
  if (bad_dtype(dtype) || rope % 2 != 0 || rope > kMaxRope || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,     kv_a,  nullptr, static_cast<const float*>(kv_norm),
               static_cast<const int*>(pos), static_cast<const long long*>(slots), slot0,
               static_cast<const float*>(inv_freq), k_cache, v_cache,
               B,     H,     1,       1,     C,     nope,  rope,  R,
               q_sb,  q_sh,  kv_sb,   0,     0,     0,
               kc_sb, 0,     kc_sc,   vc_sb, 0,     vc_sc, eps,   mscale,
               static_cast<cudaStream_t>(stream)};
  const dim3 grid(H + 1, B);
  if (dtype == fastkv::kBFloat16)
    latent_prologue_kernel<__nv_bfloat16><<<grid, kThreads, 0, a.stream>>>(a);
  else
    latent_prologue_kernel<float><<<grid, kThreads, 0, a.stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
