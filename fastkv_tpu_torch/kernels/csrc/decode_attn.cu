// decode_attn: single-token attention over the compressed KV cache, for Hopper.
//
// Replaces the TPU kernel fastkv_tpu/ops/experimental/decode_attn.py::
// decode_attention (Pallas _kernel :74-137, pallas_call :231), with its
// sliding-window term (:110-112), and the int8 cache that the JAX package's
// XLA path folds its scales into (fastkv_tpu/ops/attention.py:312-317), which
// the Pallas kernel does not take.
//
// For each batch b and cache head ch, the g = H / CH query heads of that cache
// head attend over the C cache slots that `valid` marks:
//   O[h] = sum_c softmax_c(q_h . k_c * scale, masked by valid[c]) v_c
// The cache layout is scattered (kept prefix, then decode slots), so validity
// comes from the explicit mask, never from a count. A row with no visible slot
// writes 0. Under a window W (a runtime int, 0 = none) slot c is also visible
// only if kpos[c] > qpos - W (kpos: the cache's original positions, qpos: the
// decode token's). An int8 cache (K/V int8 [B, CH, C, D], float32 scales
// [B, CH, C] per slot) reads one byte an element and no dequantized copy:
//   logit_c = (q . k_c) * scale * k_scale[c]
//   P.V     = sum_c round(p_c * v_scale[c]) * v_c
// with p rounded to q's type after the V scale, as the XLA path casts p.
//
// Bound on the H100: bytes. Each valid K and V row is read once; at
// Llama-3.1-8B width the FastKV cache is ~4 MB of K+V per layer (~1.3 us at
// 3.35 TB/s) and the FullKV cache at 8K context ~34 MB (~10 us), so at batch 1
// launch overhead sets the pace of the compressed cache. int8 halves the K/V
// bytes and adds 8 bytes of scales a slot.
//
// Design: the cache axis is split across blocks (pass 1), because at batch 1
// there are only 8 (batch, cache head) pairs for 132 SMs. Each block takes one
// chunk of slots for one cache head and up to 8 of its query heads, which share
// every K/V row it loads (K and V are read once per cache head). A warp scores
// one slot at a time (lane-strided loads along d, warp-sum reduction) and skips
// invalid slots without loading them; the block then takes the chunk's row max
// and sum and accumulates P.V with one thread per output column. Pass 1 writes
// per-chunk (m, l, acc) in float32; pass 2 merges the chunks per query head.
// A ragged C is masked in the kernel: no padded copy of the cache. The window
// and the int8 cache are template parameters chosen at launch, so the bf16
// instantiation without a window keeps its code.
#include <type_traits>

#include "common.cuh"

namespace {

using fastkv::from_float;
using fastkv::round_to;
using fastkv::to_float;
using fastkv::warp_max;
using fastkv::warp_sum;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;     // query heads per block; a larger group is split
constexpr int kMaxChunk = 2048; // slots per block, bounds the score buffer

// P.V runs one thread per output column; kThreads / D such groups split the slots
template <int D>
size_t split_smem_bytes(int chunk) {
  return sizeof(float) * (kMaxRows * D + kMaxRows * chunk + (kThreads / D) * kMaxRows * D);
}

template <typename T, typename KV, int D, bool kWindow>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(
    const T* __restrict__ q, const KV* __restrict__ kc, const KV* __restrict__ vc,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const unsigned char* __restrict__ valid, const int* __restrict__ qpos,
    const int* __restrict__ kpos, float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc, int CH, int group, int C, int chunk, int window,
    long long k_sb, long long k_sh, long long k_sc, long long v_sb, long long v_sh,
    long long v_sc, long long m_sb, long long m_sh, long long ks_sb, long long ks_sh,
    long long vs_sb, long long vs_sh, long long p_sb, long long p_sh, float scale) {
  constexpr bool kInt8 = !std::is_same<T, KV>::value;
  constexpr int kPer = D / 32;        // elements of a K row per lane
  constexpr int kHalves = kThreads / D;
  extern __shared__ float smem[];
  float* sQ = smem;                      // [kMaxRows, D]
  float* sS = sQ + kMaxRows * D;         // [kMaxRows, chunk] scores, then P
  float* sRed = sS + kMaxRows * chunk;   // [kHalves, kMaxRows, D]

  const int n_rg = (group + kMaxRows - 1) / kMaxRows;
  const int ch = blockIdx.y / n_rg;
  const int j0 = (blockIdx.y % n_rg) * kMaxRows;
  const int nrows = min(kMaxRows, group - j0);
  const int b = blockIdx.z;
  const int c0 = blockIdx.x * chunk;
  const int n = min(chunk, C - c0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long H = static_cast<long long>(CH) * group;

  const T* qb = q + (b * H + static_cast<long long>(ch) * group + j0) * D;
  const KV* kb = kc + b * k_sb + ch * k_sh;
  const KV* vb = vc + b * v_sb + ch * v_sh;
  const unsigned char* ok = valid + b * m_sb + ch * m_sh;
  const float* ksb = kInt8 ? k_scale + b * ks_sb + ch * ks_sh : nullptr;
  const float* vsb = kInt8 ? v_scale + b * vs_sb + ch * vs_sh : nullptr;
  const int* kp = kWindow ? kpos + b * p_sb + ch * p_sh : nullptr;
  // under the window, slots at or below lo are out of it (qpos >= 0 and
  // window >= 1, so no overflow)
  const int lo = kWindow ? qpos[b] - window : 0;

  for (int i = tid; i < nrows * D; i += kThreads) sQ[i] = to_float(qb[i]);
  __syncthreads();

  // scores: one warp per slot
  for (int i = warp; i < n; i += kWarps) {
    const long long c = c0 + i;
    bool seen = ok[c];
    if constexpr (kWindow) seen = seen && kp[c] > lo;
    if (!seen) {
      if (lane < nrows) sS[lane * chunk + i] = -INFINITY;
      continue;
    }
    float kv[kPer];
#pragma unroll
    for (int t = 0; t < kPer; ++t) kv[t] = to_float(kb[c * k_sc + t * 32 + lane]);
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j) {
      if (j < nrows) {
        float dot = 0.f;
#pragma unroll
        for (int t = 0; t < kPer; ++t) dot = fmaf(sQ[j * D + t * 32 + lane], kv[t], dot);
        dot = warp_sum(dot);
        if (lane == 0) sS[j * chunk + i] = kInt8 ? dot * scale * ksb[c] : dot * scale;
      }
    }
  }
  __syncthreads();

  // chunk-local softmax statistics: one warp per query row; l sums the
  // unscaled p, P holds p (times V's scale for an int8 cache) in T
  const long long part0 = ((static_cast<long long>(b) * CH + ch) * gridDim.x + blockIdx.x) * group + j0;
  for (int j = warp; j < nrows; j += kWarps) {
    float* row = sS + j * chunk;
    float mx = -INFINITY;
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, row[i]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float p = mx == -INFINITY ? 0.f : expf(row[i] - mx);
      sum += p;
      row[i] = round_to<T>(kInt8 ? p * vsb[c0 + i] : p);
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      part_m[part0 + j] = mx;
      part_l[part0 + j] = sum;
    }
  }
  __syncthreads();

  // P.V: one thread per output column, kHalves groups split the slots
  const int e = tid % D;
  const int half = tid / D;
  float acc[kMaxRows];
#pragma unroll
  for (int j = 0; j < kMaxRows; ++j) acc[j] = 0.f;
  for (int i = half; i < n; i += kHalves) {
    const long long c = c0 + i;
    if (!ok[c]) continue;  // P is 0 there: skip the load
    const float vv = to_float(vb[c * v_sc + e]);
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j)
      if (j < nrows) acc[j] = fmaf(sS[j * chunk + i], vv, acc[j]);
  }
  if (kHalves > 1) {
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j)
      if (j < nrows) sRed[(half * kMaxRows + j) * D + e] = acc[j];
    __syncthreads();
    if (half == 0) {
      for (int hh = 1; hh < kHalves; ++hh)
#pragma unroll
        for (int j = 0; j < kMaxRows; ++j)
          if (j < nrows) acc[j] += sRed[(hh * kMaxRows + j) * D + e];
    }
  }
  if (half == 0) {
#pragma unroll
    for (int j = 0; j < kMaxRows; ++j)
      if (j < nrows) part_acc[(part0 + j) * D + e] = acc[j];
  }
}

// Merge the per-chunk partials of one query head: one block per (head, batch),
// one thread per output column.
template <typename T>
__global__ void decode_merge_kernel(const float* __restrict__ part_m,
                                    const float* __restrict__ part_l,
                                    const float* __restrict__ part_acc, T* __restrict__ out,
                                    int CH, int group, int nchunks, int D) {
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int ch = h / group;
  const int j = h % group;
  const int e = threadIdx.x;
  const long long base = (static_cast<long long>(b) * CH + ch) * nchunks;
  float M = -INFINITY;
  for (int c = 0; c < nchunks; ++c) M = fmaxf(M, part_m[(base + c) * group + j]);
  float L = 0.f, acc = 0.f;
  if (M != -INFINITY) {
    for (int c = 0; c < nchunks; ++c) {
      const long long p = (base + c) * group + j;
      const float mc = part_m[p];
      if (mc == -INFINITY) continue;
      const float w = expf(mc - M);
      L += w * part_l[p];
      acc += w * part_acc[p * D + e];
    }
  }
  const long long H = static_cast<long long>(CH) * group;
  out[(b * H + h) * D + e] = from_float<T>(L > 0.f ? acc / L : 0.f);
}

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale, *valid, *qpos, *kpos;
  void *part_m, *part_l, *part_acc, *out;
  int B, CH, group, C, chunk, nchunks, window;
  long long k_sb, k_sh, k_sc, v_sb, v_sh, v_sc, m_sb, m_sh, ks_sb, ks_sh, vs_sb, vs_sh, p_sb,
      p_sh;
  float scale;
  cudaStream_t stream;
};

template <typename T, typename KV, int D, bool kWindow>
cudaError_t launch(const Args& a) {
  if (a.chunk < 1 || a.chunk > kMaxChunk || static_cast<long long>(a.chunk) * a.nchunks < a.C)
    return cudaErrorInvalidValue;
  auto kernel = decode_split_kernel<T, KV, D, kWindow>;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           split_smem_bytes<D>(kMaxChunk));
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int n_rg = (a.group + kMaxRows - 1) / kMaxRows;
  const dim3 grid(a.nchunks, a.CH * n_rg, a.B);
  kernel<<<grid, kThreads, split_smem_bytes<D>(a.chunk), a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const KV*>(a.k), static_cast<const KV*>(a.v),
      static_cast<const float*>(a.k_scale), static_cast<const float*>(a.v_scale),
      static_cast<const unsigned char*>(a.valid), static_cast<const int*>(a.qpos),
      static_cast<const int*>(a.kpos), static_cast<float*>(a.part_m),
      static_cast<float*>(a.part_l), static_cast<float*>(a.part_acc), a.CH, a.group, a.C,
      a.chunk, a.window, a.k_sb, a.k_sh, a.k_sc, a.v_sb, a.v_sh, a.v_sc, a.m_sb, a.m_sh,
      a.ks_sb, a.ks_sh, a.vs_sb, a.vs_sh, a.p_sb, a.p_sh, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 mgrid(a.CH * a.group, a.B);
  decode_merge_kernel<T><<<mgrid, D, 0, a.stream>>>(
      static_cast<const float*>(a.part_m), static_cast<const float*>(a.part_l),
      static_cast<const float*>(a.part_acc), static_cast<T*>(a.out), a.CH, a.group, a.nchunks,
      D);
  return cudaGetLastError();
}

template <typename T, typename KV, int D>
cudaError_t launch_any(const Args& a) {
  return a.window > 0 ? launch<T, KV, D, true>(a) : launch<T, KV, D, false>(a);
}

}  // namespace

// q [B, H, 1, D] contiguous; k/v cache [B, CH, C, D] in q's type, or int8 with
// kv_int8 = 1, with unit stride along D (other strides in elements); k_scale /
// v_scale [B, CH, C] float32 with unit stride along C (int8 only, else null);
// valid [B, CH or 1, C] bytes with unit stride along C (m_sh = 0 broadcasts
// one mask over the cache heads); window: W >= 1, or 0 for none, when qpos
// [B] int32 and kpos [B, CH or 1, C] int32 (unit stride along C) are read;
// part_m/part_l [B, CH, nchunks, group] and part_acc [B, CH, nchunks, group,
// D] float32 scratch; out [B, H, 1, D] contiguous.
extern "C" int decode_attn(int dtype, int kv_int8, int head_dim, const void* q, const void* k,
                           const void* v, const void* k_scale, const void* v_scale,
                           const void* valid, const void* qpos, const void* kpos,
                           void* part_m, void* part_l, void* part_acc, void* out, int B,
                           int CH, int group, int C, int chunk, int nchunks, int window,
                           long long k_sb, long long k_sh, long long k_sc, long long v_sb,
                           long long v_sh, long long v_sc, long long m_sb, long long m_sh,
                           long long ks_sb, long long ks_sh, long long vs_sb, long long vs_sh,
                           long long p_sb, long long p_sh, float scale, void* stream) {
  if (window < 0 || (kv_int8 && (k_scale == nullptr || v_scale == nullptr)) ||
      (window > 0 && (qpos == nullptr || kpos == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,     k,     v,     k_scale, v_scale, valid, qpos,  kpos,  part_m, part_l,
               part_acc, out, B,   CH,      group,   C,     chunk, nchunks, window, k_sb,
               k_sh,  k_sc,  v_sb,  v_sh,    v_sc,    m_sb,  m_sh,  ks_sb, ks_sh, vs_sb,
               vs_sh, p_sb,  p_sh,  scale,   static_cast<cudaStream_t>(stream)};
#define FASTKV_LAUNCH(T, D)                                                      \
  return static_cast<int>(kv_int8 ? launch_any<T, int8_t, D>(a) : launch_any<T, T, D>(a))
  if (dtype == fastkv::kBFloat16 && head_dim == 128) FASTKV_LAUNCH(__nv_bfloat16, 128);
  if (dtype == fastkv::kBFloat16 && head_dim == 64) FASTKV_LAUNCH(__nv_bfloat16, 64);
  if (dtype == fastkv::kFloat32 && head_dim == 128) FASTKV_LAUNCH(float, 128);
  if (dtype == fastkv::kFloat32 && head_dim == 64) FASTKV_LAUNCH(float, 64);
#undef FASTKV_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
