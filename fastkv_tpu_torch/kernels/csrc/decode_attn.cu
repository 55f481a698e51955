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
// Bound on the H100: bytes. Each visible K and V row is read once and there
// are 4 * g * D FLOPs a slot. At Llama-3.1-8B width the FastKV cache is ~4 MB
// of K+V a layer (~1.3 us at 3.35 TB/s), the FullKV cache at 8K context ~34 MB
// (~10 us), Ministral-8B's rank-cut 41K-slot cache ~136 MB of which 32K slots
// a head are visible (~40 us). Keeping the card busy takes ~25 KB in flight
// per SM.
//
// bf16 q (a bf16 or int8 cache): decode_attn_tc_kernel, one launch a call.
//  * Split plan (ops/decode_attn.py split_plan): a CTA takes one (batch,
//    cache head, group of up to 16 query heads) and a run of `tiles` 64-slot
//    tiles; the runs are sized so that the grid is one wave of one CTA an
//    SM (two fit; one with twice the tiles merges fewer splits).
//  * Visibility first: the CTA reads its run's `valid` bytes (and kpos under
//    the window) into shared memory, then every warp takes the bitmask of
//    tiles with a visible slot by ballots. Tiles with none are never read
//    (the rank cut hides Ministral's first ~8K of 41K slots); inside a tile
//    an invisible slot's 16-byte copies are zero-filled instead of read.
//  * K/V tiles go through a 3-stage ring in shared memory by 16-byte
//    cp.async (two stages in flight while one is consumed: 64 KB at D = 128
//    bf16, two CTAs an SM). Rows are stored with a 16-byte XOR swizzle, so
//    the ldmatrix reads below are free of bank conflicts.
//  * Tensor cores, mma.sync m16n8k16 bf16 -> f32: the query heads are the M
//    rows (padded to 16; the padding costs FLOPs, which are ~0.1% of the
//    bound, not bytes, so g = 1 reads what g = 8 reads), the slots N. Each of
//    the 4 warps takes 16 slots of a tile: S = Q.K^T from Q fragments held in
//    registers and K by ldmatrix; the online softmax (exp2, m and l per row
//    in registers, quad shuffles only); O += P.V with P packed to bf16 from
//    the S accumulators (no shared-memory round trip) and V by
//    ldmatrix.trans. No score buffer, no per-slot reductions.
//  * int8: the tile lands as bytes (half the bytes of bf16) with its two
//    scale rows, and both K and V go from their bytes straight into the
//    MMA's B registers, widened exactly by two logic ops and one bf16x2
//    subtraction a pair (bf16x2_of_bytes): K by one 16-byte read a row for
//    four k-steps (the d order permuted alike in Q's fragments), V by one
//    4-byte read of each of four slot rows for four n-tiles (the output's d
//    order permuted, and put back in the merge). k_scale multiplies logit
//    columns, v_scale p before it is rounded.
//  * Merge in the same launch: the 4 warps' (m, l, acc) (their real rows)
//    are merged through shared memory; with one split the CTA writes the
//    output, else it writes its partial (m, l, acc) in float32 and takes a
//    ticket from a per-(b, ch, row group) arrival counter (after
//    __threadfence); the last CTA to arrive merges every split and resets
//    the counter to 0 for the next call.
//
// float32 q: the CUDA-core kernel pair (decode_split_kernel, then
// decode_merge_kernel), which the float32 checks at 1e-3 need.
#include <type_traits>

#include "common.cuh"

namespace {

using fastkv::from_float;
using fastkv::round_to;
using fastkv::to_float;
using fastkv::warp_max;
using fastkv::warp_sum;

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel pair
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// bf16 q: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kTile = 64;       // slots a tile
constexpr int kStages = 3;      // K/V ring depth
constexpr int kTcThreads = 128; // 4 warps, 16 slots of each tile a warp
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kTcRows = 16;     // query heads a CTA (the MMA's M)
constexpr int kMaxTiles = 32;   // tiles a split (its visibility bitmask is one word)
constexpr int kMaxSplits = 256; // splits a (b, ch, row group)
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared; src_bytes < 16 zero-fills the rest (0: none read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// D[16 x 8] += A[16 x 16] (row) * B[16 x 8] (col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two signed bytes, one in the low 8 bits of each 16-bit half of t, as two
// bf16, exactly and without int-to-float conversions: 0x4300 | (x & 127) is
// the bf16 128 + (x & 127), and x's sign bit in the mantissa's top bit turns
// the bf16 128 (0x4300) into 256 (0x4380); their difference is x
__device__ __forceinline__ uint32_t bf16x2_of_bytes(uint32_t t) {
  uint32_t a = (t & 0x007f007fu) | 0x43004300u;
  uint32_t s = (t & 0x00800080u) | 0x43004300u;
  __nv_bfloat162 d = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&s));
  return *reinterpret_cast<uint32_t*>(&d);
}

// Shared-memory layout of one CTA (bytes). The merge at the end reuses the
// ring. A bf16 row of D values is D / 8 16-byte units; unit u of row r lies
// at unit u ^ (r % 8) (swz), so the 8 rows an ldmatrix phase reads fall in 8
// different bank groups.
template <typename KV, int D>
struct TcLayout {
  static constexpr bool kInt8 = std::is_same<KV, int8_t>::value;
  static constexpr int kRowBytes = D * 2;                                 // a bf16 row
  static constexpr int kRawTile = kTile * D * static_cast<int>(sizeof(KV));  // as stored
  static constexpr int kStageBytes = 2 * kRawTile + (kInt8 ? 2 * kTile * 4 : 0);  // + scales
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kMerge = kTcWarps * kTcRows * (D + 2) * 4 +
                                kTcRows * (kMaxSplits + 1) * 4 + kTcThreads * 16;
  static constexpr int kWork = kRing > kMerge ? kRing : kMerge;
  static constexpr int kQ = kWork;                       // Q [16][D] bf16, swizzled
  static constexpr int kVis = kQ + kTcRows * kRowBytes;  // one byte a slot of the run
  static constexpr int kBytes = kVis + kMaxTiles * kTile;
};

// four output values, times 1 / the row's sum, as bf16
__device__ __forceinline__ void store_row4(__nv_bfloat16* dst, float4 a, float inv) {
  dst[0] = __float2bfloat16(a.x * inv);
  dst[1] = __float2bfloat16(a.y * inv);
  dst[2] = __float2bfloat16(a.z * inv);
  dst[3] = __float2bfloat16(a.w * inv);
}

template <int D>
__device__ __forceinline__ uint32_t swz(int r, int u) {
  return r * (D * 2) + ((u ^ (r & 7)) << 4);
}

// int8 V: 16-byte unit u of row r lies at unit u ^ vswz(r), so that at D =
// 128 the 4-byte reads of P.V's B fragments (rows 2 t4 + {0, 1, 8, 9} of a
// warp's 16, bytes 32 j + 4 g) fall in 32 different banks
template <int D>
__device__ __forceinline__ int vswz(int r) {
  return (2 * ((r >> 1) & 3)) & (D / 16 - 1);
}

template <typename KV, int D, bool kWindow>
__global__ void __launch_bounds__(kTcThreads, 2) decode_attn_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const KV* __restrict__ kc, const KV* __restrict__ vc,
    const float* __restrict__ k_scale, const float* __restrict__ v_scale,
    const unsigned char* __restrict__ valid, const int* __restrict__ qpos,
    const int* __restrict__ kpos, float* __restrict__ part, int* __restrict__ counters,
    __nv_bfloat16* __restrict__ out, int CH, int group, int C, int tiles, int window,
    long long k_sb, long long k_sh, long long k_sc, long long v_sb, long long v_sh,
    long long v_sc, long long m_sb, long long m_sh, long long ks_sb, long long ks_sh,
    long long vs_sb, long long vs_sh, long long p_sb, long long p_sh, float scale_log2) {
  using L = TcLayout<KV, D>;
  constexpr bool kInt8 = L::kInt8;
  constexpr int kRawUnits = D * static_cast<int>(sizeof(KV)) / 16;  // 16-byte units a stored row
  constexpr int kVisIters = kMaxTiles * kTile / kTcThreads;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  unsigned char* smem = tc_smem;
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wslot = warp * 16;  // the warp's 16 slots of each tile
  const int g = lane >> 2;  // the fragment row (and row + 8)
  const int t4 = lane & 3;  // the fragment column pair
  const int n_rg = (group + kTcRows - 1) / kTcRows;
  const int ch = blockIdx.y / n_rg;
  const int j0 = (blockIdx.y % n_rg) * kTcRows;
  const int nrows = min(kTcRows, group - j0);
  const int b = blockIdx.z;
  const int split = blockIdx.x;
  const int nsplit = gridDim.x;
  const long long unit = static_cast<long long>(b) * gridDim.y + blockIdx.y;
  const int c_begin = split * tiles * kTile;
  const int n_slots = min(tiles * kTile, C - c_begin);
  const long long H = static_cast<long long>(CH) * group;

  const KV* kb = kc + b * k_sb + ch * k_sh;
  const KV* vb = vc + b * v_sb + ch * v_sh;
  const unsigned char* ok = valid + b * m_sb + ch * m_sh + c_begin;
  const float* ksb = kInt8 ? k_scale + b * ks_sb + ch * ks_sh : nullptr;
  const float* vsb = kInt8 ? v_scale + b * vs_sb + ch * vs_sh : nullptr;
  const int* kp = kWindow ? kpos + b * p_sb + ch * p_sh + c_begin : nullptr;
  const int lo = kWindow ? qpos[b] - window : 0;  // slots at or below lo are out of the window
  unsigned char* vis = smem + L::kVis;
  unsigned char* sQ = smem + L::kQ;

  // 1. the query rows (rows past the group are 0) and the run's visibility,
  //    all loads issued before any is used
  {
    const __nv_bfloat16* qb = q + (b * H + static_cast<long long>(ch) * group + j0) * D;
    __nv_bfloat16 qv[kTcRows * D / kTcThreads];
#pragma unroll
    for (int it = 0; it < kTcRows * D / kTcThreads; ++it) {
      const int i = tid + it * kTcThreads;
      qv[it] = i / D < nrows ? qb[i] : __float2bfloat16(0.f);
    }
    unsigned char vv[kVisIters];
    int pv[kVisIters];
#pragma unroll
    for (int it = 0; it < kVisIters; ++it) {
      const int i = tid + it * kTcThreads;
      vv[it] = i < n_slots ? ok[i] : 0;
      if constexpr (kWindow) pv[it] = i < n_slots ? kp[i] : 0;
    }
#pragma unroll
    for (int it = 0; it < kTcRows * D / kTcThreads; ++it) {
      const int i = tid + it * kTcThreads;
      const int r = i / D, e = i % D;
      *reinterpret_cast<__nv_bfloat16*>(sQ + swz<D>(r, e / 8) + (e % 8) * 2) = qv[it];
    }
#pragma unroll
    for (int it = 0; it < kVisIters; ++it) {
      bool seen = vv[it] != 0;
      if constexpr (kWindow) seen = seen && pv[it] > lo;
      vis[tid + it * kTcThreads] = seen;
    }
  }
  __syncthreads();

  // 2. which tiles hold a visible slot (every warp takes the same bitmask),
  //    and the Q fragments
  uint32_t tile_mask = 0;
#pragma unroll
  for (int it = 0; it < kMaxTiles / 2; ++it) {
    const uint32_t w = reinterpret_cast<const uint32_t*>(vis)[(2 * it + (lane >> 4)) * 16 +
                                                              (lane & 15)];
    const uint32_t bal = __ballot_sync(0xffffffffu, w != 0);
    tile_mask |= static_cast<uint32_t>((bal & 0xffffu) != 0) << (2 * it);
    tile_mask |= static_cast<uint32_t>((bal >> 16) != 0) << (2 * it + 1);
  }
  // With an int8 cache the K fragments come straight from the tile's bytes,
  // four d a thread and k-step: k-step ks = 4 B + s4 gives lane t4 the d
  // e + {0, 2} for its k pair 2 t4 + {0, 1} and e + {1, 3} for 2 t4 + 8 +
  // {0, 1}, e = 64 B + 16 t4 + 4 s4 (the order bf16x2_of_bytes takes a
  // word's bytes in). A dot product does not care in which order it sums
  // its d, as long as Q's fragments take the same order.
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    if constexpr (kInt8) {
      const int e = 64 * (ks / 4) + 16 * t4 + 4 * (ks % 4);  // e % 8 is 0 or 4
      const unsigned char* q0 = sQ + swz<D>(g, e / 8) + (e % 8) * 2;
      const unsigned char* q1 = sQ + swz<D>(g + 8, e / 8) + (e % 8) * 2;
      const uint32_t x0 = *reinterpret_cast<const uint32_t*>(q0);      // d e, e + 1
      const uint32_t y0 = *reinterpret_cast<const uint32_t*>(q0 + 4);  // d e + 2, e + 3
      const uint32_t x1 = *reinterpret_cast<const uint32_t*>(q1);
      const uint32_t y1 = *reinterpret_cast<const uint32_t*>(q1 + 4);
      qa[ks][0] = __byte_perm(x0, y0, 0x5410);
      qa[ks][1] = __byte_perm(x1, y1, 0x5410);
      qa[ks][2] = __byte_perm(x0, y0, 0x7632);
      qa[ks][3] = __byte_perm(x1, y1, 0x7632);
    } else {
      ldmatrix_x4(qa[ks], smem_u32(sQ) + swz<D>((lane & 7) + ((lane >> 3) & 1) * 8,
                                                2 * ks + (lane >> 4)));
    }
  }

  // 3. the ring: visible tiles in order, kStages - 1 in flight
  auto load_tile = [&](int tile, int stage) {
    unsigned char* st = smem + stage * L::kStageBytes;
    const int t0 = tile * kTile;
    const long long c0 = c_begin + t0;
#pragma unroll
    for (int it = 0; it < kTile * kRawUnits / kTcThreads; ++it) {
      const int idx = tid + it * kTcThreads;
      const int r = idx / kRawUnits, u = idx % kRawUnits;
      const bool on = vis[t0 + r] != 0;
      // bf16: the swizzled rows ldmatrix reads; int8: K's 16-byte units of
      // odd rows swapped by halves (the S loop's 16-byte reads of two
      // neighbouring rows then fall in different banks), V's by vswz
      const uint32_t koff = kInt8 ? r * D + ((u ^ ((r & 1) * (kRawUnits / 2))) << 4) : swz<D>(r, u);
      const uint32_t voff = kInt8 ? r * D + ((u ^ vswz<D>(r)) << 4) : swz<D>(r, u);
      const long long at = on ? (c0 + r) * k_sc + u * (16 / static_cast<int>(sizeof(KV))) : 0;
      const long long av = on ? (c0 + r) * v_sc + u * (16 / static_cast<int>(sizeof(KV))) : 0;
      cp_async16(smem_u32(st) + koff, kb + at, on ? 16 : 0);
      cp_async16(smem_u32(st + L::kRawTile) + voff, vb + av, on ? 16 : 0);
    }
    if constexpr (kInt8) {  // the tile's scales: threads 0-63 K's, 64-127 V's
      const int r = tid & (kTile - 1);
      const bool on = vis[t0 + r] != 0;
      const float* src = (tid < kTile ? ksb : vsb) + (on ? c0 + r : 0);
      cp_async4(smem_u32(st + 2 * L::kRawTile + (tid / kTile) * kTile * 4 + r * 4), src,
                on ? 4 : 0);
    }
  };

  uint32_t to_load = tile_mask, to_use = tile_mask;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (to_load) {
      load_tile(__ffs(to_load) - 1, s);
      to_load &= to_load - 1;
    }
    cp_async_commit();
  }

  float m[2] = {-INFINITY, -INFINITY};  // rows g and g + 8, log2 units
  float l[2] = {0.f, 0.f};               // this thread's share of the row sums
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  const int n_vis = __popc(tile_mask);

  for (int i = 0; i < n_vis; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile i landed; every warp is done with tile i - 1's stage
    if (to_load) {
      load_tile(__ffs(to_load) - 1, (i + kStages - 1) % kStages);
      to_load &= to_load - 1;
    }
    cp_async_commit();
    const int tile = __ffs(to_use) - 1;
    to_use &= to_use - 1;
    const unsigned char* st = smem + (i % kStages) * L::kStageBytes;
    const unsigned char* kt = st;
    const unsigned char* vt = st + L::kRawTile;
    // this thread's columns of the tile (wslot + nt * 8 + 2 * t4 + {0, 1}):
    // their visibility and scales, read before S's MMAs, which hide their
    // latency
    const int col0 = wslot + 2 * t4;
    const float* ksc = reinterpret_cast<const float*>(st + 2 * L::kRawTile);
    bool seen[2][2];
    float2 kss[2], vss[2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      seen[nt][0] = vis[tile * kTile + col0 + nt * 8] != 0;
      seen[nt][1] = vis[tile * kTile + col0 + nt * 8 + 1] != 0;
      if constexpr (kInt8) {
        kss[nt] = *reinterpret_cast<const float2*>(ksc + col0 + nt * 8);
        vss[nt] = *reinterpret_cast<const float2*>(ksc + kTile + col0 + nt * 8);
      }
    }
    // S = Q.K^T over this warp's 16 slots: two n-tiles of 8
    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      if constexpr (kInt8) {  // one 16-byte read a row and 64 d: four k-steps
        const int r = wslot + nt * 8 + g;
#pragma unroll
        for (int blk = 0; blk < D / 64; ++blk) {
          const int u = (4 * blk + t4) ^ ((r & 1) * (kRawUnits / 2));
          const uint4 raw = *reinterpret_cast<const uint4*>(kt + r * D + (u << 4));
          const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
          for (int s4 = 0; s4 < 4; ++s4)
            mma_16816(s[nt], qa[4 * blk + s4], bf16x2_of_bytes(w[s4]),
                      bf16x2_of_bytes(w[s4] >> 8));
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < D / 32; ++kk) {
          uint32_t kf[4];
          ldmatrix_x4(kf, smem_u32(kt) +
                              swz<D>(wslot + nt * 8 + (lane & 7), 4 * kk + (lane >> 3)));
          mma_16816(s[nt], qa[2 * kk], kf[0], kf[1]);
          mma_16816(s[nt], qa[2 * kk + 1], kf[2], kf[3]);
        }
      }
    }

    // online softmax: s[nt][e] is row g + 8 * (e / 2), slot col0 + nt * 8 + e % 2
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if constexpr (kInt8) x *= (e & 1) ? kss[nt].y : kss[nt].x;
        s[nt][e] = seen[nt][e & 1] ? x : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
      }
    float base[2], corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mnew = fmaxf(m[r], mx[r]);
      base[r] = mnew == -INFINITY ? 0.f : mnew;  // no -inf - -inf
      corr[r] = exp2f(m[r] - base[r]);
      m[r] = mnew;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[nt][e] - base[e >> 1]);
        l[e >> 1] += p;
        if constexpr (kInt8) {
          s[nt][e] = p == 0.f ? 0.f : p * ((e & 1) ? vss[nt].y : vss[nt].x);
        } else {
          s[nt][e] = p;
        }
      }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= corr[0];
      acc[dn][1] *= corr[0];
      acc[dn][2] *= corr[1];
      acc[dn][3] *= corr[1];
    }

    // O += P.V: P from the S accumulators
    const uint32_t pa[4] = {pack_bf16x2(s[0][0], s[0][1]), pack_bf16x2(s[0][2], s[0][3]),
                            pack_bf16x2(s[1][0], s[1][1]), pack_bf16x2(s[1][2], s[1][3])};
    if constexpr (kInt8) {
      // V's bytes straight into the B registers: n-tile dn = 4 j + q takes
      // d = 32 j + 4 n + q at its column n (g in B, 2 t4 + {0, 1} in acc),
      // so one 4-byte read of each of the slots 2 t4 + {0, 1, 8, 9} gives
      // four n-tiles; the merge puts acc's columns back in d order
      const int r0 = wslot + 2 * t4;
      const int vsw = vswz<D>(r0);  // the same for all four rows
#pragma unroll
      for (int j = 0; j < D / 32; ++j) {
        const int at = (((2 * j + (g >> 2)) ^ vsw) << 4) + 4 * (g & 3);
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(vt + r0 * D + at);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(vt + (r0 + 1) * D + at);
        const uint32_t w8 = *reinterpret_cast<const uint32_t*>(vt + (r0 + 8) * D + at);
        const uint32_t w9 = *reinterpret_cast<const uint32_t*>(vt + (r0 + 9) * D + at);
#pragma unroll
        for (int qp = 0; qp < 2; ++qp) {
          // bytes q = 2 qp, 2 qp + 1 of the two slots, as 16-bit halves
          const uint32_t v01 = __byte_perm(w0, w1, qp ? 0x7632 : 0x5410);
          const uint32_t v89 = __byte_perm(w8, w9, qp ? 0x7632 : 0x5410);
          mma_16816(acc[4 * j + 2 * qp], pa, bf16x2_of_bytes(v01), bf16x2_of_bytes(v89));
          mma_16816(acc[4 * j + 2 * qp + 1], pa, bf16x2_of_bytes(v01 >> 8),
                    bf16x2_of_bytes(v89 >> 8));
        }
      }
    } else {  // V by ldmatrix.trans
#pragma unroll
      for (int du = 0; du < D / 16; ++du) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, smem_u32(vt) + swz<D>(wslot + (lane & 7) + ((lane >> 3) & 1) * 8,
                                                    2 * du + (lane >> 4)));
        mma_16816(acc[2 * du], pa, vf[0], vf[1]);
        mma_16816(acc[2 * du + 1], pa, vf[2], vf[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the merge reuses it

  // 4. merge the 4 warps through shared memory
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* wacc = reinterpret_cast<float*>(smem);  // [warps][16][D]
  float* wm = wacc + kTcWarps * kTcRows * D;      // [warps][16]
  float* wl = wm + kTcWarps * kTcRows;            // [warps][16]
  float* sw = wl + kTcWarps * kTcRows;            // [16][kMaxSplits]: the splits' weights
  float* sinv = sw + kTcRows * kMaxSplits;        // [16]: 1 / the row's sum
  if (t4 == 0) {
    wm[warp * kTcRows + g] = m[0];
    wm[warp * kTcRows + g + 8] = m[1];
    wl[warp * kTcRows + g] = l[0];
    wl[warp * kTcRows + g + 8] = l[1];
  }
  // the rows past the group are padding: never written, never read
  const bool row_lo = g < nrows, row_hi = g + 8 < nrows;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    if constexpr (kInt8) {  // column 2 t4 of n-tile 4 j + q is d = 32 j + 8 t4 + q
      float* row = wacc + (warp * kTcRows + g) * D + 32 * (dn / 4) + 8 * t4 + dn % 4;
      if (row_lo) {
        row[0] = acc[dn][0];
        row[4] = acc[dn][1];
      }
      if (row_hi) {
        row[8 * D] = acc[dn][2];
        row[8 * D + 4] = acc[dn][3];
      }
    } else {
      float* row = wacc + (warp * kTcRows + g) * D + dn * 8 + 2 * t4;
      if (row_lo) *reinterpret_cast<float2*>(row) = make_float2(acc[dn][0], acc[dn][1]);
      if (row_hi) *reinterpret_cast<float2*>(row + 8 * D) = make_float2(acc[dn][2], acc[dn][3]);
    }
  }
  __syncthreads();

  __nv_bfloat16* ob = out + (b * H + static_cast<long long>(ch) * group + j0) * D;
  float* part_acc = part;  // [units][nsplit][16][D], then (m, l) [units][nsplit][16][2]
  float* part_ml = part + static_cast<long long>(gridDim.z) * gridDim.y * nsplit * kTcRows * D;
  const long long prow0 = (unit * nsplit + split) * kTcRows;
  for (int i = tid; i < nrows * D; i += kTcThreads) {
    const int j = i / D, e = i % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kTcWarps; ++w) M = fmaxf(M, wm[w * kTcRows + j]);
    float lsum = 0.f, a = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kTcWarps; ++w) {
        const float f = exp2f(wm[w * kTcRows + j] - M);
        lsum += f * wl[w * kTcRows + j];
        a += f * wacc[(w * kTcRows + j) * D + e];
      }
    }
    if (nsplit == 1) {
      ob[i] = __float2bfloat16(lsum > 0.f ? a / lsum : 0.f);
    } else {
      part_acc[(prow0 + j) * D + e] = a;
      if (e == 0) {
        part_ml[2 * (prow0 + j)] = M;
        part_ml[2 * (prow0 + j) + 1] = lsum;
      }
    }
  }
  if (nsplit == 1) return;

  // 5. the last CTA of this (b, ch, row group) to arrive merges the splits:
  //    the barrier orders the CTA's partial writes before thread 0's fence
  //    (cumulative) and ticket
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(&counters[unit], 1) == nsplit - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const long long srow0 = unit * nsplit * kTcRows;
  for (int j = warp; j < nrows; j += kTcWarps) {
    float M = -INFINITY;
    for (int sp = lane; sp < nsplit; sp += 32)
      M = fmaxf(M, __ldcg(part_ml + 2 * (srow0 + sp * kTcRows + j)));
    M = warp_max(M);
    float lsum = 0.f;
    for (int sp = lane; sp < nsplit; sp += 32) {
      const float* ml = part_ml + 2 * (srow0 + sp * kTcRows + j);
      const float f = M == -INFINITY ? 0.f : exp2f(__ldcg(ml) - M);
      sw[j * kMaxSplits + sp] = f;
      lsum += f * __ldcg(ml + 1);
    }
    lsum = warp_sum(lsum);
    if (lane == 0) sinv[j] = lsum > 0.f ? 1.f / lsum : 0.f;
  }
  __syncthreads();
  // every thread takes one float4 of the output rows and a share of the
  // splits, so that all the partials' loads are in flight at once
  float4* red = reinterpret_cast<float4*>(sinv + kTcRows);  // [parts][items]
  const int items = nrows * (D / 4);
  const int parts = max(1, kTcThreads / items);
  for (int it = tid; it < items * parts; it += kTcThreads) {
    const int item = it % items, part = it / items;
    const int j = item / (D / 4), e4 = item % (D / 4);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int sp = part; sp < nsplit; sp += parts) {
      const float w = sw[j * kMaxSplits + sp];
      const float4 x =
          __ldcg(reinterpret_cast<const float4*>(part_acc + (srow0 + sp * kTcRows + j) * D) + e4);
      a.x += w * x.x;
      a.y += w * x.y;
      a.z += w * x.z;
      a.w += w * x.w;
    }
    if (parts == 1) {
      store_row4(ob + j * D + 4 * e4, a, sinv[j]);
    } else {
      red[part * items + item] = a;
    }
  }
  if (parts > 1) {
    __syncthreads();
    for (int item = tid; item < items; item += kTcThreads) {
      float4 a = red[item];
      for (int part = 1; part < parts; ++part) {
        const float4 x = red[part * items + item];
        a.x += x.x;
        a.y += x.y;
        a.z += x.z;
        a.w += x.w;
      }
      const int j = item / (D / 4), e4 = item % (D / 4);
      store_row4(ob + j * D + 4 * e4, a, sinv[j]);
    }
  }
  if (tid == 0) counters[unit] = 0;  // ready for the next call on this stream
}

struct Args {
  const void *q, *k, *v, *k_scale, *v_scale, *valid, *qpos, *kpos;
  void *scratch, *counters, *out;
  int B, CH, group, C, tiles, nsplit, window;
  long long k_sb, k_sh, k_sc, v_sb, v_sh, v_sc, m_sb, m_sh, ks_sb, ks_sh, vs_sb, vs_sh, p_sb,
      p_sh;
  float scale;
  cudaStream_t stream;
};

// float32: the split pass into the scratch's (m, l, acc) planes, then the merge pass
template <typename KV, int D, bool kWindow>
cudaError_t launch_f32(const Args& a) {
  const int chunk = a.tiles * kTile;
  if (chunk > kMaxChunk || static_cast<long long>(chunk) * a.nsplit < a.C)
    return cudaErrorInvalidValue;
  auto kernel = decode_split_kernel<float, KV, D, kWindow>;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           split_smem_bytes<D>(kMaxChunk));
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  float* part_m = static_cast<float*>(a.scratch);
  const long long plane = static_cast<long long>(a.B) * a.CH * a.nsplit * a.group;
  float* part_l = part_m + plane;
  float* part_acc = part_l + plane;
  const int n_rg = (a.group + kMaxRows - 1) / kMaxRows;
  const dim3 grid(a.nsplit, a.CH * n_rg, a.B);
  kernel<<<grid, kThreads, split_smem_bytes<D>(chunk), a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const KV*>(a.k), static_cast<const KV*>(a.v),
      static_cast<const float*>(a.k_scale), static_cast<const float*>(a.v_scale),
      static_cast<const unsigned char*>(a.valid), static_cast<const int*>(a.qpos),
      static_cast<const int*>(a.kpos), part_m, part_l, part_acc, a.CH, a.group, a.C, chunk,
      a.window, a.k_sb, a.k_sh, a.k_sc, a.v_sb, a.v_sh, a.v_sc, a.m_sb, a.m_sh, a.ks_sb,
      a.ks_sh, a.vs_sb, a.vs_sh, a.p_sb, a.p_sh, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 mgrid(a.CH * a.group, a.B);
  decode_merge_kernel<float><<<mgrid, D, 0, a.stream>>>(
      part_m, part_l, part_acc, static_cast<float*>(a.out), a.CH, a.group, a.nsplit, D);
  return cudaGetLastError();
}

template <typename KV, int D, bool kWindow>
cudaError_t launch_tc(const Args& a) {
  using L = TcLayout<KV, D>;
  const long long span = static_cast<long long>(a.tiles) * kTile;
  if (a.tiles < 1 || a.tiles > kMaxTiles || a.nsplit < 1 || a.nsplit > kMaxSplits ||
      span * (a.nsplit - 1) >= a.C || span * a.nsplit < a.C ||
      (a.nsplit > 1 && (a.scratch == nullptr || a.counters == nullptr)))
    return cudaErrorInvalidValue;
  auto kernel = decode_attn_tc_kernel<KV, D, kWindow>;
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const int n_rg = (a.group + kTcRows - 1) / kTcRows;
  const dim3 grid(a.nsplit, a.CH * n_rg, a.B);
  kernel<<<grid, kTcThreads, L::kBytes, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), static_cast<const float*>(a.k_scale),
      static_cast<const float*>(a.v_scale), static_cast<const unsigned char*>(a.valid),
      static_cast<const int*>(a.qpos), static_cast<const int*>(a.kpos),
      static_cast<float*>(a.scratch), static_cast<int*>(a.counters),
      static_cast<__nv_bfloat16*>(a.out), a.CH, a.group, a.C, a.tiles, a.window, a.k_sb,
      a.k_sh, a.k_sc, a.v_sb, a.v_sh, a.v_sc, a.m_sb, a.m_sh, a.ks_sb, a.ks_sh, a.vs_sb,
      a.vs_sh, a.p_sb, a.p_sh, a.scale * kLog2e);
  return cudaGetLastError();
}

// bf16 q: the tensor-core kernel over a bf16 or int8 cache; float32 q: the CUDA-core pair
template <int D>
cudaError_t launch_any(int dtype, int kv_int8, const Args& a) {
  const bool w = a.window > 0;
  if (dtype == fastkv::kBFloat16 && kv_int8)
    return w ? launch_tc<int8_t, D, true>(a) : launch_tc<int8_t, D, false>(a);
  if (dtype == fastkv::kBFloat16)
    return w ? launch_tc<__nv_bfloat16, D, true>(a) : launch_tc<__nv_bfloat16, D, false>(a);
  if (kv_int8) return w ? launch_f32<int8_t, D, true>(a) : launch_f32<int8_t, D, false>(a);
  return w ? launch_f32<float, D, true>(a) : launch_f32<float, D, false>(a);
}

}  // namespace

// q [B, H, 1, D] contiguous, bf16 or float32; k/v cache [B, CH, C, D] in q's
// type, or int8 with kv_int8 = 1, with unit stride along D (other strides in
// elements; with bf16 q, 16-byte aligned base and strides, for cp.async);
// k_scale / v_scale [B, CH, C] float32 with unit stride along C (int8 only,
// else null); valid [B, CH or 1, C] bytes with unit stride along C (m_sh = 0
// broadcasts one mask over the cache heads); window: W >= 1, or 0 for none,
// when qpos [B] int32 and kpos [B, CH or 1, C] int32 (unit stride along C)
// are read. The split plan: `tiles` 64-slot tiles a split, `nsplit` splits
// (tiles <= 32, every split non-empty). scratch: float32, with bf16 q
// [B, CH, ceil(group / 16), nsplit, 16, D + 2] (null if nsplit = 1), with
// float32 q [3 planes: m, l, acc] of [B, CH, nsplit, group] (acc x D);
// counters: B * CH * ceil(group / 16) ints, 0 before the call and left 0
// (bf16 q, nsplit > 1). out [B, H, 1, D] contiguous in q's type.
extern "C" int decode_attn(int dtype, int kv_int8, int head_dim, const void* q, const void* k,
                           const void* v, const void* k_scale, const void* v_scale,
                           const void* valid, const void* qpos, const void* kpos,
                           void* scratch, void* counters, void* out, int B, int CH, int group,
                           int C, int tiles, int nsplit, int window, long long k_sb,
                           long long k_sh, long long k_sc, long long v_sb, long long v_sh,
                           long long v_sc, long long m_sb, long long m_sh, long long ks_sb,
                           long long ks_sh, long long vs_sb, long long vs_sh, long long p_sb,
                           long long p_sh, float scale, void* stream) {
  if (window < 0 || (kv_int8 && (k_scale == nullptr || v_scale == nullptr)) ||
      (window > 0 && (qpos == nullptr || kpos == nullptr)) ||
      (dtype != fastkv::kBFloat16 && dtype != fastkv::kFloat32))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,     k,     v,     k_scale, v_scale, valid, qpos,  kpos,  scratch, counters,
               out,   B,     CH,    group,   C,       tiles, nsplit, window, k_sb,  k_sh,
               k_sc,  v_sb,  v_sh,  v_sc,    m_sb,    m_sh,  ks_sb, ks_sh, vs_sb, vs_sh,
               p_sb,  p_sh,  scale, static_cast<cudaStream_t>(stream)};
  if (head_dim == 128) return static_cast<int>(launch_any<128>(dtype, kv_int8, a));
  if (head_dim == 64) return static_cast<int>(launch_any<64>(dtype, kv_int8, a));
  return static_cast<int>(cudaErrorInvalidValue);
}
