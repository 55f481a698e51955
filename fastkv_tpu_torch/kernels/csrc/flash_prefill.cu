// flash_prefill: causal flash attention over one prefill segment, for Hopper,
// with an optional sliding window, square or rectangular.
//
// Replaces the TPU kernel fastkv_tpu/ops/flash_prefill.py::flash_attention
// (Pallas _kernel :67-244, pallas_call :472) in its causal square form, with
// and without its sliding-window term (:143-144), and in its rectangular form
// (sk != s) with the dynamic k_hi key-block gate (:285-290, :366-370): a chunk
// of queries against a longer key scratch, as chunked admission calls it; and
// in the square form with its fused observation-window scores (window_q /
// window_q_pos, :177-235, :311-335): the W window query rows of SnapKV/FastKV
// scored against every key as the keys pass, with or without the sliding
// window. No (m, l) outputs.
//
// Per batch b and query head h (kv head h / group):
//   O[i] = sum_j softmax_j(q_i . k_j * scale, masked) v_j
// with a float32 online softmax. Key j is visible to query i when
//   kpos[j] <= qpos[i]                      (causal), and, when window W > 0,
//   kpos[j] >  qpos[i] - W                  (sliding window).
// The wrapper has folded key validity into kpos (slots at or beyond the valid
// count, and in the rectangular form at or beyond k_hi, carry 2^30), so
// causality is one compare. A row that sees no key writes 0. Positions are
// non-negative; W is a runtime argument, 0 = no window.
//
// Bound on the H100: operations. At Llama-3.1-8B width and s = 8192 the causal
// half is ~5.5e11 FLOP per layer call (0.56 ms at 989 TFLOP/s bf16), against
// ~0.27 GB of q/k/v/o bytes (0.08 ms at 3.35 TB/s). At Ministral-8B's
// s = 40960 under its window W = 32768 the band holds 8.05e8 (query, key)
// pairs: 1.32e13 FLOP per layer call (13.3 ms), against 1.3 GB (0.4 ms). A
// 2048-row chunk at start 6144 over an 8192-slot scratch sees 1.47e7 pairs
// per head: 2.4e11 FLOP (0.24 ms).
//
// Design: one block per (64-row query tile, query head, batch). In the square
// form it walks key tiles only up to the diagonal, by index: valid positions
// form an ascending prefix, so a key after the query's index is later or
// invalid. The upper triangle costs neither loads nor FLOPs. The rectangular
// form has no shared index: its walk ends at ceil(min(k_hi, Sk) / 64) tiles,
// and earlier still from the data. kpos is non-decreasing (ascending valid
// prefix, then 2^30), so a tile's smallest key position is that of its first
// key, and a tile whose first key lies above the largest query position of
// the query tile is invisible to every row, as is every tile after it. The
// count of tiles before the first such tile is taken in one parallel pass
// over the tiles' first keys. That restores the per-tile triangle of the
// square form for a chunk at any offset. Under a window the block also skips
// the key tiles that lie wholly below the band, from the data: a tile's
// largest key position is that of its last key, and a tile whose last key
// lies at or below min over the tile's rows of qpos - W is invisible to every
// row. Both passes are exact for any ascending valid prefix (layout indices,
// or the scattered original positions of a post-TSP layout), and for rows past
// the count whatever their positions: a skipped tile is one that would have
// added nothing. So at s = 40960, W = 32768 a tile walks at most 513 key
// tiles, not up to 640.
// Launch order: query tiles launch from the last to the first (blockIdx.x 0 is
// the last tile). Causally the last tiles walk the most key tiles; under a
// window every tile at or past W / 64 walks the same ~W / 64 + 1 tiles, and
// they launch first, followed by the shorter ones in decreasing length.
// Q, K and V tiles are staged in shared memory as float32 (rows padded by one
// word, so column walks hit distinct banks); each of the 256 threads owns a
// 4x4 piece of the 64x64 score tile and a 4 x d/16 piece of the output
// accumulator. At d = 128 a block takes 115,712 bytes of shared memory, so
// exactly two blocks share an SM (228 KB, 1 KB of it reserved per block): the
// scratch of both passes reuses that memory rather than adding to it. This
// first version multiplies on the CUDA cores in float32: simple, exact for the
// float32 check, and far from the bound. Tensor cores (wgmma), TMA and warp
// specialisation are later work. The window and the rectangular form are
// template flags of the kernel, chosen at launch (the window from the runtime
// W, the rectangular form from a k_hi array), so the square causal
// instantiation compiles to the same code as without either.
//
// Fused window scores (a third template flag, square form only). The scores
// of query head h are, for each key j,
//   S[j] = sum_w softmax_j(qw_w . k_j * scale, masked)
// over the W window rows, with the exact full-row softmax of each row (its
// true max and sum over all keys, no online rescale) and the mask of the
// Pallas strip: kpos[j] <= wpos[w] (the folded kpos also drops keys at or past
// the count) and wpos[w] >= 0 (-1 marks a row of a short prompt); no
// sliding-window term, as the JAX package scores the whole causal prefix. The
// TPU kernel keeps the raw strip [W, sk] in VMEM and finishes it at its last
// grid step; no SM holds 8.4 MB (W = 8, s = 8192, 32 heads), and blocks run in
// no order, so here:
//   * in the square form the block of query tile t visits key tile t (its
//     diagonal) last, with or without a window (tiles_below_band never skips
//     it: the diagonal's last key is a valid key at or after the tile's first
//     query, or invalid). After that tile's attention update the block's Q
//     shared memory is free: it stages the window rows there, 64 at a time,
//     and scores them against the K tile still resident. Each key tile is
//     scored exactly once, by the block whose diagonal it is, and no block
//     waits for another; every strip column [0, Sk) is written exactly once,
//     columns at or past the count as masked (-inf). A later early exit that
//     skips tiles past the count must keep writing those columns masked.
//   * the raw masked logits go to a float32 strip [b, H, W, Sk] in device
//     memory, and window_scores_finish (one block per (head, batch)) takes
//     each row's max and sum, then writes the column sums. A row that sees no
//     key gives 0.
// It adds 2 W s d FLOP a head (5.4e8 a layer at Llama-3.1-8B, W = 8, s =
// 8192: 0.1% of the attention's) and 2 x 4 W s bytes a head of strip traffic,
// and no shared memory: the scores instantiations use the same 115,712 bytes.
#include <limits.h>

#include "common.cuh"

namespace {

using fastkv::from_float;
using fastkv::half_warp_max;
using fastkv::half_warp_sum;
using fastkv::round_to;
using fastkv::to_float;

constexpr int kBlockQ = 64;  // query rows per block
constexpr int kBlockK = 64;  // keys per tile (== kBlockQ: the diagonal tile is qt)
constexpr int kThreads = 256;
constexpr int kRows = 4;  // query rows per thread: 16 row groups x 4
constexpr int kCols = 4;  // key columns per thread: 16 lanes x 4, stride 16
constexpr int kInvalidPos = 1 << 30;

template <int D>
struct Smem {
  static constexpr int kStride = D + 1;         // Q and K row stride
  static constexpr int kPStride = kBlockK + 1;  // P row stride
  static constexpr int kFloats =
      kBlockQ * kStride + kBlockK * kStride + kBlockK * D + kBlockQ * kPStride;
  static constexpr size_t kBytes = kFloats * sizeof(float) + kBlockK * sizeof(int);
};

// The number of key tiles, from the first, that lie wholly below the window
// band of every row of the query tile starting at q0 (see the note above).
// Called by all threads of the block; n_kt >= 1 is the same for all of them.
// s_min is scratch for kBlockQ / 32 ints in the dynamic shared memory, free
// until the first tile is staged: a static __shared__ array would add to the
// block's 115,712 bytes at d = 128, and two blocks fill an SM's 228 KB (with
// 1 KB reserved per block) to the byte, so one more word halves occupancy.
__device__ int tiles_below_band(const int* __restrict__ qpos, const int* __restrict__ kpos,
                                int q0, int Sq, int Sk, int n_kt, int window, int* s_min) {
  const int tid = threadIdx.x;
  if (tid < kBlockQ) {
    const int row = q0 + tid;
    const int p = __reduce_min_sync(0xffffffffu, row < Sq ? qpos[row] : INT_MAX);
    if ((tid & 31) == 0) s_min[tid >> 5] = p;
  }
  __syncthreads();
  int lowest = s_min[0];
#pragma unroll
  for (int w = 1; w < kBlockQ / 32; ++w) lowest = min(lowest, s_min[w]);
  const long long lo = static_cast<long long>(lowest) - window;
  int below = 0;
  for (int base = 0; base < n_kt; base += kThreads) {
    const int t = base + tid;
    const bool out = t < n_kt && kpos[min(t * kBlockK + kBlockK - 1, Sk - 1)] <= lo;
    below += __syncthreads_count(out);
  }
  return below;
}

// Rectangular form: the number of key tiles, of the first n_kt, before the
// first tile whose first key lies above every query position of the query
// tile starting at q0 (see the note above). Called by all threads of the
// block. s_max is scratch for kBlockQ / 32 ints in the dynamic shared memory,
// apart from tiles_below_band's.
__device__ int tiles_up_to_queries(const int* __restrict__ qpos, const int* __restrict__ kpos,
                                   int q0, int Sq, int n_kt, int* s_max) {
  const int tid = threadIdx.x;
  if (tid < kBlockQ) {
    const int row = q0 + tid;
    const int p = __reduce_max_sync(0xffffffffu, row < Sq ? qpos[row] : -1);
    if ((tid & 31) == 0) s_max[tid >> 5] = p;
  }
  __syncthreads();
  int highest = s_max[0];
#pragma unroll
  for (int w = 1; w < kBlockQ / 32; ++w) highest = max(highest, s_max[w]);
  int seen = 0;
  for (int base = 0; base < n_kt; base += kThreads) {
    const int t = base + tid;
    seen += __syncthreads_count(t < n_kt && kpos[t * kBlockK] <= highest);
  }
  return seen;
}

template <typename T, int D, bool kWindow, bool kRect, bool kScores>
__global__ void __launch_bounds__(kThreads) flash_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ qpos, const int* __restrict__ kpos, const int* __restrict__ khi,
    T* __restrict__ out, int H, int group, int Sq, int Sk_arg, int window, long long q_sb,
    long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, float scale, const T* __restrict__ wq, const int* __restrict__ wpos,
    float* __restrict__ strip, int W, long long wq_sb, long long wq_sh, long long wq_sw) {
  using L = Smem<D>;
  constexpr int kOut = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBlockQ * L::kStride;
  float* sV = sK + kBlockK * L::kStride;
  float* sP = sV + kBlockK * D;
  int* sKpos = reinterpret_cast<int*>(sP + kBlockQ * L::kPStride);

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest query tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kBlockQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  // the square form has one extent for queries and keys
  const int Sk = kRect ? Sk_arg : Sq;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + (h / group) * k_sh;
  const T* vb = v + b * v_sb + (h / group) * v_sh;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int row = q0 + r;
    sQ[r * L::kStride + c] = row < Sq ? to_float(qb[row * q_ss + c]) : 0.f;
  }

  int pq[kRows];
  int lo[kRows];  // under a window: key positions at or below lo are out of the band
  float m[kRows], l[kRows], acc[kRows][kOut];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + ty * kRows + r;
    pq[r] = row < Sq ? qpos[b * Sq + row] : -1;  // rows past Sq see nothing
    lo[r] = kWindow ? pq[r] - window : 0;        // pq >= -1 and window >= 1: no overflow
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < kOut; ++j) acc[r][j] = 0.f;
  }

  int n_kt;
  if constexpr (kRect) {
    // the k_hi gate (the wrapper clamps k_hi to [0, Sk]), then the data
    const int hi = (khi[b] + kBlockK - 1) / kBlockK;
    n_kt = tiles_up_to_queries(qpos + b * Sq, kpos + b * Sk, q0, Sq, hi, sKpos + kBlockQ / 32);
  } else {
    n_kt = min((Sk + kBlockK - 1) / kBlockK, qt + 1);
  }
  int kt0 = 0;
  if constexpr (kWindow)
    kt0 = tiles_below_band(qpos + b * Sq, kpos + b * Sk, q0, Sq, Sk, n_kt, window, sKpos);
  for (int kt = kt0; kt < n_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // the previous tile is consumed (and sQ is written)
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int key = k0 + r;
      const bool in = key < Sk;
      sK[r * L::kStride + c] = in ? to_float(kb[key * k_ss + c]) : 0.f;
      sV[r * D + c] = in ? to_float(vb[key * v_ss + c]) : 0.f;
    }
    if (tid < kBlockK) sKpos[tid] = k0 + tid < Sk ? kpos[b * Sk + k0 + tid] : kInvalidPos;
    __syncthreads();

    float sc[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) sc[r][c] = 0.f;
    for (int e = 0; e < D; ++e) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) qv[r] = sQ[(ty * kRows + r) * L::kStride + e];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = sK[(tx + 16 * c) * L::kStride + e];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) sc[r][c] = fmaf(qv[r], kv[c], sc[r][c]);
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int kp = sKpos[tx + 16 * c];
        bool ok = kp <= pq[r];
        if constexpr (kWindow) ok = ok && kp > lo[r];
        sc[r][c] = ok ? sc[r][c] * scale : -INFINITY;
        mx = fmaxf(mx, sc[r][c]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[r], mx);
      const bool none = m_new == -INFINITY;  // no visible key yet
      const float corr = none ? 1.f : expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float p = none ? 0.f : expf(sc[r][c] - m_new);
        sum += p;
        sP[(ty * kRows + r) * L::kPStride + tx + 16 * c] = round_to<T>(p);
      }
      sum = half_warp_sum(sum);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < kOut; ++j) acc[r][j] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < kBlockK; ++c) {
      float pv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) pv[r] = sP[(ty * kRows + r) * L::kPStride + c];
#pragma unroll
      for (int j = 0; j < kOut; ++j) {
        const float vv = sV[c * D + tx + 16 * j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][j] = fmaf(pv[r], vv, acc[r][j]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + ty * kRows + r;
    if (row < Sq) {
      const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
      T* o = out + ((static_cast<long long>(b) * H + h) * Sq + row) * D;
#pragma unroll
      for (int j = 0; j < kOut; ++j) o[tx + 16 * j] = from_float<T>(acc[r][j] * inv);
    }
  }

  if constexpr (kScores) {
    // the walk ended at the diagonal (kt = qt): sK and sKpos hold key tile qt
    const int k0 = qt * kBlockK;
    const T* wqb = wq + b * wq_sb + h * wq_sh;
    float* sb = strip + (static_cast<long long>(b) * H + h) * W * Sk;
    for (int w0 = 0; w0 < W; w0 += kBlockQ) {
      const int nw = min(kBlockQ, W - w0);
      __syncthreads();  // nothing reads sQ any more (the last tile's or group's scores)
      for (int i = tid; i < kBlockQ * D; i += kThreads) {
        const int r = i / D, c = i % D;
        sQ[r * L::kStride + c] = r < nw ? to_float(wqb[(w0 + r) * wq_sw + c]) : 0.f;
      }
      __syncthreads();
      float sc[kRows][kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) sc[r][c] = 0.f;
      for (int e = 0; e < D; ++e) {
        float qv[kRows], kv[kCols];
#pragma unroll
        for (int r = 0; r < kRows; ++r) qv[r] = sQ[(ty * kRows + r) * L::kStride + e];
#pragma unroll
        for (int c = 0; c < kCols; ++c) kv[c] = sK[(tx + 16 * c) * L::kStride + e];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int c = 0; c < kCols; ++c) sc[r][c] = fmaf(qv[r], kv[c], sc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int wr = ty * kRows + r;
        if (wr >= nw) continue;
        const int pw = wpos[b * W + w0 + wr];
        float* srow = sb + static_cast<long long>(w0 + wr) * Sk;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int col = k0 + tx + 16 * c;
          if (col < Sk) {
            const bool ok = pw >= 0 && sKpos[tx + 16 * c] <= pw;
            srow[col] = ok ? sc[r][c] * scale : -INFINITY;
          }
        }
      }
    }
  }
}

// The fused scores' second pass, one block per (head, batch) over its strip
// [W, Sk] of raw masked logits: each row's true max and sum (a warp per
// row), then per key the sum over rows of exp(x - max) / sum. Memory-bound
// and small (8.4 MB of strip at Llama-3.1-8B, s = 8192, W = 8).
__global__ void window_scores_finish_kernel(const float* __restrict__ strip,
                                            float* __restrict__ scores, int H, int W, int Sk) {
  extern __shared__ float s_row[];  // [W] row max, then [W] 1 / row sum (0: sees nothing)
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const float* sb = strip + (static_cast<long long>(b) * H + h) * W * Sk;
  for (int w = threadIdx.x >> 5; w < W; w += blockDim.x >> 5) {
    const float* row = sb + static_cast<long long>(w) * Sk;
    float mx = -INFINITY;
    for (int i = lane; i < Sk; i += 32) mx = fmaxf(mx, row[i]);
    mx = fastkv::warp_max(mx);
    float sum = 0.f;
    if (mx != -INFINITY)
      for (int i = lane; i < Sk; i += 32) sum += expf(row[i] - mx);
    sum = fastkv::warp_sum(sum);
    if (lane == 0) {
      s_row[w] = mx;
      s_row[W + w] = sum > 0.f ? 1.f / sum : 0.f;
    }
  }
  __syncthreads();
  float* out = scores + (static_cast<long long>(b) * H + h) * Sk;
  for (int col = threadIdx.x; col < Sk; col += blockDim.x) {
    float acc = 0.f;
    for (int w = 0; w < W; ++w) {
      const float mx = s_row[w];
      if (mx != -INFINITY) acc += expf(sb[static_cast<long long>(w) * Sk + col] - mx) * s_row[W + w];
    }
    out[col] = acc;
  }
}

struct Args {
  const void *q, *k, *v, *qpos, *kpos, *khi;
  void* out;
  int B, H, KH, Sq, Sk, window;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  float scale;
  const void *wq, *wpos;
  void* strip;
  int W;
  long long wq_sb, wq_sh, wq_sw;
  cudaStream_t stream;
};

template <typename T, int D, bool kWindow, bool kRect, bool kScores>
cudaError_t launch(const Args& a) {
  constexpr size_t smem = Smem<D>::kBytes;
  auto kernel = flash_prefill_kernel<T, D, kWindow, kRect, kScores>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kBlockQ - 1) / kBlockQ, a.H, a.B);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const int*>(a.qpos), static_cast<const int*>(a.kpos),
      static_cast<const int*>(a.khi), static_cast<T*>(a.out), a.H, a.H / a.KH, a.Sq, a.Sk,
      a.window, a.q_sb, a.q_sh, a.q_ss, a.k_sb, a.k_sh, a.k_ss, a.v_sb, a.v_sh, a.v_ss, a.scale,
      static_cast<const T*>(a.wq), static_cast<const int*>(a.wpos), static_cast<float*>(a.strip),
      a.W, a.wq_sb, a.wq_sh, a.wq_sw);
  return cudaGetLastError();
}

// the form's instantiation, chosen at launch: rectangular (a k_hi array),
// fused scores (window rows), or the square causal one; each with or
// without the window
template <typename T, int D>
cudaError_t launch_form(const Args& a) {
  const bool w = a.window > 0;
  if (a.khi != nullptr) return w ? launch<T, D, true, true, false>(a) : launch<T, D, false, true, false>(a);
  if (a.wq != nullptr) return w ? launch<T, D, true, false, true>(a) : launch<T, D, false, false, true>(a);
  return w ? launch<T, D, true, false, false>(a) : launch<T, D, false, false, false>(a);
}

}  // namespace

// q [B, H, Sq, D], k/v [B, KH, Sk, D] with unit stride along D (other strides
// in elements); qpos [B, Sq] and kpos [B, Sk] int32 contiguous; out
// [B, H, Sq, D] contiguous; window: the sliding window W >= 1, or 0 for none.
// khi: null for the square form (Sq == Sk, key tiles walked up to the
// diagonal), or a device array [B] int32 of k_hi values in [0, Sk] for the
// rectangular form (key tiles from ceil(k_hi / 64) on are neither loaded nor
// computed; the wrapper has folded keys at or beyond k_hi into kpos as
// invalid, so the result does not depend on the tiling).
// Fused window scores (square form only; null wq for none): wq [B, H, W, D]
// window query rows with unit stride along D, wpos [B, W] int32 contiguous
// (-1: a row that scores nothing), strip [B, H, W, Sk] float32 contiguous,
// written whole; window_scores_finish then turns it into scores [B, H, Sk].
extern "C" int flash_prefill(int dtype, int head_dim, const void* q, const void* k,
                             const void* v, const void* qpos, const void* kpos,
                             const void* khi, void* out, int B, int H, int KH, int Sq, int Sk,
                             int window, long long q_sb, long long q_sh, long long q_ss,
                             long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                             long long v_sh, long long v_ss, float scale, const void* wq,
                             const void* wpos, void* strip, int W, long long wq_sb,
                             long long wq_sh, long long wq_sw, void* stream) {
  if (window < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool rect = khi != nullptr;
  if (!rect && Sq != Sk) return static_cast<int>(cudaErrorInvalidValue);
  if (wq != nullptr && (rect || W < 1 || wpos == nullptr || strip == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,    k,    v,    qpos, kpos, khi,   out,   B,     H,     KH,    Sq,
               Sk,   window, q_sb, q_sh, q_ss, k_sb,  k_sh,  k_ss,  v_sb,  v_sh,  v_ss,
               scale, wq,  wpos, strip, W,   wq_sb, wq_sh, wq_sw, static_cast<cudaStream_t>(stream)};
  if (dtype == fastkv::kBFloat16 && head_dim == 128) return launch_form<__nv_bfloat16, 128>(a);
  if (dtype == fastkv::kBFloat16 && head_dim == 64) return launch_form<__nv_bfloat16, 64>(a);
  if (dtype == fastkv::kFloat32 && head_dim == 128) return launch_form<float, 128>(a);
  if (dtype == fastkv::kFloat32 && head_dim == 64) return launch_form<float, 64>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// strip [B, H, W, Sk] float32 (as flash_prefill's fused form wrote it) ->
// scores [B, H, Sk] float32, both contiguous.
extern "C" int window_scores_finish(const void* strip, void* scores, int B, int H, int W,
                                    int Sk, void* stream) {
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(W);
  if (W < 1 || smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  window_scores_finish_kernel<<<dim3(H, B), 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(strip), static_cast<float*>(scores), H, W, Sk);
  return static_cast<int>(cudaGetLastError());
}
