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
// window; and with the (m, l) row statistics (:97-99, :242-244, outputs at
// :431-436, :483-485) that ring attention merges partials with, in the square
// form (its local step) and in the rectangular form of the 'full' pattern (a
// K/V chunk from another shard, :271-278), with or without the window.
//
// One more bf16 form, for DeepSeek-V2's latent attention (MLA): q and k 192
// wide (128 nope + 64 rope), v 128 wide, the causal square without a window
// (flash_prefill_sm90_kernel<192, 128, ...>). Q and K tiles are three
// 64-column boxes, V tiles two: Q 48 KB + 2 x (K 48 + V 32) = 208 KB of
// shared memory. S = Q K^T takes 12 k-steps of 16 instead of 8; the softmax,
// P V and the epilogue are the d = 128 form's (the output is v's width). At
// 16 heads and s = 32768 a layer's call is 5.6e12 FLOP (2 x 192 + 2 x 128 a
// visible pair and head), 5.7 ms at 989 TFLOP/s, against 0.67 GB (0.2 ms).
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
// Two kernels, one per dtype, with the same walk and the same semantics:
//   * bfloat16 (every model at full width): flash_prefill_sm90_kernel, on the
//     tensor cores (wgmma), fed by TMA through a ring of shared memory, with
//     a producer warpgroup and two consumer warpgroups (below);
//   * float32 (the tiny config's card-vs-CPU checks, held to 1e-3 of the
//     CPU's logits, which TF32 would break): flash_prefill_kernel, which
//     multiplies on the CUDA cores in float32 with 64-row tiles.
//
// The walk (both kernels; T = the tile: 128 keys and query rows in bf16, 64
// in float32). One block per (query tile, query head, batch). In the square
// form it walks key tiles only up to the diagonal, by index: valid positions
// form an ascending prefix, so a key after the query's index is later or
// invalid. The upper triangle costs neither loads nor FLOPs. The rectangular
// form has no shared index: its walk ends at ceil(min(k_hi, Sk) / T) tiles,
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
// added nothing. Query tiles launch from the last to the first (blockIdx.x 0
// is the last tile): causally the last tiles walk the most key tiles; under a
// window every tile past W / T walks the same ~W / T + 1 tiles, and they
// launch first, followed by the shorter ones in decreasing length.
//
// The bf16 kernel (sm_90a). 384 threads: warpgroup 0 is the producer, whose
// one thread issues every load; it gives its registers up (setmaxnreg 24) to
// warpgroups 1 and 2, the consumers (setmaxnreg 240), each of which owns 64
// of the tile's 128 query rows.
//   * Loads: TMA over 4-D tensor maps (d, s, head, batch) built on the host
//     per launch from the caller's strides (v arrives as a transposed view),
//     128-byte swizzle, boxes of 64 columns x 128 rows (d = 128 takes two per
//     tile). Rows past the tensor arrive as zeros. Q once; K and V into a
//     ring of kStages stages, each with a K-full, a V-full and an empty
//     mbarrier, so S = Q K^T starts before V lands and the next tile loads
//     while this one is consumed. d = 128: Q 32 KB + 2 x (K 32 + V 32) = 160
//     KB of shared memory, one block per SM.
//   * S = Q K^T: wgmma m64n128k16, bf16 inputs from shared memory (both
//     K-major), float32 accumulator: 64 scores a thread, the Pallas kernel's
//     numerics (preferred_element_type=float32).
//   * Mask only where needed: a warp applies the compare only if one of its
//     rows may miss a key of the tile: the tile runs past Sk, its last key
//     lies above the row's position (the diagonal; keys at or past the count,
//     which carry 2^30; the end of a rectangular walk; rows whose positions
//     lie below the tile, such as the zero tail of a post-TSP layout), or
//     under a window its first key lies at or below the row's qpos - W. The
//     test reads two positions a tile, holds for any ascending valid prefix,
//     and interior tiles skip the compare.
//   * Online softmax in registers, float32, exp2 of logits prescaled by
//     scale * log2(e). P is rounded to bf16 in registers, as the reference
//     rounds it before P.V, and is wgmma's A operand straight from registers
//     (the accumulator's fragment layout is the A fragment's); l sums the
//     unrounded P.
//   * O += P V: wgmma m64n{d}k16, V from shared memory as an MN-major
//     (transposed) B operand. Epilogue: o / l, 0 where l = 0; rows past Sq
//     write nothing.
//   * The two consumer warpgroups take turns (two named barriers) to issue
//     S = Q K^T, which keeps them half a tile apart: one's softmax runs while
//     the other's products keep the tensor cores busy (against letting them
//     run in step: 3% faster on the square form at s = 8192, 7% under
//     Ministral's window; kernels/flash_probe.py A/B on the H100).
//
// Fused window scores (a template flag, square form only). The scores of
// query head h are, for each key j,
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
//     diagonal) last, with or without a window (the band skip never drops
//     it: the diagonal's last key is a valid key at or after the tile's first
//     query, or invalid). After that tile's attention update the block's Q
//     shared memory is free: it stages the window rows there as float32, 64
//     at a time, and scores them on the CUDA cores in float32 against the K
//     tile still resident (read through its swizzle in the bf16 kernel); the
//     stage goes back to the producer only after that. Each key tile is
//     scored exactly once, by the block whose diagonal it is, and no block
//     waits for another; every strip column [0, Sk) is written exactly once,
//     columns at or past the count as masked (-inf).
//   * the raw masked logits go to a float32 strip [b, H, W, Sk] in device
//     memory, and window_scores_finish turns it into scores [b, H, Sk] in two
//     kernels: window_row_stats_kernel (a warp per window row: its max and
//     1 / sum in one online pass) and window_col_sums_kernel (a block per 256
//     columns of a head: the sum over rows of exp(x - max) / sum). A row that
//     sees no key gives 0.
// It adds 2 W s d FLOP a head (5.4e8 a layer at Llama-3.1-8B, W = 8, s =
// 8192: 0.1% of the attention's) and 2 x 4 W s bytes a head of strip traffic.
//
// Row statistics (a template flag, kAux; square and rectangular forms, not
// with the fused scores): at the epilogue, where each row's running max and
// sum are final, the kernel also writes per row m, the max of scale * q.k in
// natural-log units, and l, the sum of exp(scale * q.k - m), each [B, H, Sq]
// float32; a row that saw no key writes m = -1e30 (the JAX kernel's NEG_INF)
// and l = 0 (its output is 0). The bf16 kernel keeps m in units of scale *
// log2(e) (its exp2 softmax) and multiplies by ln(2) on the way out; l is the
// same in either unit. One lane of a row's quad (bf16) or half warp (float32)
// writes it: 8 bytes a row, nothing against the output's 2 d bytes.
#include <cuda.h>
#include <limits.h>

#include "common.cuh"
#include "sm90.cuh"

namespace {

using fastkv::from_float;
using fastkv::half_warp_max;
using fastkv::half_warp_sum;
using fastkv::round_to;
using fastkv::to_float;

constexpr int kInvalidPos = 1 << 30;
constexpr float kNegInf = -1e30f;  // m of a row that sees no key (JAX's NEG_INF)
constexpr float kLn2 = 0.6931471805599453f;

// The number of key tiles, from the first, that lie wholly below the window
// band of every row of the query tile of kRowsT rows starting at q0 (see the
// note above). Called by all threads of the block; n_kt >= 1 is the same for
// all of them. s_min is scratch for kRowsT / 32 ints in the dynamic shared
// memory.
template <int kRowsT, int kKeysT>
__device__ int tiles_below_band(const int* __restrict__ qpos, const int* __restrict__ kpos,
                                int q0, int Sq, int Sk, int n_kt, int window, int* s_min) {
  const int tid = threadIdx.x;
  if (tid < kRowsT) {
    const int row = q0 + tid;
    const int p = __reduce_min_sync(0xffffffffu, row < Sq ? qpos[row] : INT_MAX);
    if ((tid & 31) == 0) s_min[tid >> 5] = p;
  }
  __syncthreads();
  int lowest = s_min[0];
#pragma unroll
  for (int w = 1; w < kRowsT / 32; ++w) lowest = min(lowest, s_min[w]);
  const long long lo = static_cast<long long>(lowest) - window;
  int below = 0;
  for (int base = 0; base < n_kt; base += blockDim.x) {
    const int t = base + tid;
    const bool out = t < n_kt && kpos[min(t * kKeysT + kKeysT - 1, Sk - 1)] <= lo;
    below += __syncthreads_count(out);
  }
  return below;
}

// Rectangular form: the number of key tiles, of the first n_kt, before the
// first tile whose first key lies above every query position of the query
// tile starting at q0 (see the note above). Called by all threads of the
// block. s_max is scratch for kRowsT / 32 ints, apart from tiles_below_band's.
template <int kRowsT, int kKeysT>
__device__ int tiles_up_to_queries(const int* __restrict__ qpos, const int* __restrict__ kpos,
                                   int q0, int Sq, int n_kt, int* s_max) {
  const int tid = threadIdx.x;
  if (tid < kRowsT) {
    const int row = q0 + tid;
    const int p = __reduce_max_sync(0xffffffffu, row < Sq ? qpos[row] : -1);
    if ((tid & 31) == 0) s_max[tid >> 5] = p;
  }
  __syncthreads();
  int highest = s_max[0];
#pragma unroll
  for (int w = 1; w < kRowsT / 32; ++w) highest = max(highest, s_max[w]);
  int seen = 0;
  for (int base = 0; base < n_kt; base += blockDim.x) {
    const int t = base + tid;
    seen += __syncthreads_count(t < n_kt && kpos[t * kKeysT] <= highest);
  }
  return seen;
}

// ---------------------------------------------------------------------------
// float32: the CUDA-core kernel (64-row tiles)
// ---------------------------------------------------------------------------

constexpr int kBlockQ = 64;  // query rows per block
constexpr int kBlockK = 64;  // keys per tile (== kBlockQ: the diagonal tile is qt)
constexpr int kThreads = 256;
constexpr int kRows = 4;  // query rows per thread: 16 row groups x 4
constexpr int kCols = 4;  // key columns per thread: 16 lanes x 4, stride 16

// Q and K tiles staged as float32 (rows padded by one word, so column walks
// hit distinct banks); each of the 256 threads owns a 4x4 piece of the 64x64
// score tile and a 4 x d/16 piece of the output accumulator. At d = 128 a
// block takes 115,712 bytes, so two blocks share an SM.
template <int D>
struct Smem {
  static constexpr int kStride = D + 1;         // Q and K row stride
  static constexpr int kPStride = kBlockK + 1;  // P row stride
  static constexpr int kFloats =
      kBlockQ * kStride + kBlockK * kStride + kBlockK * D + kBlockQ * kPStride;
  static constexpr size_t kBytes = kFloats * sizeof(float) + kBlockK * sizeof(int);
};

template <typename T, int D, bool kWindow, bool kRect, bool kScores, bool kAux>
__global__ void __launch_bounds__(kThreads) flash_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ qpos, const int* __restrict__ kpos, const int* __restrict__ khi,
    T* __restrict__ out, int H, int group, int Sq, int Sk_arg, int window, long long q_sb,
    long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb, long long v_sh,
    long long v_ss, float scale, const T* __restrict__ wq, const int* __restrict__ wpos,
    float* __restrict__ strip, int W, long long wq_sb, long long wq_sh, long long wq_sw,
    float* __restrict__ m_out, float* __restrict__ l_out) {
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
    n_kt = tiles_up_to_queries<kBlockQ, kBlockK>(qpos + b * Sq, kpos + b * Sk, q0, Sq, hi,
                                                 sKpos + kBlockQ / 32);
  } else {
    n_kt = min((Sk + kBlockK - 1) / kBlockK, qt + 1);
  }
  int kt0 = 0;
  if constexpr (kWindow)
    kt0 = tiles_below_band<kBlockQ, kBlockK>(qpos + b * Sq, kpos + b * Sk, q0, Sq, Sk, n_kt,
                                             window, sKpos);
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
      if constexpr (kAux) {
        if (tx == 0) {  // m and l are the same in the 16 lanes of the row
          const long long i = (static_cast<long long>(b) * H + h) * Sq + row;
          m_out[i] = m[r] == -INFINITY ? kNegInf : m[r];
          l_out[i] = l[r];
        }
      }
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


// ---------------------------------------------------------------------------
// bfloat16: the tensor-core kernel (sm_90a)
// ---------------------------------------------------------------------------

namespace ws {

constexpr int kTile = 128;         // query rows per block, keys per tile
constexpr int kThreads = 384;      // producer warpgroup + two consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr int kStages = 2;         // K/V ring depth
constexpr int kProducerRegs = 24;  // setmaxnreg: 128 x 24 + 256 x 240 <= 65,536
constexpr int kConsumerRegs = 240;
constexpr int kScoreRows = 64;  // window rows staged (as float32) per group
constexpr int kConsumerBarrier = 1;  // named barrier of the two consumer warpgroups
constexpr int kTurnBarrier = 2;  // + consumer warpgroup: its turn to issue S = Q K^T

// Dynamic shared memory, from a 1024-byte aligned base (the 128-byte swizzle
// repeats every 1024 bytes, and wgmma's descriptors assume that phase):
// Q | K[kStages] | V[kStages] | mbarriers | scratch ints. D is the q/k width,
// DV the v width (DV < D: MLA's 192 / 128, 208 KB).
template <int D, int DV = D>
struct Layout {
  static constexpr int kHalves = D / 64;          // 64-column swizzled boxes per q/k row
  static constexpr int kVHalves = DV / 64;        // and per v row
  static constexpr int kHalfBytes = kTile * 128;  // 128 rows x 64 bf16
  static constexpr int kTileBytes = kHalves * kHalfBytes;
  static constexpr int kVTileBytes = kVHalves * kHalfBytes;
  static constexpr int kQ = 0;
  static constexpr int kK = kTileBytes;
  static constexpr int kV = kK + kStages * kTileBytes;
  static constexpr int kBar = kV + kStages * kVTileBytes;
  static constexpr int kNumBars = 1 + 3 * kStages;  // Q, then K-full, V-full, empty per stage
  static constexpr int kScratch = kBar + 8 * kNumBars;
  static constexpr int kScratchInts = 2 * kTile / 32;  // tiles_below_band's, tiles_up_to_queries'
  static constexpr size_t kBytes = kScratch + 4 * kScratchInts + 1024;  // + alignment slack
  // the window rows of the fused scores, float32, fit where Q was
  static_assert(kScoreRows * D * 4 <= kTileBytes, "window rows must fit in Q's place");
};

// The fused scores for the diagonal key tile (keys k0 .. k0 + 127, resident
// in sK): the W window rows against each key, raw masked logits into the
// strip. Run by the 256 consumer threads after both warpgroups finished
// reading Q, whose shared memory (sQw) takes the rows as float32, 64 at a
// time. Thread t scores key t % 128 against rows t / 128, t / 128 + 2, ... of
// each group of 8.
template <int D>
__device__ void score_window_rows(const uint8_t* sK, float* sQw, const __nv_bfloat16* wqb,
                                  long long wq_sw, const int* wpos, const int* kp, float* sb,
                                  int k0, int Sk, int W, float scale, int ctid) {
  using L = Layout<D>;
  const int key = ctid & (kTile - 1);
  const int rsel = ctid >> 7;
  const bool key_in = k0 + key < Sk;
  const int kpos_key = key_in ? kp[k0 + key] : kInvalidPos;
  for (int w0 = 0; w0 < W; w0 += kScoreRows) {
    const int nw = min(kScoreRows, W - w0);
    sm90::named_barrier_sync(kConsumerBarrier, kConsumerThreads);  // sQw is free
    for (int i = ctid; i < kScoreRows * D; i += kConsumerThreads) {
      const int r = i / D, c = i % D;
      sQw[i] = r < nw ? __bfloat162float(wqb[(w0 + r) * wq_sw + c]) : 0.f;
    }
    sm90::named_barrier_sync(kConsumerBarrier, kConsumerThreads);
    for (int rg = 0; rg < nw; rg += 8) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int c8 = 0; c8 < D / 8; ++c8) {
        // 8 dims of the key's K row: 16 bytes at the row's swizzled chunk
        const uint8_t* src =
            sK + (c8 >> 3) * L::kHalfBytes + sm90::swizzle_128b_offset(key, (c8 & 7) * 8);
        const uint4 raw = *reinterpret_cast<const uint4*>(src);
        const __nv_bfloat162* kv2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
        float kf[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(kv2[e]);
          kf[2 * e] = f.x;
          kf[2 * e + 1] = f.y;
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float* qr = sQw + (rg + rsel + 2 * t) * D + c8 * 8;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[t] = fmaf(qr[e], kf[e], acc[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int r = rg + rsel + 2 * t;
        if (r < nw && key_in) {
          const int pw = wpos[w0 + r];
          const bool ok = pw >= 0 && kpos_key <= pw;
          sb[static_cast<long long>(w0 + r) * Sk + k0 + key] = ok ? acc[t] * scale : -INFINITY;
        }
      }
    }
  }
}

template <int D, int DV, bool kWindow, bool kRect, bool kScores, bool kAux>
__global__ void __launch_bounds__(kThreads, 1) flash_prefill_sm90_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ qpos,
    const int* __restrict__ kpos, const int* __restrict__ khi, __nv_bfloat16* __restrict__ out,
    int H, int group, int Sq, int Sk_arg, int window, float scale, float scale_log2,
    const __nv_bfloat16* __restrict__ wq, const int* __restrict__ wpos,
    float* __restrict__ strip, int W, long long wq_sb, long long wq_sh, long long wq_sw,
    float* __restrict__ m_out, float* __restrict__ l_out) {
  static_assert(!(kScores && kAux), "row statistics and fused scores do not go together");
  using L = Layout<D, DV>;
  constexpr int kOut = DV / 2;  // output accumulator floats per consumer thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sm + L::kBar);
  uint64_t* k_full = bar_q + 1;
  uint64_t* v_full = k_full + kStages;
  uint64_t* empty = v_full + kStages;
  int* s_scratch = reinterpret_cast<int*>(sm + L::kScratch);

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest query tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kTile;
  const int tid = threadIdx.x;
  const int Sk = kRect ? Sk_arg : Sq;  // the square form has one extent
  const int* qp = qpos + static_cast<long long>(b) * Sq;
  const int* kp = kpos + static_cast<long long>(b) * Sk;

  if (tid == 0) {
    sm90::mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&k_full[s], 1);
      sm90::mbar_init(&v_full[s], 1);
      sm90::mbar_init(&empty[s], kConsumerThreads);
    }
    sm90::fence_barrier_init();
  }
  // the key tiles this query tile walks, [kt0, n_kt) (their passes end in a
  // block-wide barrier, which also publishes the mbarriers)
  int n_kt;
  if constexpr (kRect) {
    const int hi = (khi[b] + kTile - 1) / kTile;  // the wrapper clamps k_hi to [0, Sk]
    n_kt = tiles_up_to_queries<kTile, kTile>(qp, kp, q0, Sq, hi, s_scratch + kTile / 32);
  } else {
    n_kt = min((Sk + kTile - 1) / kTile, qt + 1);
  }
  int kt0 = 0;
  if constexpr (kWindow)
    kt0 = tiles_below_band<kTile, kTile>(qp, kp, q0, Sq, Sk, n_kt, window, s_scratch);
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      sm90::prefetch_tensormap(&tm_q);
      sm90::prefetch_tensormap(&tm_k);
      sm90::prefetch_tensormap(&tm_v);
      sm90::mbar_arrive_expect_tx(bar_q, L::kTileBytes);
#pragma unroll
      for (int hf = 0; hf < L::kHalves; ++hf)
        sm90::tma_load_4d(sm + L::kQ + hf * L::kHalfBytes, &tm_q, bar_q, hf * 64, q0, h, b);
      const int kh = h / group;
      for (int kt = kt0, i = 0; kt < n_kt; ++kt, ++i) {
        const int stage = i % kStages;
        sm90::mbar_wait(&empty[stage], ((i / kStages) & 1) ^ 1);
        uint8_t* sK = sm + L::kK + stage * L::kTileBytes;
        uint8_t* sV = sm + L::kV + stage * L::kVTileBytes;
        sm90::mbar_arrive_expect_tx(&k_full[stage], L::kTileBytes);
#pragma unroll
        for (int hf = 0; hf < L::kHalves; ++hf)
          sm90::tma_load_4d(sK + hf * L::kHalfBytes, &tm_k, &k_full[stage], hf * 64, kt * kTile,
                            kh, b);
        sm90::mbar_arrive_expect_tx(&v_full[stage], L::kVTileBytes);
#pragma unroll
        for (int hf = 0; hf < L::kVHalves; ++hf)
          sm90::tma_load_4d(sV + hf * L::kHalfBytes, &tm_v, &v_full[stage], hf * 64, kt * kTile,
                            kh, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int ctid = tid - 128;
    const int cw = ctid >> 7;  // consumer warpgroup
    const int lane = ctid & 31;
    const int row0 = q0 + cw * 64 + ((ctid & 127) >> 5) * 16 + (lane >> 2);  // and row0 + 8
    const int row1 = row0 + 8;
    const int pq0 = row0 < Sq ? qp[row0] : -1;  // rows past Sq see nothing
    const int pq1 = row1 < Sq ? qp[row1] : -1;
    const int lo0 = kWindow ? pq0 - window : 0;  // pq >= -1 and window >= 1: no overflow
    const int lo1 = kWindow ? pq1 - window : 0;
    const int pq_min = min(pq0, pq1);
    const int lo_max = max(lo0, lo1);

    float m0 = -INFINITY, m1 = -INFINITY;  // running max, in scale * log2(e) units
    float l0 = 0.f, l1 = 0.f;
    float o[kOut];
#pragma unroll
    for (int i = 0; i < kOut; ++i) o[i] = 0.f;

    const uint32_t q_base = sm90::smem_u32(sm + L::kQ) + cw * 64 * 128;
    sm90::mbar_wait(bar_q, 0);
    // the two warpgroups take turns to issue S = Q K^T (warpgroup 0 first),
    // so that one's softmax runs while the other's products keep the tensor
    // cores busy; each turn is handed over once per tile
    if (cw == 1 && kt0 < n_kt) sm90::named_barrier_arrive(kTurnBarrier, kConsumerThreads);

    for (int kt = kt0, i = 0; kt < n_kt; ++kt, ++i) {
      const int stage = i % kStages;
      const uint32_t parity = (i / kStages) & 1;
      const int k0 = kt * kTile;
      // does any row of this warp miss a key of the tile? (see the note above)
      bool full = k0 + kTile <= Sk && kp[k0 + kTile - 1] <= pq_min;
      if constexpr (kWindow) full = full && kp[k0] > lo_max;
      const bool masked = __any_sync(0xffffffffu, !full);

      const uint32_t k_base = sm90::smem_u32(sm + L::kK + stage * L::kTileBytes);
      const uint32_t v_base = sm90::smem_u32(sm + L::kV + stage * L::kVTileBytes);
      sm90::mbar_wait(&k_full[stage], parity);

      // S = Q K^T: 64 rows x 128 keys, float32, issued in this warpgroup's turn
      float s[64];
      sm90::named_barrier_sync(kTurnBarrier + cw, kConsumerThreads);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk >> 2) * L::kHalfBytes + (kk & 3) * 32;
        sm90::wgmma_ss_m64n128k16(s, sm90::make_desc(q_base + off, 16, 1024),
                                  sm90::make_desc(k_base + off, 16, 1024), kk > 0);
      }
      sm90::wgmma_commit();
      // hand the turn over (warpgroup 1's last hand-over would find no taker)
      if (cw == 0 || kt + 1 < n_kt)
        sm90::named_barrier_arrive(kTurnBarrier + 1 - cw, kConsumerThreads);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);

      // register i holds row (i / 2) % 2 ? row1 : row0, key 8 (i / 4) + 2 (lane % 4) + i % 2
      if (masked) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + 8 * j + 2 * (lane & 3) + e;
            const int kpk = key < Sk ? kp[key] : kInvalidPos;
            bool ok0 = kpk <= pq0, ok1 = kpk <= pq1;
            if constexpr (kWindow) {
              ok0 = ok0 && kpk > lo0;
              ok1 = ok1 && kpk > lo1;
            }
            if (!ok0) s[4 * j + e] = -INFINITY;
            if (!ok1) s[4 * j + 2 + e] = -INFINITY;
          }
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {  // the 4 lanes of a row
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
      }
      const float mn0 = fmaxf(m0, mx0 * scale_log2);
      const float mn1 = fmaxf(m1, mx1 * scale_log2);
      const bool none0 = mn0 == -INFINITY, none1 = mn1 == -INFINITY;  // no visible key yet
      const float corr0 = none0 ? 1.f : exp2f(m0 - mn0);
      const float corr1 = none1 ? 1.f : exp2f(m1 - mn1);
      const float sub0 = none0 ? 0.f : mn0, sub1 = none1 ? 0.f : mn1;
      float sum0 = 0.f, sum1 = 0.f;
      uint32_t pa[8][4];  // P as bf16x2 A fragments, one set per 16-key step
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p00 = exp2f(fmaf(s[4 * j], scale_log2, -sub0));
        const float p01 = exp2f(fmaf(s[4 * j + 1], scale_log2, -sub0));
        const float p10 = exp2f(fmaf(s[4 * j + 2], scale_log2, -sub1));
        const float p11 = exp2f(fmaf(s[4 * j + 3], scale_log2, -sub1));
        sum0 += p00 + p01;
        sum1 += p10 + p11;
        pa[j >> 1][(j & 1) * 2] = sm90::pack_bf16x2(p00, p01);
        pa[j >> 1][(j & 1) * 2 + 1] = sm90::pack_bf16x2(p10, p11);
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, x);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, x);
      }
      l0 = l0 * corr0 + sum0;
      l1 = l1 * corr1 + sum1;
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int j = 0; j < kOut / 4; ++j) {
        o[4 * j] *= corr0;
        o[4 * j + 1] *= corr0;
        o[4 * j + 2] *= corr1;
        o[4 * j + 3] *= corr1;
      }

      // O += P V: V's 128 keys in 8 steps of 16, V as the MN-major B operand
      sm90::mbar_wait(&v_full[stage], parity);
      sm90::fence_regs(o);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) {
        const uint64_t db = sm90::make_desc(v_base + kk * 16 * 128, L::kHalfBytes, 1024);
        if constexpr (DV == 128)
          sm90::wgmma_rs_m64n128k16_tb(o, pa[kk], db, 1);
        else
          sm90::wgmma_rs_m64n64k16_tb(o, pa[kk], db, 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) sm90::fence_regs(pa[kk]);

      // the fused scores read the last K tile after the walk: its stage goes
      // back only then
      if (!kScores || kt + 1 < n_kt) sm90::mbar_arrive(&empty[stage]);
    }

    if constexpr (kScores) {
      // the walk ended at the diagonal (kt = qt): score the window rows
      // against the K tile still resident, then release its stage
      const int stage = (n_kt - kt0 - 1) % kStages;
      score_window_rows<D>(sm + L::kK + stage * L::kTileBytes,
                           reinterpret_cast<float*>(sm + L::kQ), wq + b * wq_sb + h * wq_sh, wq_sw,
                           wpos + static_cast<long long>(b) * W, kp,
                           strip + (static_cast<long long>(b) * H + h) * W * Sk, qt * kTile, Sk, W,
                           scale, ctid);
      sm90::mbar_arrive(&empty[stage]);
    }

    // epilogue: O / l, a row that saw no key writes 0; rows past Sq nothing
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
    const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    __nv_bfloat16* ob = out + (static_cast<long long>(b) * H + h) * Sq * DV + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < kOut / 4; ++j) {
      if (row0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<long long>(row0) * DV + 8 * j) =
            __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (row1 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<long long>(row1) * DV + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
    if constexpr (kAux) {
      // the row statistics: m, l are the same in the 4 lanes of a row's quad
      if ((lane & 3) == 0) {
        const long long base = (static_cast<long long>(b) * H + h) * Sq;
        if (row0 < Sq) {
          m_out[base + row0] = m0 == -INFINITY ? kNegInf : m0 * kLn2;
          l_out[base + row0] = l0;
        }
        if (row1 < Sq) {
          m_out[base + row1] = m1 == -INFINITY ? kNegInf : m1 * kLn2;
          l_out[base + row1] = l1;
        }
      }
    }
  }
}

}  // namespace ws

// The fused scores' finishing pass, in two kernels over the strip [b, H, W,
// Sk] of raw masked logits. Memory-bound and small (8.4 MB of strip at
// Llama-3.1-8B, s = 8192, W = 8: ~2.8 us at 3.35 TB/s): each reads the strip
// once, and both spread it over many warps (256 rows' warps, then a block per
// 256 columns of each head).
// With one warp a row, the row kernel keeps its loads in flight in registers
// (64 values a lane) so that a 32 KB row takes four round trips to memory.

// Merge a chunk of a row's values into a lane's running (max, sum of
// exp(x - max)): the chunk's max first, then one exp per value.
template <int N>
__device__ __forceinline__ void merge_chunk(const float (&x)[N], float& m, float& s) {
  float cm = x[0];
#pragma unroll
  for (int u = 1; u < N; ++u) cm = fmaxf(cm, x[u]);
  if (cm == -INFINITY) return;  // nothing visible in this chunk
  const float mn = fmaxf(m, cm);
  float cs = 0.f;
#pragma unroll
  for (int u = 0; u < N; ++u) cs += expf(x[u] - mn);
  s = s * expf(m - mn) + cs;  // m = -inf: exp gives 0
  m = mn;
}

// One warp per (window row, head, batch): the row's max and 1 / sum of
// exp(x - max), in one pass with 64 values a lane in flight (16-byte loads
// where the row allows them), the lanes merged at the end. A row that sees
// no key gets (-inf, 0).
__global__ void window_row_stats_kernel(const float* __restrict__ strip,
                                        float2* __restrict__ stats, int rows, int Sk) {
  constexpr int kVec = 16;  // float4 loads per lane per step
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= rows) return;
  const float* row = strip + static_cast<long long>(warp) * Sk;
  float m = -INFINITY, s = 0.f;
  if ((Sk & 3) == 0) {  // rows start 16-byte aligned
    const float4* row4 = reinterpret_cast<const float4*>(row);
    const int n4 = Sk >> 2;
    for (int base = 0; base < n4; base += 32 * kVec) {
      float x[4 * kVec];
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        const int i = base + 32 * u + lane;
        const float4 v = i < n4 ? row4[i] : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
        x[4 * u] = v.x;
        x[4 * u + 1] = v.y;
        x[4 * u + 2] = v.z;
        x[4 * u + 3] = v.w;
      }
      merge_chunk(x, m, s);
    }
  } else {
    for (int base = 0; base < Sk; base += 32 * 4 * kVec) {
      float x[4 * kVec];
#pragma unroll
      for (int u = 0; u < 4 * kVec; ++u) {
        const int i = base + 32 * u + lane;
        x[u] = i < Sk ? row[i] : -INFINITY;
      }
      merge_chunk(x, m, s);
    }
  }
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    const float mn = fmaxf(m, m2);
    s = (m == -INFINITY ? 0.f : s * expf(m - mn)) + (m2 == -INFINITY ? 0.f : s2 * expf(m2 - mn));
    m = mn;
  }
  if (lane == 0) stats[warp] = make_float2(m, s > 0.f ? 1.f / s : 0.f);
}

// One block per 256 columns of one (head, batch): per column the sum over
// the W rows of exp(x - max) / sum.
__global__ void window_col_sums_kernel(const float* __restrict__ strip,
                                       const float2* __restrict__ stats,
                                       float* __restrict__ scores, int H, int W, int Sk) {
  extern __shared__ float2 s_stats[];  // [W]
  const long long bh = static_cast<long long>(blockIdx.z) * H + blockIdx.y;
  for (int w = threadIdx.x; w < W; w += blockDim.x) s_stats[w] = stats[bh * W + w];
  __syncthreads();
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= Sk) return;
  const float* sb = strip + bh * W * Sk + col;
  float acc = 0.f;
  for (int w = 0; w < W; ++w) {
    const float2 st = s_stats[w];
    if (st.x != -INFINITY) acc += expf(sb[static_cast<long long>(w) * Sk] - st.x) * st.y;
  }
  scores[bh * Sk + col] = acc;
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
  void *m_out, *l_out;
  cudaStream_t stream;
};

template <typename T, int D, bool kWindow, bool kRect, bool kScores, bool kAux>
cudaError_t launch(const Args& a) {
  constexpr size_t smem = Smem<D>::kBytes;
  auto kernel = flash_prefill_kernel<T, D, kWindow, kRect, kScores, kAux>;
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
      a.W, a.wq_sb, a.wq_sh, a.wq_sw, static_cast<float*>(a.m_out), static_cast<float*>(a.l_out));
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled from the driver, found through the runtime so that
// the library needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map (d, rows, heads, batch) over a bf16 tensor with unit stride along
// d and the given element strides, read in boxes of 64 x 128 x 1 x 1 with the
// 128-byte swizzle. TMA needs a 16-byte aligned base and strides that are
// multiples of 16 bytes: the wrapper checks both and raises before calling.
cudaError_t make_map(CUtensorMap* map, const void* base, int D, int rows, int heads, int batch,
                     long long s_rows, long long s_heads, long long s_batch) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(base) % 16 || s_rows % 8 || s_heads % 8 || s_batch % 8)
    return cudaErrorInvalidValue;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_rows) * 2,
                                 static_cast<cuuint64_t>(s_heads) * 2,
                                 static_cast<cuuint64_t>(s_batch) * 2};
  const cuuint32_t box[4] = {64, ws::kTile, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D, int DV, bool kWindow, bool kRect, bool kScores, bool kAux>
cudaError_t launch_sm90(const Args& a) {
  constexpr size_t smem = ws::Layout<D, DV>::kBytes;
  auto kernel = ws::flash_prefill_sm90_kernel<D, DV, kWindow, kRect, kScores, kAux>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if ((err = make_map(&tq, a.q, D, a.Sq, a.H, a.B, a.q_ss, a.q_sh, a.q_sb)) != cudaSuccess ||
      (err = make_map(&tk, a.k, D, a.Sk, a.KH, a.B, a.k_ss, a.k_sh, a.k_sb)) != cudaSuccess ||
      (err = make_map(&tv, a.v, DV, a.Sk, a.KH, a.B, a.v_ss, a.v_sh, a.v_sb)) != cudaSuccess)
    return err;
  const dim3 grid((a.Sq + ws::kTile - 1) / ws::kTile, a.H, a.B);
  const float log2e = 1.4426950408889634f;
  kernel<<<grid, ws::kThreads, smem, a.stream>>>(
      tq, tk, tv, static_cast<const int*>(a.qpos), static_cast<const int*>(a.kpos),
      static_cast<const int*>(a.khi), static_cast<__nv_bfloat16*>(a.out), a.H, a.H / a.KH, a.Sq,
      a.Sk, a.window, a.scale, a.scale * log2e, static_cast<const __nv_bfloat16*>(a.wq),
      static_cast<const int*>(a.wpos), static_cast<float*>(a.strip), a.W, a.wq_sb, a.wq_sh,
      a.wq_sw, static_cast<float*>(a.m_out), static_cast<float*>(a.l_out));
  return cudaGetLastError();
}

// the form's instantiation, chosen at launch: rectangular (a k_hi array),
// fused scores (window rows), or the square causal one; the rectangular and
// square ones with or without row statistics (m_out); each with or without
// the window
template <typename T, int D, bool kRect, bool kScores, bool kAux>
cudaError_t launch_window(const Args& a) {
  return a.window > 0 ? launch<T, D, true, kRect, kScores, kAux>(a)
                      : launch<T, D, false, kRect, kScores, kAux>(a);
}

template <typename T, int D>
cudaError_t launch_form(const Args& a) {
  const bool aux = a.m_out != nullptr;
  if (a.khi != nullptr)
    return aux ? launch_window<T, D, true, false, true>(a) : launch_window<T, D, true, false, false>(a);
  if (a.wq != nullptr) return launch_window<T, D, false, true, false>(a);
  return aux ? launch_window<T, D, false, false, true>(a) : launch_window<T, D, false, false, false>(a);
}

template <int D, bool kRect, bool kScores, bool kAux>
cudaError_t launch_window_sm90(const Args& a) {
  return a.window > 0 ? launch_sm90<D, D, true, kRect, kScores, kAux>(a)
                      : launch_sm90<D, D, false, kRect, kScores, kAux>(a);
}

template <int D>
cudaError_t launch_form_sm90(const Args& a) {
  const bool aux = a.m_out != nullptr;
  if (a.khi != nullptr)
    return aux ? launch_window_sm90<D, true, false, true>(a)
               : launch_window_sm90<D, true, false, false>(a);
  if (a.wq != nullptr) return launch_window_sm90<D, false, true, false>(a);
  return aux ? launch_window_sm90<D, false, false, true>(a)
             : launch_window_sm90<D, false, false, false>(a);
}

}  // namespace

// q [B, H, Sq, D], k/v [B, KH, Sk, D] with unit stride along D (other strides
// in elements; bf16: a 16-byte aligned base and strides that are multiples of
// 8 elements, for TMA); qpos [B, Sq] and kpos [B, Sk] int32 contiguous; out
// [B, H, Sq, D] contiguous; window: the sliding window W >= 1, or 0 for none.
// khi: null for the square form (Sq == Sk, key tiles walked up to the
// diagonal), or a device array [B] int32 of k_hi values in [0, Sk] for the
// rectangular form (key tiles from ceil(k_hi / T) on are neither loaded nor
// computed; the wrapper has folded keys at or beyond k_hi into kpos as
// invalid, so the result does not depend on the tiling).
// Fused window scores (square form only; null wq for none): wq [B, H, W, D]
// window query rows with unit stride along D, wpos [B, W] int32 contiguous
// (-1: a row that scores nothing), strip [B, H, W, Sk] float32 contiguous,
// written whole; window_scores_finish then turns it into scores [B, H, Sk].
// Row statistics (null m_out and l_out for none; not with wq): m_out and
// l_out [B, H, Sq] float32 contiguous, each row's max scaled logit (natural
// log units; -1e30 where the row sees no key) and sum of exp(logit - max).
// v_dim: v's width, head_dim (q and k) in every form but one: bf16 q/k 192
// with v 128 (MLA), the square causal form alone (no window, k_hi, fused
// scores or row statistics), out [B, H, Sq, 128].
extern "C" int flash_prefill(int dtype, int head_dim, int v_dim, const void* q, const void* k,
                             const void* v, const void* qpos, const void* kpos,
                             const void* khi, void* out, int B, int H, int KH, int Sq, int Sk,
                             int window, long long q_sb, long long q_sh, long long q_ss,
                             long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                             long long v_sh, long long v_ss, float scale, const void* wq,
                             const void* wpos, void* strip, int W, long long wq_sb,
                             long long wq_sh, long long wq_sw, void* m_out, void* l_out,
                             void* stream) {
  if (window < 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((m_out == nullptr) != (l_out == nullptr) || (m_out != nullptr && wq != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool rect = khi != nullptr;
  if (!rect && Sq != Sk) return static_cast<int>(cudaErrorInvalidValue);
  if (wq != nullptr && (rect || W < 1 || wpos == nullptr || strip == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,    k,    v,    qpos, kpos, khi,   out,   B,     H,     KH,    Sq,
               Sk,   window, q_sb, q_sh, q_ss, k_sb,  k_sh,  k_ss,  v_sb,  v_sh,  v_ss,
               scale, wq,  wpos, strip, W,   wq_sb, wq_sh, wq_sw, m_out, l_out,
               static_cast<cudaStream_t>(stream)};
  if (v_dim != head_dim) {
    if (dtype != fastkv::kBFloat16 || head_dim != 192 || v_dim != 128 || rect || wq != nullptr ||
        m_out != nullptr || window != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_sm90<192, 128, false, false, false, false>(a));
  }
  if (dtype == fastkv::kBFloat16 && head_dim == 128) return launch_form_sm90<128>(a);
  if (dtype == fastkv::kBFloat16 && head_dim == 64) return launch_form_sm90<64>(a);
  if (dtype == fastkv::kFloat32 && head_dim == 128) return launch_form<float, 128>(a);
  if (dtype == fastkv::kFloat32 && head_dim == 64) return launch_form<float, 64>(a);
  return static_cast<int>(cudaErrorInvalidValue);
}

// strip [B, H, W, Sk] float32 (as flash_prefill's fused form wrote it) ->
// scores [B, H, Sk] float32, both contiguous, through stats [B, H, W] float2
// (scratch: each row's max and 1 / sum). Two kernel launches.
extern "C" int window_scores_finish(const void* strip, void* stats, void* scores, int B, int H,
                                    int W, int Sk, void* stream) {
  const size_t smem = sizeof(float2) * static_cast<size_t>(W);
  if (W < 1 || smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = B * H * W;
  window_row_stats_kernel<<<(rows + 7) / 8, 256, 0, st>>>(static_cast<const float*>(strip),
                                                         static_cast<float2*>(stats), rows, Sk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  window_col_sums_kernel<<<dim3((Sk + 255) / 256, H, B), 256, smem, st>>>(
      static_cast<const float*>(strip), static_cast<const float2*>(stats),
      static_cast<float*>(scores), H, W, Sk);
  return static_cast<int>(cudaGetLastError());
}
