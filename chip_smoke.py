#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fastkv_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, each printing one JSON line (any failure raises and exits nonzero):
  build   compile every CUDA kernel from ``fastkv_tpu_torch/kernels/csrc``
          (one nvcc per source, all at once) and print the ptxas report;
          the bf16 flash kernel's twelve instantiations (two head dims x
          six forms) and the decode kernel's eight bf16 and int8 ones (two
          head dims x bf16/int8 cache x with/without its window term) must
          show no spills;
  kernels_vs_plain
          each kernel against its plain PyTorch version (float32, on float32
          copies of the same inputs) on the card, at the shapes the
          Llama-3.1-8B and Ministral-8B main paths give it (and at
          Llama-3.2-1B width for the prefill kernel), bf16, each output row
          held to its own scale (``fastkv_tpu_torch/kernels/agreement.py``);
          the prefill kernel also under sliding windows (Ministral's s =
          40960 with W = 32768, s = 8192 with W = 1024, a float32 ragged
          batch, scattered post-TSP positions) and in its rectangular form
          (a chunk of queries against a longer key scratch with a k_hi gate,
          as chunked admission calls it: Llama-3.1-8B chunks at two offsets,
          one with poisoned slots past its gate, Ministral's window, a
          float32 ragged batch), the decode kernel also on Ministral's FullKV
          cache under the window's rank cut, on SnapKV's per-query-head cache
          and at batch 4 with per-example masks;
  tiny_card_vs_cpu
          the tiny config in float32, without and with a sliding window:
          FastKV (maxpool) prefill and Engine.generate, and the Scheduler
          with chunked admission for FastKV and SnapKV, on the card against
          the port on the CPU;
  full_width_<method>
          Engine.generate at Llama-3.1-8B width (random bf16 weights made on
          the card from a seed, one 8192-token prompt, 32 new tokens) for
          FullKV and FastKV at the canonical settings, after a warm-up of a
          prefill and four decode steps; every launch counter is set to 0
          just before the first generate and read just after, and both
          kernels must have launched; four more generates per method, the
          methods alternating, give the median and spread of prefill seconds
          and decode ms per token, each window with this thread's CPU share,
          involuntary context switches and garbage-collector seconds, and
          two probes of the host's speed taken just before it;
  profile_<method>
          one prefill and eight decode steps under torch.profiler: host ms,
          device-busy ms, idle share and the top kernels;
  full_width_ministral_<method>, full_width_nemo_<method>
          Engine.generate once per method at Ministral-8B width (36 layers,
          a 32768-token sliding window on every layer, one 40960-token
          prompt, FastKV tsp_idx 17) and at Mistral-Nemo-12B width (40
          layers, no window, query width 4096 over a hidden size of 5120,
          one 8192-token prompt, tsp_idx 19), 32 new tokens, each with its
          launch counts (counters set to 0 just before it, read just after),
          prefill seconds, decode ms per token and peak memory, then one
          prefill and eight decode steps under the profiler; each model's
          weights are freed before the next one is made;
  serve_<method>
          the continuous-batching Scheduler at Llama-3.1-8B width (random
          bf16 weights from a seed): four decode slots, bucket 8192, six
          requests of 2500-8192 tokens with budgets of 8-32 tokens; the first
          four admit at once, the last two chunk-wise (2048-token chunks)
          while the others decode; FastKV, FullKV, SnapKV and StreamingLLM,
          and FastKV once more with monolithic admission. Each run counted
          (counters set to 0 just before it, read just after), with its
          event counts, per-request TTFT and TPOT, the inter-token gaps of
          running requests, wall seconds and peak memory;
  profile_serve
          a batch-4 decode step, the last chunk of an 8000-token admission
          and its finish under the profiler;
  total   the seconds the script took, the build included;
  kernels one line with each kernel's launches (over every counted
          generate), error, time at the main-path shape, its bound, the plain
          version's time and one PyTorch library call's time for the same
          function (a yardstick only: the port never calls it); the prefill
          kernel's entry also carries the same readings under Ministral-8B's
          window (``window``), in its rectangular form at Llama-3.1-8B's
          last 2048-token chunk of an 8192-slot scratch (``rect``) and in
          its fused-scores form (``scores``, with its finishing pass), each
          flash form and the finishing pass with its achieved TFLOP/s and
          its share of its bound; the decode entry is FastKV's cache at
          Llama-3.1-8B (b = 1, C = 1032) and carries the int8 cache at that
          shape (``int8``), SnapKV's at batch 4 (``snapkv_b4``), FullKV's
          (``fullkv_C8320``), Ministral-8B's FullKV cache under the rank cut
          (``ministral_rank_cut_C41088``) and its own window term on that
          cache (``window``), each with its split, its bound, its share of
          it by device time and, where sdpa computes the same function,
          whether it is at or below sdpa's device time.
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

from fastkv_tpu_torch.kernels.timing import (PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_F32_FLOPS,
                                             events_ms, graph_ms, layer_sdpa, ptxas_spills)

SEED = 0
# the kernels' names in profiler windows (device_ms): the bf16 flash kernel,
# and the finishing pass's two kernels
FLASH_BF16 = "flash_prefill_sm90_kernel"
FINISH = ("window_row_stats_kernel", "window_col_sums_kernel")
# the decode kernel of bf16 q (a bf16 or int8 cache), one launch a call
DECODE_TC = "decode_attn_tc_kernel"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def profile_window(torch, fn, counts=None):
    """Run fn once under the torch profiler. Returns (host ms under the
    profiler, {kernel name: device ms}); the dict is empty where the profiler
    records no device activity. ``counts``, if given, receives {kernel name:
    instances recorded}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    per_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            if counts is not None:
                counts[e.name] = counts.get(e.name, 0) + 1
    return wall_ms, per_kernel


def breakdown(wall_ms, per_kernel, calls=1):
    """Per call: host ms, device-busy ms, idle share and the top kernels;
    device numbers are None ("not measured") if the profiler saw no kernel."""
    busy = sum(per_kernel.values()) if per_kernel else None
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    return {
        "host_ms": wall_ms / calls,
        "device_busy_ms": None if busy is None else busy / calls,
        "idle_share": None if busy is None else 1.0 - busy / wall_ms,
        "top_kernels_ms": [[name[:96], ms / calls] for name, ms in top],
    }


def device_ms(torch, fn, calls, *names, windows=3):
    """(device ms per call, where it came from). From the profiler: for each
    kernel whose name contains one of ``names`` (each launched once a call),
    its mean time per recorded instance, summed. Per instance, because the
    profiler may record fewer instances than were launched. A window in which
    the profiler recorded no device activity at all (seen in about one window
    of three, and in every window of some timings) is taken again, up to
    ``windows`` times; if none recorded anything, CUDA events around ``calls``
    back-to-back calls, which also count the launch gaps between them. A
    window that recorded kernels but none of ``names`` raises: a renamed
    kernel must not pass event time off as its own."""
    for _ in range(windows):
        counts = {}
        _, per_kernel = profile_window(torch, lambda: [fn() for _ in range(calls)], counts)
        if per_kernel:
            break
    else:
        return events_ms(fn, reps=calls, warmup=1), "cuda_events"
    hits = [ms / counts[name] for name, ms in per_kernel.items()
            if any(n in name for n in names)]
    if not hits:
        raise RuntimeError(f"device_ms: the profiler recorded {sorted(per_kernel)[:4]} "
                           f"but no kernel named like {names}")
    return sum(hits), "profiler"


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def flash_inputs(torch, b, H, KH, s, d, count, dtype, gen, scattered=False):
    """q, k, v, positions and counts; ``count`` is one valid count for every
    example or a list of one per example (layout indices only)."""
    dev = "cuda"
    q = torch.randn((b, H, s, d), generator=gen, device=dev).to(dtype)
    # k/v as the strided views qkv_proj hands the kernel
    k = torch.randn((b, s, KH, d), generator=gen, device=dev).to(dtype).transpose(1, 2)
    v = torch.randn((b, s, KH, d), generator=gen, device=dev).to(dtype).transpose(1, 2)
    pos = torch.arange(s, dtype=torch.int32, device=dev)[None].repeat(b, 1)
    if scattered:  # post-TSP layout: ascending original positions, zero tail
        pick = torch.randperm(5 * s, generator=gen, device=dev)[:count].sort().values
        pos[:, :count] = pick.to(torch.int32)
        pos[:, count:] = 0
    if isinstance(count, int):
        cnt = torch.full((b,), count, dtype=torch.int32, device=dev)
    else:
        cnt = torch.tensor(count, dtype=torch.int32, device=dev)
    return q, k, v, pos, cnt


def flash_work(torch, q, k, v, pos, cnt, window=None, kpos=None):
    """(FLOP, bytes) this call needs: 4*d per visible (query, key) pair and
    query head, the pairs counted on this call's mask (causal, and under a
    sliding window only the band's); each input read once and the output
    written once. ``kpos``: the folded key positions of a rectangular call
    (by default those of the square one)."""
    from fastkv_tpu_torch.ops import flash_prefill as fp

    if kpos is None:
        kpos = fp.fold_key_validity(pos, cnt)
    pairs = 0
    for i in range(q.shape[0]):
        srt = kpos[i].sort().values
        qp = pos[i].contiguous()
        seen = torch.searchsorted(srt, qp, right=True)
        if window is not None:  # keys at or below pq - W fall out of the band
            seen = seen - torch.searchsorted(srt, qp - window, right=True)
        pairs += int(seen.sum())
    b, H, s, d = q.shape
    flops = 4 * d * H * pairs
    elt = q.element_size()
    nbytes = elt * (2 * q.numel() + k.numel() + v.numel()) + 4 * (pos.numel() + kpos.numel())
    return flops, nbytes


def rect_inputs(torch, b, H, KH, S, c, d, starts, k_count, k_hi, dtype, gen, poison_from=None):
    """A c-row chunk per example at its offset against an S-slot key scratch,
    as chunked admission hands it to the kernel: q [b, H, c, d], contiguous
    k/v [b, KH, S, d], query positions start + i, key positions the scratch
    indices, per-example key counts and gates. Scratch slots from
    ``poison_from`` on hold large values, which a leaking gate would show."""
    dev = "cuda"
    q = torch.randn((b, H, c, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, KH, S, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, KH, S, d), generator=gen, device=dev).to(dtype)
    if poison_from is not None:
        k[:, :, poison_from:] = 50.0
        v[:, :, poison_from:] = 100.0
    qpos = (torch.tensor(starts, dtype=torch.int32, device=dev)[:, None]
            + torch.arange(c, dtype=torch.int32, device=dev)[None])
    kpos = torch.arange(S, dtype=torch.int32, device=dev)[None].repeat(b, 1)
    cnt = torch.tensor(k_count, dtype=torch.int32, device=dev)
    hi = torch.tensor(k_hi, dtype=torch.int32, device=dev)
    return q, k, v, qpos, kpos, cnt, hi


def window_rows(torch, q, pos, cnt, W):
    """The last W valid query rows of each example and their positions (-1 on
    the rows of a prompt shorter than W), as prefill hands them to the fused
    flash call."""
    from fastkv_tpu_torch.policies.selection import window_indices

    idx, ok = window_indices(cnt - W, W, cnt)
    b, h, _, d = q.shape
    q_win = torch.gather(q, 2, idx[:, None, :, None].expand(b, h, W, d))
    return q_win, torch.where(ok, torch.gather(pos, 1, idx), -1).to(torch.int32).contiguous()


def scores_work(torch, q, kpos, q_win, qw_pos):
    """(FLOP, bytes) the fused scores add to a square flash call: 2*d per
    (window row, key) pair that the strip's mask lets through, per query
    head; the window rows and their positions read once, the scores [b, H,
    s] float32 written once (the strip is the kernel's own)."""
    b, H, W, d = q_win.shape
    pairs = 0
    for i in range(b):
        srt = kpos[i].sort().values
        pw = qw_pos[i].contiguous()
        seen = torch.searchsorted(srt, pw, right=True)
        pairs += int(seen[pw >= 0].sum())
    nbytes = q_win.element_size() * q_win.numel() + 4 * qw_pos.numel() + 4 * b * H * q.shape[2]
    return 2 * d * H * pairs, nbytes


def decode_inputs(torch, L, b, H, CH, C, d, n_kept, dtype, gen):
    """L layers of a cache of C slots: n_kept kept prompt slots scattered over
    the prefill part and 31 decode slots, as after the main path's last step."""
    dev = "cuda"
    q = torch.randn((b, H, 1, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((L, b, CH, C, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((L, b, CH, C, d), generator=gen, device=dev).to(dtype)
    valid = torch.zeros((L, b, CH, C), dtype=torch.bool, device=dev)
    prefill_cap = C - 128
    for l in range(L):
        for i in range(b):
            for h in range(CH):
                keep = torch.randperm(prefill_cap, generator=gen, device=dev)[:n_kept]
                valid[l, i, h, keep] = True
    valid[..., prefill_cap:prefill_cap + 31] = True
    return q, k, v, valid


def bound(flops, nbytes, peak=PEAK_BF16_FLOPS):
    """(bound ms, what bounds it): the larger of the operations over the
    card's peak for the inputs' type (bf16 unless given) and the bytes over
    its memory rate."""
    by_ops = flops / peak >= nbytes / PEAK_BYTES
    return max(flops / peak, nbytes / PEAK_BYTES) * 1e3, ("operations" if by_ops else "bytes")


def rates(flop, ms, bound_ms):
    """Achieved TFLOP/s (the operations the call needs over its time) and
    the share of its bound (bound ms over its time)."""
    return {"tflops": flop / ms / 1e9, "bound_share": bound_ms / ms}


def decode_work(q, k_layer, valid_layer, seen_layer=None, int8=False):
    """(FLOP, bytes) of one decode call: 4*d per seen slot and query head;
    K and V of each seen slot read once (one byte an element in an int8
    cache, plus its two float32 scales), q read and the output written once,
    the mask read. ``seen_layer``: the slots the kernel's own window leaves
    visible (default: the valid ones), whose positions are then read too."""
    b, H, _, d = q.shape
    CH = k_layer.shape[1]
    seen = valid_layer if seen_layer is None else seen_layer
    n_seen = int(seen.sum())  # over (b, CH, C)
    flops = 4 * d * (H // CH) * n_seen
    nbytes = (k_layer.element_size() * 2 * n_seen * d + q.element_size() * 2 * q.numel()
              + valid_layer.numel() + (8 * n_seen if int8 else 0)
              + (0 if seen_layer is None else 4 * int(valid_layer.sum())))
    return flops, nbytes


def phase_kernels_vs_plain(torch):
    from fastkv_tpu_torch.core import quant
    from fastkv_tpu_torch.engine import decode as dm
    from fastkv_tpu_torch.kernels import agreement, build
    from fastkv_tpu_torch.ops import decode_attn as da
    from fastkv_tpu_torch.ops import flash_prefill as fp

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    bf16, f32 = torch.bfloat16, torch.float32
    # The reference is the plain version in float32 on float32 copies of the
    # same inputs. Each output row (one query head and query) is held to its
    # own scale: rms(err) <= row * rms(ref), |err| <= elem * max(|ref|,
    # rms(ref row)), rows that see no key exactly 0. bf16: row 1e-2, elem
    # 2^-5 (bf16 rounding of the output and of P gives ~2e-3 of a row's rms;
    # a dropped 64-key tile or 32-slot chunk moves a row by >= 6%); float32:
    # row 1e-4, elem 1e-3 (summation order only). See kernels/agreement.py.
    cases = []
    flash_lib = build.load("flash_prefill", fp.bind)
    decode_lib = build.load("decode_attn", da.bind)

    def record(kernel, name, shape, dtype, out, ref, **extra):
        r = agreement.compare(out, ref, agreement.TOLERANCES[out.dtype])
        cases.append(dict(kernel=kernel, case=name, shape=shape, dtype=str(dtype), **extra, **r))

    def flash_case(name, b, H, KH, s, d, count, dtype, scattered=False, window=None):
        q, k, v, pos, cnt = flash_inputs(torch, b, H, KH, s, d, count, dtype, gen, scattered)
        out = fp.flash_attention(q, k, v, pos, cnt, window)
        ref = fp.flash_attention_plain(q.float(), k.float(), v.float(), pos, cnt, window)
        record("flash_prefill", name, [b, H, KH, s, d], dtype, out, ref, count=count,
               window=window)

    def rect_case(name, b, H, KH, S, c, d, starts, k_count, k_hi, dtype, window=None,
                  poison_from=None):
        q, k, v, qpos, kpos, cnt, hi = rect_inputs(torch, b, H, KH, S, c, d, starts, k_count,
                                                   k_hi, dtype, gen, poison_from)
        before = fp.rect_launches
        out = fp.flash_attention(q, k, v, qpos, cnt, window, k_positions=kpos, k_count=cnt,
                                 k_hi=hi)
        check(fp.rect_launches == before + 1, f"{name}: the rectangular form did not launch")
        ref = fp.flash_attention_plain(q.float(), k.float(), v.float(), qpos, cnt, window,
                                       kpos, cnt, hi)
        record("flash_prefill", name, [b, H, KH, c, S, d], dtype, out, ref, form="rect",
               starts=starts, k_count=k_count, k_hi=k_hi, window=window)

    def decode_case(name, b, H, CH, C, d, n_kept, dtype, window=None):
        q, k, v, valid = decode_inputs(torch, 1, b, H, CH, C, d, n_kept, dtype, gen)
        attend = dm.window_mask(valid[0], window)  # [b, CH, C]: the rank cut
        out = da.decode_attention(q, k[0], v[0], attend)
        ref = da.decode_attention_plain(q.float(), k[0].float(), v[0].float(), attend)
        record("decode_attn", name, [b, H, CH, C, d], dtype, out, ref, kept=n_kept,
               window=window, attended=int(attend.sum()))

    def scores_case(name, b, H, KH, s, d, count, W, dtype, scattered=False, window=None):
        """The fused form: the attention output at its dtype's limits, and
        the scores (float32, rows [b * H, s]) at float32's, since the strip
        takes the same input values in float32."""
        q, k, v, pos, cnt = flash_inputs(torch, b, H, KH, s, d, count, dtype, gen, scattered)
        q_win, qw_pos = window_rows(torch, q, pos, cnt, W)
        before = (fp.scores_launches, fp.finish_launches)
        out, scores = fp.flash_attention(q, k, v, pos, cnt, window, window_q=q_win,
                                         window_q_pos=qw_pos)
        check((fp.scores_launches, fp.finish_launches) == (before[0] + 1, before[1] + 1),
              f"{name}: the fused form did not launch")
        ref, ref_scores = fp.flash_attention_plain(q.float(), k.float(), v.float(), pos, cnt,
                                                   window, window_q=q_win.float(),
                                                   window_q_pos=qw_pos)
        extra = dict(form="scores", W=W, count=count, window=window)
        record("flash_prefill", name, [b, H, KH, s, d], dtype, out, ref, **extra)
        record("flash_prefill", f"{name}/scores", [b, H, s], dtype, scores, ref_scores, **extra)

    def int8_decode_case(name, b, H, CH, C, d, n_kept, dtype):
        """An int8 cache (quantized as prefill stores it) with its scales."""
        q, k, v, valid = decode_inputs(torch, 1, b, H, CH, C, d, n_kept, dtype, gen)
        ki, ks = quant.quantize_kv(k[0])
        vi, vs = quant.quantize_kv(v[0])
        before = da.int8_launches
        out = da.decode_attention(q, ki, vi, valid[0], k_scale=ks, v_scale=vs)
        check(da.int8_launches == before + 1, f"{name}: the int8 form did not launch")
        ref = da.decode_attention_plain(q.float(), ki, vi, valid[0], k_scale=ks, v_scale=vs)
        record("decode_attn", name, [b, H, CH, C, d], dtype, out, ref, form="int8", kept=n_kept)

    def window_decode_case(name, b, H, CH, C, d, n_kept, dtype, W):
        """The kernel's own window term: slot c's position is c (kept prompt
        slots, then decode slots), the query's the next one after the last
        decode slot."""
        q, k, v, valid = decode_inputs(torch, 1, b, H, CH, C, d, n_kept, dtype, gen)
        k_pos = torch.arange(C, dtype=torch.int32, device="cuda").expand(b, CH, C).contiguous()
        q_pos = torch.full((b,), C - 128 + 31, dtype=torch.int32, device="cuda")
        before = da.window_launches
        out = da.decode_attention(q, k[0], v[0], valid[0], q_pos=q_pos, k_pos=k_pos,
                                  sliding_window=W)
        check(da.window_launches == before + 1, f"{name}: the window form did not launch")
        ref = da.decode_attention_plain(q.float(), k[0].float(), v[0].float(), valid[0], q_pos,
                                        k_pos, W)
        seen = valid[0] & (k_pos > q_pos[:, None, None] - W)
        record("decode_attn", name, [b, H, CH, C, d], dtype, out, ref, form="window", window=W,
               attended=int(seen.sum()))

    flash_case("8b_fullkv_s8192", 1, 32, 8, 8192, 128, 8192 - 77, bf16)
    flash_case("8b_post_tsp_s1664", 1, 32, 8, 1664, 128, 1646, bf16, scattered=True)
    flash_case("1b_s8192", 1, 32, 8, 8192, 64, 8192 - 77, bf16)
    flash_case("ragged_b2_s200_f32", 2, 8, 2, 200, 64, 150, f32, scattered=True)
    decode_case("8b_fullkv_C8320", 1, 32, 8, 8320, 128, 8192, bf16)
    decode_case("8b_fastkv_C1032", 1, 32, 8, 1032, 128, 896, bf16)
    decode_case("per_head_cache_C1000_f32", 2, 8, 8, 1000, 64, 500, f32)
    decode_case("group10_C777_f32", 1, 20, 2, 777, 128, 300, f32)
    # under a sliding window (after the cases above, which keep their inputs):
    # Ministral-8B's every FullKV layer (all keys valid); a window that bites
    # on most rows; a ragged float32 batch; a post-TSP layout of scattered
    # ascending positions with a zero tail, where the kernel's skip of tiles
    # below the band must hold for positions that are not layout indices
    flash_case("ministral_s40960_w32768", 1, 32, 8, 40960, 128, 40960, bf16, window=32768)
    flash_case("s8192_w1024", 1, 32, 8, 8192, 128, 8192 - 77, bf16, window=1024)
    flash_case("ragged_b2_s200_w48_f32", 2, 8, 2, 200, 64, [200, 150], f32, window=48)
    flash_case("post_tsp_scattered_s1664_w1024", 1, 32, 8, 1664, 128, 1646, bf16,
               scattered=True, window=1024)
    # Ministral-8B's FullKV cache after the last step (40960 + 31 entries),
    # cut to its last 32768 entries by rank
    decode_case("ministral_fullkv_C41088_rank_cut", 1, 32, 8, 40960 + 128, 128, 40960, bf16,
                window=32768)
    # the rectangular form, as chunked admission calls it: Llama-3.1-8B's last
    # 2048-row chunk of an 8192-slot scratch; a chunk at 2048 gated at 4096,
    # with the slots from 4096 on poisoned; Ministral's last chunk of a
    # 40960-slot scratch under its window; a float32 ragged batch (c = 100)
    # with its own gate per example, one of them inside the chunk
    rect_case("8b_chunk_6144_of_8192", 1, 32, 8, 8192, 2048, 128, [6144], [8192], [8192], bf16)
    rect_case("8b_chunk_2048_gate_4096_poisoned", 1, 32, 8, 8192, 2048, 128, [2048], [4096],
              [4096], bf16, poison_from=4096)
    rect_case("ministral_chunk_38912_of_40960_w32768", 1, 32, 8, 40960, 2048, 128, [38912],
              [40960], [40960], bf16, window=32768)
    rect_case("ragged_b2_c100_f32", 2, 8, 2, 1024, 100, 64, [300, 700], [380, 800], [380, 750],
              f32)
    # the Scheduler's decode: SnapKV's per-query-head cache (CH = H, g = 1),
    # and batch 4 with a mask of its own per example
    decode_case("8b_snapkv_CH32_C1032", 1, 32, 32, 1032, 128, 896, bf16)
    decode_case("8b_fastkv_b4_C1032", 4, 32, 8, 1032, 128, 896, bf16)
    # the fused observation-window scores (W = 8 unless said): Llama-3.1-8B's
    # every FastKV/SnapKV pre-TSP layer; a post-TSP scattered layout with
    # count < s; under a window (s > W); a float32 ragged batch with W = 12
    scores_case("8b_fused_s8192", 1, 32, 8, 8192, 128, 8192 - 77, 8, bf16)
    scores_case("8b_fused_post_tsp_s1664", 1, 32, 8, 1664, 128, 1646, 8, bf16, scattered=True)
    scores_case("fused_s8192_w1024", 1, 32, 8, 8192, 128, 8192 - 77, 8, bf16, window=1024)
    scores_case("fused_ragged_b2_s200_W12_f32", 2, 8, 2, 200, 64, [200, 150], 12, f32)
    # the int8 cache: FastKV's at Llama-3.1-8B, SnapKV's per-query-head one
    # at batch 4 (the Scheduler's), FullKV's 8320 slots
    int8_decode_case("8b_fastkv_C1032_int8", 1, 32, 8, 1032, 128, 896, bf16)
    int8_decode_case("8b_snapkv_b4_CH32_C1032_int8", 4, 32, 32, 1032, 128, 896, bf16)
    int8_decode_case("8b_fullkv_C8320_int8", 1, 32, 8, 8320, 128, 8192, bf16)
    # the kernel's own window term on Ministral-8B's FullKV cache
    window_decode_case("ministral_fullkv_C41088_window_term", 1, 32, 8, 40960 + 128, 128,
                       40960, bf16, 32768)
    emit({"phase": "kernels_vs_plain", "cases": cases})
    check(all(c["ok"] for c in cases), "a kernel disagrees with its plain version")
    return cases, flash_lib, decode_lib


# ---------------------------------------------------------------------------
# tiny config: the card against the CPU
# ---------------------------------------------------------------------------

def phase_tiny_card_vs_cpu(torch):
    from fastkv_tpu_torch.core.config import ModelConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the kernels take head_dim 64 and 128; the window (48) bites on every
    # prompt; "int8" runs int8 weights, the int8 KV cache and the fused
    # window scores together
    for window in (None, 48):
        cfg = ModelConfig.tiny(head_dim=64, sliding_window=window)
        for int8 in (False, True):
            tiny_card_vs_cpu(torch, cfg, int8)
            tiny_serve_card_vs_cpu(torch, cfg, int8)


def tiny_params(torch, cfg, int8: bool):
    """The tiny config's float32 weights from the seed (int8 weight-only with
    ``int8``), on the CPU and a copy on the card. The query and key
    projections are scaled by 8: at std 0.02 the tiny model's attention is
    near uniform, and the window scores of the keys on either side of a
    top-k boundary differ by only 6e-7 to 2e-6 of their value, within the
    float32 rounding by which card and CPU differ, so a keep-set could flip
    between them; scaled, the smallest such margin is 2e-5 (measured on the
    CPU over every tiny run here)."""
    from fastkv_tpu_torch.core import quant
    from fastkv_tpu_torch.models.llama import init_params

    p_cpu = init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    for name in ("wq", "wk"):
        p_cpu["layers"][name] = p_cpu["layers"][name] * 8.0
    if int8:
        p_cpu = quant.quantize_params_int8(p_cpu)
    p_gpu = {k: v.to("cuda") for k, v in p_cpu.items() if k != "layers"}
    p_gpu["layers"] = {k: v.to("cuda") for k, v in p_cpu["layers"].items()}
    return p_cpu, p_gpu


def tiny_card_vs_cpu(torch, cfg, int8: bool):
    import numpy as np

    from fastkv_tpu_torch.core.config import EngineConfig, Method, MethodConfig
    from fastkv_tpu_torch.engine import prefill as pm
    from fastkv_tpu_torch.engine.generate import Engine

    mcfg = MethodConfig(method=Method.FASTKV, eviction_mode="proportional",
                        retain_rate=0.3, tsp_rate=0.5, tsp_idx=1, pooling="maxpool")
    ecfg = EngineConfig(prefill_buckets=(512,), max_new_tokens=16, capacity_align=8,
                        fuse_window_scores=int8, kv_int8=int8)
    p_cpu, p_gpu = tiny_params(torch, cfg, int8)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (300, 181, 457)]

    shapes = pm.plan_shapes(cfg, mcfg, ecfg, 512)
    tokens = np.zeros((3, 512), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    n = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    with torch.inference_mode():
        lc, cc = pm.prefill(p_cpu, cfg, mcfg, shapes, torch.from_numpy(tokens), n, ecfg)
        zero_launches()
        lg, cg = pm.prefill(p_gpu, cfg, mcfg, shapes, torch.from_numpy(tokens).cuda(), n.cuda(),
                            ecfg)
        fused = count_launches()["flash_prefill_scores"]
    logit_err = (lg.cpu() - lc).abs().max().item()
    pos_eq = bool(torch.equal(cg.pos.cpu(), cc.pos))
    valid_eq = bool(torch.equal(cg.valid.cpu(), cc.valid))
    toks_cpu = Engine(p_cpu, cfg, mcfg, ecfg, device="cpu").generate(prompts, 16)
    zero_launches()
    toks_gpu = Engine(p_gpu, cfg, mcfg, ecfg).generate(prompts, 16)
    counted = count_launches()
    decode = (counted["decode_attn"], counted["decode_attn_int8"])
    # float32 on both sides; the card sums in another order
    tol = 1e-3
    variant = " int8 weights + kv_int8 + fused scores" if int8 else ""
    emit({"phase": "tiny_card_vs_cpu",
          "config": f"tiny(head_dim=64, sliding_window={cfg.sliding_window}) float32 "
                    f"fastkv maxpool{variant}",
          "prefill_logit_max_abs_err": logit_err, "tol": tol, "pos_equal": pos_eq,
          "valid_equal": valid_eq, "tokens_equal": toks_cpu == toks_gpu,
          "cache_dtype": str(cg.k.dtype), "fused_launches": fused,
          "decode_launches": decode[0], "int8_decode_launches": decode[1]})
    check(logit_err <= tol and pos_eq and valid_eq and toks_cpu == toks_gpu,
          f"tiny config (window {cfg.sliding_window}{variant}): the card disagrees with the CPU")
    want_fused = cfg.num_layers if int8 else 0
    check(fused == want_fused and decode[0] > 0 and decode[1] == (decode[0] if int8 else 0)
          and (cg.k.dtype == torch.int8) == int8,
          f"tiny config{variant}: fused {fused}, decode launches {decode}, cache {cg.k.dtype}")


def tiny_serve_card_vs_cpu(torch, cfg, int8: bool):
    """The Scheduler with chunked admission (64-token chunks, two slots,
    staggered budgets so that the third request admits chunk-wise) for
    FastKV and SnapKV: tokens and the order of events on the card must equal
    the port's on the CPU. ``int8``: int8 weights, kv_int8 and the fused
    window scores."""
    import numpy as np

    from fastkv_tpu_torch.core.config import EngineConfig, Method, MethodConfig
    from fastkv_tpu_torch.engine.scheduler import Scheduler

    ecfg = EngineConfig(prefill_buckets=(256,), capacity_align=8, prefill_chunk=64,
                        fuse_window_scores=int8, kv_int8=int8)
    p_cpu, p_gpu = tiny_params(torch, cfg, int8)
    rng = np.random.default_rng(SEED)
    reqs = [(rng.integers(0, cfg.vocab_size, n).tolist(), b)
            for n, b in ((230, 24), (201, 6), (140, 12))]

    def serve(params, mcfg, device):
        sched = Scheduler(params, cfg, mcfg, ecfg, max_batch=2, bucket=256, max_new_tokens=24,
                          device=device)
        for prompt, budget in reqs:
            sched.submit(prompt, budget)
        toks = {r.req_id: r.tokens for r in sched.run()}
        return toks, [e if e[0] != "decode" else ("decode",) for e in sched.events]

    for method in (Method.FASTKV, Method.SNAPKV):
        mcfg = MethodConfig(method=method, eviction_mode="proportional", retain_rate=0.3,
                            tsp_rate=0.5, tsp_idx=1, pooling="maxpool")
        toks_cpu, ev_cpu = serve(p_cpu, mcfg, "cpu")
        zero_launches()
        toks_gpu, ev_gpu = serve(p_gpu, mcfg, "cuda")
        counted = count_launches()
        chunks = sum(e[0] == "chunk" for e in ev_gpu)
        variant = " int8 weights + kv_int8 + fused scores" if int8 else ""
        emit({"phase": "tiny_card_vs_cpu", "path": "scheduler",
              "config": f"tiny(head_dim=64, sliding_window={cfg.sliding_window}) float32 "
                        f"{method.value} prefill_chunk=64{variant}",
              "tokens_equal": toks_cpu == toks_gpu, "events_equal": ev_cpu == ev_gpu,
              "chunks": chunks, "launches": counted,
              "new_tokens": {i: len(t) for i, t in toks_gpu.items()}})
        check(toks_cpu == toks_gpu and ev_cpu == ev_gpu and chunks > 0
              and counted["flash_prefill_rect"] > 0,
              f"tiny Scheduler {method.value} (window {cfg.sliding_window}{variant}): the card "
              "disagrees with the CPU")
        check((counted["flash_prefill_scores"] > 0) == int8
              and counted["decode_attn_int8"] == (counted["decode_attn"] if int8 else 0),
              f"tiny Scheduler {method.value}{variant}: launches {counted}")


# ---------------------------------------------------------------------------
# full width: Llama-3.1-8B
# ---------------------------------------------------------------------------

def host_probes(torch) -> dict:
    """The host's speed just before a window: ms for a fixed pure-Python loop,
    and host us to enqueue one small CUDA op (the decode step is ~1300 such
    launches)."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(200_000):
        acc += i & 7
    py_ms = 1e3 * (time.perf_counter() - t0)
    x = torch.zeros(64, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        x.add_(1.0)
    launch_us = 1e6 * (time.perf_counter() - t0) / 2000
    torch.cuda.synchronize()
    return {"py_loop_ms": py_ms, "launch_us": launch_us}


def host_window(fn):
    """Run fn once; returns (its result, this thread's host readings): wall
    seconds, CPU seconds, involuntary context switches (the scheduler took
    the core away) and seconds spent in Python's garbage collector."""
    import gc
    import resource

    gc_s = [0.0, 0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_s[1] = time.perf_counter()
        else:
            gc_s[0] += time.perf_counter() - gc_s[1]

    gc.callbacks.append(on_gc)
    r0 = resource.getrusage(resource.RUSAGE_THREAD)
    t0 = time.perf_counter()
    try:
        out = fn()
    finally:
        wall = time.perf_counter() - t0
        gc.callbacks.remove(on_gc)
    r1 = resource.getrusage(resource.RUSAGE_THREAD)
    return out, {
        "wall_s": wall,
        "cpu_s": (r1.ru_utime - r0.ru_utime) + (r1.ru_stime - r0.ru_stime),
        "involuntary_switches": r1.ru_nivcsw - r0.ru_nivcsw,
        "gc_s": gc_s[0],
    }


def spread(xs):
    """Median, min and max; ``all`` keeps the windows in the order they ran."""
    srt = sorted(xs)
    return {"median": srt[len(srt) // 2], "min": srt[0], "max": srt[-1], "all": list(xs)}


def phase_full_width(torch, gpu: str):
    from fastkv_tpu_torch.core.config import EngineConfig, Method, MethodConfig, ModelConfig
    from fastkv_tpu_torch.engine import decode as dm
    from fastkv_tpu_torch.engine import prefill as pm
    from fastkv_tpu_torch.engine.generate import Engine
    from fastkv_tpu_torch.models.llama import init_params

    cfg = ModelConfig.llama_3_1_8b()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = init_params(cfg, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    s, new = 8192, 32
    prompt = torch.randint(0, cfg.vocab_size, (s,), generator=gen, device="cuda").tolist()
    tok_t = torch.tensor([prompt], device="cuda", dtype=torch.int32)
    n_t = torch.tensor([s], dtype=torch.int32, device="cuda")
    ecfg = EngineConfig(prefill_buckets=(s,), max_new_tokens=new)
    methods = (Method.FULLKV, Method.FASTKV)
    launches = dict.fromkeys(LAUNCH_KEYS, 0)
    runs = {}

    def window(m):
        r = runs[m]
        probes = host_probes(torch)
        out, host = host_window(lambda: r["eng"].generate([prompt], new))
        w = dict(r["eng"].last_timing, **host, **probes)
        w["decode_ms_per_token"] = 1e3 * w["decode_s"] / w["decode_steps"]
        w["cpu_share"] = w["cpu_s"] / w["wall_s"]
        r["windows"].append(w)
        return out

    for m in methods:
        # canonical operating point (window 8, maxpool kernel 7 are the defaults)
        mcfg = MethodConfig(method=m, eviction_mode="proportional",
                            retain_rate=0.1, tsp_rate=0.2, tsp_idx=15)
        eng = Engine(params, cfg, mcfg, ecfg)
        shapes = eng.shapes_for(s, new)
        runs[m] = r = {"eng": eng, "mcfg": mcfg, "shapes": shapes, "windows": []}
        # warm-up of both phases (the kernels' first launches, cuBLAS's first
        # GEMVs), and the prefill logits' check
        with torch.inference_mode():
            logits, cache = pm.prefill(params, cfg, mcfg, shapes, tok_t, n_t)
            check(tuple(logits.shape) == (1, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
                  f"{m.value}: prefill logits not finite or misshapen")
            check(cache.k.shape[3] == shapes.total_capacity, f"{m.value}: cache capacity")
            first = logits.argmax(-1).to(torch.int32)
            for t in range(4):
                dm.decode_step(params, cfg, mcfg, cache, first, n_t + t,
                               shapes.prefill_capacity + t)
        del logits, cache, first
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        # the main path, counted: one generate with every count set to 0
        zero_launches()
        out = window(m)
        r["launches"] = count_launches()
        r["peak"] = torch.cuda.max_memory_allocated()
        r["tokens"] = out
        for k in launches:
            launches[k] += r["launches"][k]
        check(len(out) == 1 and len(out[0]) == new
              and all(0 <= t < cfg.vocab_size for t in out[0]), f"{m.value}: bad tokens")
        check(r["launches"]["flash_prefill"] == cfg.num_layers,
              f"{m.value}: flash_prefill launched {r['launches']['flash_prefill']} times")
        check(r["launches"]["decode_attn"] == cfg.num_layers * (new - 1),
              f"{m.value}: decode_attn launched {r['launches']['decode_attn']} times")

    # four more windows per method, the methods alternating, so that a drift
    # of the host's speed over the run falls on both alike
    for _ in range(4):
        for m in methods:
            r = runs[m]
            r["same_tokens"] = r.get("same_tokens", True) and window(m) == r["tokens"]

    results = {}
    for m in methods:
        r, shapes = runs[m], runs[m]["shapes"]
        ws = r["windows"]
        rec = {
            "phase": f"full_width_{m.value}", "model": cfg.name, "prompt_len": s,
            "new_tokens": new, "prefill_capacity": shapes.prefill_capacity,
            "cache_capacity": shapes.total_capacity, "tsp_capacity": shapes.tsp_capacity,
            "prefill_s": spread([w["prefill_s"] for w in ws]),
            "decode_ms_per_token": spread([w["decode_ms_per_token"] for w in ws]),
            "max_memory_allocated_bytes": r["peak"], "launches": r["launches"],
            "host": {
                "cpus": len(os.sched_getaffinity(0)),
                **{k: spread([w[k] for w in ws]) for k in
                   ("cpu_share", "gc_s", "py_loop_ms", "launch_us")},
                "involuntary_switches": [w["involuntary_switches"] for w in ws],
            },
            "weights_init_s": init_s, "gpu": gpu, "tokens_head": r["tokens"][0][:8],
            "repeats_give_the_same_tokens": r["same_tokens"],
        }
        emit(rec)
        results[m.value] = rec

        # where the time goes: one prefill and eight decode steps under the profiler
        mcfg, held = r["mcfg"], {}
        with torch.inference_mode():
            wall, kern = profile_window(
                torch, lambda: held.update(out=pm.prefill(params, cfg, mcfg, shapes, tok_t, n_t)))
            prefill_prof = breakdown(wall, kern)
            logits, cache = held.pop("out")
            first = logits.argmax(-1).to(torch.int32)
            wall, kern = profile_window(torch, lambda: [
                dm.decode_step(params, cfg, mcfg, cache, first, n_t + t,
                               shapes.prefill_capacity + t) for t in range(8)])
            decode_prof = breakdown(wall, kern, calls=8)
        emit({"phase": f"profile_{m.value}", "gpu": gpu, "prefill": prefill_prof,
              "decode_step": decode_prof})
        del logits, cache, first
    del runs
    by_path = {"llama_3_1_8b": launches}
    by_path.update(phase_fused(torch, gpu, params, cfg, prompt))
    del params
    torch.cuda.empty_cache()
    return by_path, results


def canonical(method, tsp_idx=15):
    """The canonical operating point (window 8, maxpool kernel 7 are the
    defaults)."""
    from fastkv_tpu_torch.core.config import MethodConfig

    return MethodConfig(method=method, eviction_mode="proportional", retain_rate=0.1,
                        tsp_rate=0.2, tsp_idx=tsp_idx)


def phase_fused(torch, gpu: str, params, cfg, prompt):
    """FastKV and SnapKV at Llama-3.1-8B width on the 8192-token prompt, the
    observation-window scores fused into the flash call or not: one prefill
    each (its cache positions) and one counted generate each. bf16 rounds
    the attention and the scores alike in both, but the hidden states may
    differ by a rounding, which can flip a top-k tie: equality is reported,
    not demanded. Returns the launches per generate."""
    from fastkv_tpu_torch.core.config import EngineConfig, Method
    from fastkv_tpu_torch.engine import prefill as pm
    from fastkv_tpu_torch.engine.generate import Engine

    s, new, L = len(prompt), 32, cfg.num_layers
    tok_t = torch.tensor([prompt], device="cuda", dtype=torch.int32)
    n_t = torch.tensor([s], dtype=torch.int32, device="cuda")
    by_path = {}
    for m in (Method.FASTKV, Method.SNAPKV):
        mcfg, runs = canonical(m), {}
        for fused in (False, True):
            ecfg = EngineConfig(prefill_buckets=(s,), max_new_tokens=new,
                                fuse_window_scores=fused)
            eng = Engine(params, cfg, mcfg, ecfg)
            shapes = eng.shapes_for(s, new)
            with torch.inference_mode():  # also the warm-up of the form
                logits, cache = pm.prefill(params, cfg, mcfg, shapes, tok_t, n_t, ecfg)
            pos = cache.pos[..., :shapes.prefill_capacity].clone()
            valid = cache.valid[..., :shapes.prefill_capacity].clone()
            del cache
            zero_launches()
            out = eng.generate([prompt], new)
            counted = count_launches()
            runs[fused] = dict(pos=pos, valid=valid, tokens=out[0], launches=counted,
                               timing=dict(eng.last_timing), logits=logits[0].float())
            by_path[f"llama_3_1_8b_{'fused' if fused else 'unfused'}_{m.value}"] = counted
            check(len(out[0]) == new and all(0 <= t < cfg.vocab_size for t in out[0]),
                  f"fused {m.value}: bad tokens")
            want = (L if fused else 0, L if fused else 0, L, L * (new - 1))
            got = (counted["flash_prefill_scores"], counted["window_scores_finish"],
                   counted["flash_prefill"], counted["decode_attn"])
            check(got == want, f"{m.value} fused={fused}: launches {got}, want {want}")
        u, f = runs[False], runs[True]
        either = u["valid"] | f["valid"]
        same_pos = ((u["pos"] == f["pos"]) & (u["valid"] == f["valid"]))[either]
        top2 = torch.topk(u["logits"], 2).values
        emit({
            "phase": f"fused_{m.value}", "model": cfg.name, "prompt_len": s, "new_tokens": new,
            "equal_token_share": sum(a == b for a, b in zip(u["tokens"], f["tokens"])) / new,
            "equal_cache_position_share": float(same_pos.float().mean()),
            "cache_entries_compared": int(either.sum()),
            "layers_with_equal_cache_positions": [
                int(bool(torch.equal(u["pos"][l], f["pos"][l]))) for l in range(L)],
            "first_token_equal": u["tokens"][0] == f["tokens"][0],
            "prefill_logits_max_abs_diff": float((u["logits"] - f["logits"]).abs().max()),
            "unfused_top2_logit_margin": float(top2[0] - top2[1]),
            "prefill_s": {"unfused": u["timing"]["prefill_s"], "fused": f["timing"]["prefill_s"]},
            "launches": {"unfused": u["launches"], "fused": f["launches"]}, "gpu": gpu,
        })
    return by_path


def phase_int8(torch, gpu: str):
    """FastKV and FullKV at Llama-3.1-8B width with int8 weights (made on the
    card from a seed, one layer at a time) and the int8 KV cache, on an
    8192-token prompt, 32 new tokens: a warm-up, one counted generate per
    method, then two more windows each, the methods alternating (prefill
    seconds and decode ms per token: median of three), peak memory, and
    eight FastKV decode steps under the profiler. Returns the launches of the
    counted generates."""
    from fastkv_tpu_torch.core.config import EngineConfig, Method, ModelConfig
    from fastkv_tpu_torch.engine import decode as dm
    from fastkv_tpu_torch.engine import prefill as pm
    from fastkv_tpu_torch.engine.generate import Engine
    from fastkv_tpu_torch.models.llama import init_params_int8

    cfg = ModelConfig.llama_3_1_8b()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = init_params_int8(cfg, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       [*params["layers"].values(), *(v for k, v in params.items()
                                                      if k != "layers")])
    s, new, L = 8192, 32, cfg.num_layers
    prompt = torch.randint(0, cfg.vocab_size, (s,), generator=gen, device="cuda").tolist()
    tok_t = torch.tensor([prompt], device="cuda", dtype=torch.int32)
    n_t = torch.tensor([s], dtype=torch.int32, device="cuda")
    ecfg = EngineConfig(prefill_buckets=(s,), max_new_tokens=new, kv_int8=True)
    methods = (Method.FASTKV, Method.FULLKV)
    runs, by_path = {}, {}
    for m in methods:
        mcfg = canonical(m)
        eng = Engine(params, cfg, mcfg, ecfg)
        shapes = eng.shapes_for(s, new)
        with torch.inference_mode():  # warm-up, and the cache's check
            logits, cache = pm.prefill(params, cfg, mcfg, shapes, tok_t, n_t, ecfg)
            check(bool(torch.isfinite(logits).all()) and cache.k.dtype == torch.int8
                  and cache.k_scale is not None, f"int8 {m.value}: prefill logits or cache")
            first = logits.argmax(-1).to(torch.int32)
            for t in range(4):
                dm.decode_step(params, cfg, mcfg, cache, first, n_t + t,
                               shapes.prefill_capacity + t)
        del logits, cache, first
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        out = eng.generate([prompt], new)
        counted = count_launches()
        runs[m] = dict(eng=eng, mcfg=mcfg, shapes=shapes, peak=torch.cuda.max_memory_allocated(),
                       launches=counted, tokens=out[0], windows=[dict(eng.last_timing)])
        by_path[f"llama_3_1_8b_int8_{m.value}"] = counted
        check(len(out[0]) == new and all(0 <= t < cfg.vocab_size for t in out[0]),
              f"int8 {m.value}: bad tokens")
        want = (L, L * (new - 1), L * (new - 1))
        got = (counted["flash_prefill"], counted["decode_attn"], counted["decode_attn_int8"])
        check(got == want, f"int8 {m.value}: launches {got}, want {want}")
    for _ in range(2):
        for m in methods:
            r = runs[m]
            r["eng"].generate([prompt], new)
            r["windows"].append(dict(r["eng"].last_timing))
    for m in methods:
        r = runs[m]
        emit({
            "phase": f"int8_{m.value}", "model": cfg.name, "weights": "int8 weight-only",
            "kv_int8": True, "prompt_len": s, "new_tokens": new,
            "prefill_s": spread([w["prefill_s"] for w in r["windows"]]),
            "decode_ms_per_token": spread([1e3 * w["decode_s"] / w["decode_steps"]
                                           for w in r["windows"]]),
            "max_memory_allocated_bytes": r["peak"], "weight_bytes": weight_bytes,
            "weights_init_s": init_s, "launches": r["launches"], "tokens_head": r["tokens"][:8],
            "gpu": gpu,
        })
    r = runs[Method.FASTKV]
    with torch.inference_mode():
        logits, cache = pm.prefill(params, cfg, r["mcfg"], r["shapes"], tok_t, n_t, ecfg)
        first = logits.argmax(-1).to(torch.int32)
        wall, kern = profile_window(torch, lambda: [
            dm.decode_step(params, cfg, r["mcfg"], cache, first, n_t + t,
                           r["shapes"].prefill_capacity + t) for t in range(8)])
    emit({"phase": "profile_int8_fastkv", "gpu": gpu,
          "decode_step": breakdown(wall, kern, calls=8)})
    del params, runs, logits, cache, first
    torch.cuda.empty_cache()
    return by_path


# ---------------------------------------------------------------------------
# full width: the Mistral family
# ---------------------------------------------------------------------------

def phase_mistral(torch, gpu: str, tag: str, cfg, s: int, tsp_idx: int):
    """Engine.generate once per method at ``cfg``'s full width on one s-token
    prompt (32 new tokens, batch 1), FastKV at the canonical point with this
    model's tsp_idx, each run counted; then one prefill and eight decode steps
    under the profiler, the prefill logits' check and, under a window, how
    many cache entries the last step's rank cut left visible. Returns the
    launches summed over both generates."""
    from fastkv_tpu_torch.core.config import EngineConfig, Method, MethodConfig
    from fastkv_tpu_torch.engine import decode as dm
    from fastkv_tpu_torch.engine import prefill as pm
    from fastkv_tpu_torch.engine.generate import Engine
    from fastkv_tpu_torch.models.llama import init_params

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = init_params(cfg, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weight_bytes = sum(t.numel() * t.element_size() for t in
                       [*params["layers"].values(), *(v for k, v in params.items()
                                                      if k != "layers")])
    new = 32
    prompt = torch.randint(0, cfg.vocab_size, (s,), generator=gen, device="cuda").tolist()
    tok_t = torch.tensor([prompt], device="cuda", dtype=torch.int32)
    n_t = torch.tensor([s], dtype=torch.int32, device="cuda")
    ecfg = EngineConfig(prefill_buckets=(s,), max_new_tokens=new)
    launches = dict.fromkeys(LAUNCH_KEYS, 0)
    for m in (Method.FULLKV, Method.FASTKV):
        # canonical operating point (window 8, maxpool kernel 7 are the defaults)
        mcfg = MethodConfig(method=m, eviction_mode="proportional",
                            retain_rate=0.1, tsp_rate=0.2, tsp_idx=tsp_idx)
        eng = Engine(params, cfg, mcfg, ecfg)
        shapes = eng.shapes_for(s, new)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        # the main path, counted: one generate with every count set to 0
        zero_launches()
        out, host = host_window(lambda: eng.generate([prompt], new))
        counted = count_launches()
        peak = torch.cuda.max_memory_allocated()
        timing = dict(eng.last_timing)
        for k in launches:
            launches[k] += counted[k]
        check(len(out) == 1 and len(out[0]) == new
              and all(0 <= t < cfg.vocab_size for t in out[0]), f"{tag} {m.value}: bad tokens")
        check(counted["flash_prefill"] == cfg.num_layers,
              f"{tag} {m.value}: flash_prefill launched {counted['flash_prefill']} times")
        check(counted["decode_attn"] == cfg.num_layers * (new - 1),
              f"{tag} {m.value}: decode_attn launched {counted['decode_attn']} times")

        # where the time goes: one prefill and eight decode steps under the profiler
        held = {}
        with torch.inference_mode():
            wall, kern = profile_window(
                torch, lambda: held.update(out=pm.prefill(params, cfg, mcfg, shapes, tok_t, n_t)))
            prefill_prof = breakdown(wall, kern)
            logits, cache = held.pop("out")
            check(tuple(logits.shape) == (1, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
                  f"{tag} {m.value}: prefill logits not finite or misshapen")
            check(cache.k.shape[3] == shapes.total_capacity, f"{tag} {m.value}: cache capacity")
            first = logits.argmax(-1).to(torch.int32)
            wall, kern = profile_window(torch, lambda: [
                dm.decode_step(params, cfg, mcfg, cache, first, n_t + t,
                               shapes.prefill_capacity + t) for t in range(8)])
            decode_prof = breakdown(wall, kern, calls=8)
            # entries per cache head after the eighth step, and how many of
            # them its rank cut left visible (layer 0, head 0)
            entries = int(cache.valid[0, 0, 0].sum())
            visible = int(dm.window_mask(cache.valid[0, 0, 0], cfg.sliding_window).sum())
        want = entries if cfg.sliding_window is None else min(entries, cfg.sliding_window)
        check(visible == want, f"{tag} {m.value}: {visible} of {entries} entries visible")
        emit({
            "phase": f"full_width_{tag}_{m.value}", "model": cfg.name,
            "sliding_window": cfg.sliding_window, "tsp_idx": tsp_idx, "prompt_len": s,
            "new_tokens": new, "prefill_capacity": shapes.prefill_capacity,
            "cache_capacity": shapes.total_capacity, "tsp_capacity": shapes.tsp_capacity,
            "prefill_s": timing["prefill_s"],
            "decode_ms_per_token": 1e3 * timing["decode_s"] / timing["decode_steps"],
            "max_memory_allocated_bytes": peak, "weight_bytes": weight_bytes,
            "launches": counted, "host": host, "weights_init_s": init_s, "gpu": gpu,
            "tokens_head": out[0][:8],
            "cache_entries_after_8_steps": entries, "visible_after_rank_cut": visible,
            "profile": {"prefill": prefill_prof, "decode_step": decode_prof},
        })
        del logits, cache, first, held, eng
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# serving: the continuous-batching Scheduler at Llama-3.1-8B width
# ---------------------------------------------------------------------------

SERVE_REQUESTS = ((8192, 32), (7001, 8), (4096, 24), (2500, 16), (8000, 32), (6000, 12))
SERVE_BUCKET, SERVE_CHUNK = 8192, 2048


LAUNCH_KEYS = ("flash_prefill", "flash_prefill_rect", "flash_prefill_scores",
               "window_scores_finish", "decode_attn", "decode_attn_int8", "decode_attn_window")


def count_launches():
    """The kernels' launch counts since they were last set to 0 (the forms'
    counts are those of the kernel's launches in that form; the finishing
    pass is a kernel of its own)."""
    from fastkv_tpu_torch.ops import decode_attn as da
    from fastkv_tpu_torch.ops import flash_prefill as fp

    return dict(zip(LAUNCH_KEYS, (fp.launches, fp.rect_launches, fp.scores_launches,
                                  fp.finish_launches, da.launches, da.int8_launches,
                                  da.window_launches)))


def zero_launches():
    from fastkv_tpu_torch.ops import decode_attn as da
    from fastkv_tpu_torch.ops import flash_prefill as fp

    fp.launches = fp.rect_launches = fp.scores_launches = fp.finish_launches = 0
    da.launches = da.int8_launches = da.window_launches = 0


def phase_serve(torch, gpu: str):
    """The Scheduler at Llama-3.1-8B width: four slots, bucket 8192, the six
    requests of SERVE_REQUESTS (the first four admit at once, the last two
    while the others decode: chunk-wise in 2048-token chunks, or monolithic
    with prefill_chunk None). One counted run per method. Returns the
    launches per run."""
    import numpy as np

    from fastkv_tpu_torch.core.config import EngineConfig, Method, ModelConfig
    from fastkv_tpu_torch.engine.scheduler import Scheduler
    from fastkv_tpu_torch.models.llama import init_params

    cfg = ModelConfig.llama_3_1_8b()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n, _ in SERVE_REQUESTS]

    def scheduler(m, chunk, **ekw):
        return Scheduler(params, cfg, canonical(m), EngineConfig(
            prefill_chunk=chunk, chunk_decode_steps=1, **ekw),
                         max_batch=4, bucket=SERVE_BUCKET, max_new_tokens=32)

    # warm-up, not counted: two idle admissions and one chunked (the kernels'
    # and cuBLAS's first launches at these shapes)
    warm = scheduler(Method.FASTKV, SERVE_CHUNK)
    for n, budget in ((SERVE_CHUNK, 6), (SERVE_CHUNK, 2), (2 * SERVE_CHUNK, 3)):
        warm.submit(prompts[0][:n], budget)
    with torch.inference_mode():
        warm.run()
    del warm

    launches, tokens = {}, {}
    int8_fused = dict(kv_int8=True, fuse_window_scores=True)
    for tag, m, chunk, ekw in (("fastkv", Method.FASTKV, SERVE_CHUNK, {}),
                               ("fullkv", Method.FULLKV, SERVE_CHUNK, {}),
                               ("snapkv", Method.SNAPKV, SERVE_CHUNK, {}),
                               ("streamingllm", Method.STREAMINGLLM, SERVE_CHUNK, {}),
                               ("fastkv_monolithic", Method.FASTKV, None, {}),
                               ("fastkv_kv_int8_fused", Method.FASTKV, SERVE_CHUNK, int8_fused)):
        sched = scheduler(m, chunk, **ekw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        t0 = time.perf_counter()
        for p, (_, budget) in zip(prompts, SERVE_REQUESTS):
            sched.submit(p, budget)
        done = sched.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counted = count_launches()
        launches[f"serve_{tag}"] = counted
        by_id = {r.req_id: r for r in done}
        tokens[tag] = {i: r.tokens for i, r in by_id.items()}
        kinds = {}
        for e in sched.events:
            kinds[e[0]] = kinds.get(e[0], 0) + 1
        stamps = [e[1] for e in sched.events if e[0] == "decode"]
        gaps_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
        finished = (sorted(by_id) == list(range(len(SERVE_REQUESTS)))
                    and all(len(by_id[i].tokens) == budget
                            for i, (_, budget) in enumerate(SERVE_REQUESTS)))
        rec = {
            "phase": f"serve_{tag}", "model": cfg.name, "method": m.value,
            "prefill_chunk": chunk, "engine_flags": ekw, "max_batch": 4, "bucket": SERVE_BUCKET,
            "requests": [list(r) for r in SERVE_REQUESTS],
            "launches": counted, "events": kinds,
            "ttft_s": [by_id[i].metrics["ttft_s"] for i in sorted(by_id)],
            "tpot_s": [by_id[i].metrics["tpot_s"] for i in sorted(by_id)],
            "inter_token_gap_ms": {"median": float(np.median(gaps_ms)), "max": max(gaps_ms),
                                   "n": len(gaps_ms)},
            "wall_s": wall, "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "all_finished_with_their_budget": finished, "gpu": gpu,
        }
        if tag == "fastkv_monolithic":
            same = sum(a == b for i in tokens["fastkv"]
                       for a, b in zip(tokens["fastkv"][i], tokens[tag][i]))
            rec["tokens_agreeing_with_chunked_fastkv"] = same / sum(b for _, b in SERVE_REQUESTS)
        emit(rec)
        check(finished, f"serve_{tag}: a request did not finish with its budget")
        check(counted["flash_prefill"] > 0 and counted["decode_attn"] > 0,
              f"serve_{tag}: a kernel of the path did not launch: {counted}")
        if chunk:
            check(counted["flash_prefill_rect"] > 0 and kinds.get("chunk", 0) > 0,
                  f"serve_{tag}: no chunked admission through the rectangular kernel")
        # fused: every layer of a monolithic admission, only segment B
        # (layers tsp_idx + 1 on) of a chunked one's finish
        seg_b = cfg.num_layers - (canonical(m).tsp_idx + 1)
        want = (cfg.num_layers * kinds.get("prefill", 0) + seg_b * kinds.get("finish", 0)
                if ekw else 0)
        check(counted["flash_prefill_scores"] == want == counted["window_scores_finish"]
              and counted["decode_attn_int8"] == (counted["decode_attn"] if ekw else 0),
              f"serve_{tag}: fused {counted['flash_prefill_scores']} (want {want}), "
              f"int8 decode {counted['decode_attn_int8']} of {counted['decode_attn']}")
        if tag in ("fastkv", "fastkv_kv_int8_fused"):
            profile_serve(torch, gpu, params, cfg, sched, prompts[4], tag)
        del sched, done, by_id
    del params
    torch.cuda.empty_cache()
    return launches


def profile_serve(torch, gpu, params, cfg, sched, prompt, tag):
    """Where a serving step's time goes: eight batch-4 decode steps over the
    Scheduler's shared cache, then the last 2048-token chunk of an admission
    of ``prompt`` and its finish, each under the profiler."""
    from fastkv_tpu_torch.engine import chunked
    from fastkv_tpu_torch.engine import decode as dm

    dev = sched.device
    tok = torch.from_numpy(sched.tok).to(dev)
    pos = torch.from_numpy(sched.pos).to(dev)
    slots = torch.from_numpy(sched.shapes.prefill_capacity + sched.steps.astype("int64")).to(dev)
    with torch.inference_mode():
        wall, kern = profile_window(torch, lambda: [
            dm.decode_step(params, cfg, sched.mcfg, sched.cache, tok, pos, slots, sched.inv_freq)
            for _ in range(8)])
        decode_prof = breakdown(wall, kern, calls=8)
        progs = sched._chunk_progs_for(SERVE_BUCKET)
        adm = chunked.start_admission(progs, params, 0, None, prompt)
        c = progs.chunk
        last = (len(prompt) - 1) // c * c
        for start in range(0, last, c):
            progs.chunk_step(params, adm.sk, adm.sv, adm.qwin, adm.hbuf,
                             adm.tokens[:, start:start + c], start, adm.n)
        wall, kern = profile_window(torch, lambda: progs.chunk_step(
            params, adm.sk, adm.sv, adm.qwin, adm.hbuf, adm.tokens[:, last:last + c], last,
            adm.n))
        chunk_prof = breakdown(wall, kern)
        held = {}
        wall, kern = profile_window(torch, lambda: held.update(out=progs.finish(
            params, adm.sk, adm.sv, adm.qwin, adm.hbuf, adm.n)))
        finish_prof = breakdown(wall, kern)
        logits = held["out"][0]
    check(tuple(logits.shape) == (1, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
          "profile_serve: finish logits not finite or misshapen")
    emit({"phase": "profile_serve", "run": f"serve_{tag}", "gpu": gpu,
          "method": sched.mcfg.method.value,
          "decode_step_b4": decode_prof, "last_chunk": dict(chunk_prof, start=last),
          "finish": finish_prof})


# ---------------------------------------------------------------------------
# timings at the main-path shapes
# ---------------------------------------------------------------------------

def decode_timing(torch, decode_lib, q, kc, vc, valid, plan, mask, reps,
                  scales=None, window=None):
    """Kernel, plain and library times of one decode case over a cache of L
    layers ([L, b, CH, C, d]), each cycling over the layers so each call
    reads its cache from device memory, as the decode step does; ``mask`` is
    the library call's boolean mask [L, b, H, 1, C] (None where no single
    PyTorch call computes the function), ``reps`` the kernel and library calls per
    layer, ``plan`` the wrapper's split plan for these shapes. ``scales``:
    (k_scale, v_scale) [L, b, CH, C] of an int8 cache;
    ``window``: (q_pos [b], k_pos [L, b, CH, C], W) for the kernel's own
    window term. ``device_ms`` and ``library_device_ms`` are both from CUDA
    graphs of 4 L calls (``graph_ms``): a decode call takes tens of
    microseconds, about what Python takes to launch one, so events around a
    Python loop time the host, and the profiler records no device activity
    in some windows; the profiler's readings, where it recorded, are kept
    beside them (``*_profiler_ms``)."""
    from fastkv_tpu_torch.ops import decode_attn as da

    L = kc.shape[0]
    it = iter(range(10**9))
    W = None if window is None else window[2]

    def layer_kw(l):
        kw = {}
        if scales is not None:
            kw.update(k_scale=scales[0][l], v_scale=scales[1][l])
        if window is not None:
            kw.update(q_pos=window[0], k_pos=window[1][l])
        return kw

    def kern():
        l = next(it) % L
        da.launch(decode_lib, q, kc[l], vc[l], valid[l], plan,
                  torch.cuda.current_stream().cuda_stream, window=W or 0, **layer_kw(l))

    def plain():
        l = next(it) % L
        da.decode_attention_plain(q, kc[l], vc[l], valid[l], sliding_window=W, **layer_kw(l))

    ms = events_ms(kern, reps=reps * L)
    kern_prof, kern_from = device_ms(torch, kern, L, DECODE_TC)
    kern_dev = graph_ms(kern, 4 * L)
    plain_ms = events_ms(plain, reps=2 * L)
    lib = dict(library_ms=None, library_device_ms=None)
    if mask is not None:
        call = layer_sdpa(q, kc, vc, mask)
        lib["library_ms"] = events_ms(call, reps=reps * L)
        lib["library_device_ms"] = graph_ms(call, 4 * L)
        prof, prof_from = device_ms(torch, call, L, "")
        lib["library_profiler_ms"] = prof if prof_from == "profiler" else None
    seen = None if window is None else valid[0] & (window[1][0] > window[0][:, None, None] - W)
    flops, nbytes = decode_work(q, kc[0], valid[0], seen, int8=scales is not None)
    bound_ms, bound_by = bound(flops, nbytes)
    out = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
               device_ms=kern_dev, device_ms_from="cuda_graph",
               device_profiler_ms=kern_prof if kern_from == "profiler" else None,
               **lib, flop=flops, bytes=nbytes,
               split=f"{plan.splits} splits x {plan.tiles} tiles of {da.TILE} slots, "
                     f"{plan.grid(q.shape[0], kc.shape[2])} CTAs",
               bound_share_device=bound_ms / kern_dev)
    if lib["library_device_ms"] is not None:
        out["at_or_below_library"] = kern_dev <= lib["library_device_ms"]
    return out


def phase_timings(torch, cases, flash_lib, decode_lib, launches, launches_by_path):
    from fastkv_tpu_torch.core import quant
    from fastkv_tpu_torch.engine import decode as dm
    from fastkv_tpu_torch.kernels import build
    from fastkv_tpu_torch.ops import decode_attn as da
    from fastkv_tpu_torch.ops import flash_prefill as fp

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    bf16 = torch.bfloat16
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    err = {name: max(c["max_abs_err"] for c in cases if c["kernel"] == name)
           for name in ("flash_prefill", "decode_attn")}

    # flash prefill: FullKV's every layer at Llama-3.1-8B, s = 8192, all keys valid
    s = 8192
    q, k, v, pos, cnt = flash_inputs(torch, 1, 32, 8, s, 128, s, bf16, gen)
    q_pos = pos.contiguous()
    k_pos = fp.fold_key_validity(pos, cnt).contiguous()
    kern = lambda: fp.launch(flash_lib, q, k, v, q_pos, k_pos, stream())  # noqa: E731
    ms = events_ms(kern, reps=5)
    kern_dev, kern_from = device_ms(torch, kern, 3, FLASH_BF16)
    plain_ms = events_ms(lambda: fp.flash_attention_plain(q, k, v, pos, cnt), reps=2, warmup=1)
    mask = (k_pos[:, None, None, :] <= q_pos[:, None, :, None])
    lib = layer_sdpa(q, k[None], v[None], mask[None])
    lib_ms = events_ms(lib, reps=5)
    lib_dev, lib_from = device_ms(torch, lib, 3, "")
    flops, nbytes = flash_work(torch, q, k, v, pos, cnt)
    flash_bound, flash_by = bound(flops, nbytes)
    flash = dict(
        name="flash_prefill", route="cuda",
        source="fastkv_tpu_torch/kernels/csrc/flash_prefill.cu",
        replaces="fastkv_tpu/ops/flash_prefill.py:472",
        launches=launches["flash_prefill"], max_abs_err=err["flash_prefill"],
        launches_by_path={p: n["flash_prefill"] for p, n in launches_by_path.items()},
        ms=ms, plain_ms=plain_ms, bound_ms=flash_bound, bound_by=flash_by,
        library_ms=lib_ms, device_ms=kern_dev, device_ms_from=kern_from,
        library_device_ms=lib_dev, library_device_ms_from=lib_from,
        shape="b=1 H=32 KH=8 s=8192 d=128 bf16, causal",
        flop=flops, bytes=nbytes, **rates(flops, ms, flash_bound))
    del mask

    # the fused observation-window scores at the same shape (W = 8, the
    # FastKV/SnapKV pre-TSP layer), timed beside the square form; then the
    # finishing pass alone on a strip of raw masked logits
    W = 8
    q_win, qw_pos = window_rows(torch, q, pos, cnt, W)
    fused = lambda: fp.launch(flash_lib, q, k, v, q_pos, k_pos, stream(), 0, None,  # noqa: E731
                              q_win, qw_pos)
    ms = events_ms(fused, reps=5)
    square_ms = events_ms(kern, reps=5)
    kern_dev, kern_from = device_ms(torch, fused, 3, FLASH_BF16, *FINISH)
    plain_ms = events_ms(lambda: fp.flash_attention_plain(
        q, k, v, pos, cnt, window_q=q_win, window_q_pos=qw_pos), reps=2, warmup=1)
    s_flops, s_bytes = scores_work(torch, q, k_pos, q_win, qw_pos)
    sc_bound, sc_by = bound(flops + s_flops, nbytes + s_bytes)
    err_scores = max(c["max_abs_err"] for c in cases if c["case"].endswith("/scores"))
    flash["scores"] = dict(
        launches=launches["flash_prefill_scores"], max_abs_err=err_scores,
        ms=ms, device_ms=kern_dev, device_ms_from=kern_from, plain_ms=plain_ms,
        square_ms_alongside=square_ms, bound_ms=sc_bound, bound_by=sc_by, library_ms=None,
        library_note="none: no single PyTorch call returns attention and the window rows' "
                     "softmax column sums; sdpa returns no probabilities",
        shape=f"b=1 H=32 KH=8 s={s} d=128 bf16, causal, W={W}, kernel + finishing pass",
        flop=flops + s_flops, bytes=nbytes + s_bytes, **rates(flops + s_flops, ms, sc_bound))
    strip = torch.randn((1, 32, W, s), generator=gen, device="cuda")
    strip = torch.where(k_pos[:, None, None, :] <= qw_pos[:, None, :, None], strip, -torch.inf)
    out_scores = torch.empty((1, 32, s), device="cuda")
    stats = torch.empty((1, 32, W, 2), device="cuda")
    finish = lambda: flash_lib.window_scores_finish(  # noqa: E731
        strip.data_ptr(), stats.data_ptr(), out_scores.data_ptr(), 1, 32, W, s, stream())
    ms = events_ms(finish, reps=20)
    fin_dev, fin_from = device_ms(torch, finish, 10, *FINISH)
    plain_ms = events_ms(lambda: torch.softmax(strip, dim=-1).sum(dim=-2), reps=20)
    fin_bytes = 4 * strip.numel() + 4 * out_scores.numel()
    # max, subtract, exp and add per strip entry, float32
    fin_bound, fin_by = bound(4 * strip.numel(), fin_bytes, PEAK_F32_FLOPS)
    flash["scores"]["finish"] = dict(
        name="window_scores_finish", launches=launches["window_scores_finish"], ms=ms,
        device_ms=fin_dev, device_ms_from=fin_from, plain_ms=plain_ms, bound_ms=fin_bound,
        bound_by=fin_by, library_ms=None,
        library_note="none: softmax and the sum over rows are two calls (plain_ms)",
        shape=f"strip b=1 H=32 W={W} s={s} float32 -> scores [1, 32, {s}]",
        flop=4 * strip.numel(), bytes=fin_bytes, **rates(4 * strip.numel(), ms, fin_bound))
    del q, k, v, q_win, strip, out_scores

    # flash prefill under Ministral-8B's window: FullKV's every layer, s =
    # 40960, W = 32768, all keys valid; the library call takes the band as an
    # explicit boolean mask
    s, W = 40960, 32768
    q, k, v, pos, cnt = flash_inputs(torch, 1, 32, 8, s, 128, s, bf16, gen)
    q_pos = pos.contiguous()
    k_pos = fp.fold_key_validity(pos, cnt).contiguous()
    kern = lambda: fp.launch(flash_lib, q, k, v, q_pos, k_pos, stream(), W)  # noqa: E731
    ms = events_ms(kern, reps=3, warmup=1)
    kern_dev, kern_from = device_ms(torch, kern, 2, FLASH_BF16)
    plain_ms = events_ms(lambda: fp.flash_attention_plain(q, k, v, pos, cnt, W),
                       reps=1, warmup=1)
    kp, qp = k_pos[:, None, None, :], q_pos[:, None, :, None]
    band = (kp <= qp) & (kp > qp - W)
    lib = layer_sdpa(q, k[None], v[None], band[None])
    lib_ms = events_ms(lib, reps=3, warmup=1)
    lib_dev, lib_from = device_ms(torch, lib, 2, "")
    flops, nbytes = flash_work(torch, q, k, v, pos, cnt, W)
    win_bound, win_by = bound(flops, nbytes)
    flash["window"] = dict(
        ms=ms, device_ms=kern_dev, plain_ms=plain_ms, bound_ms=win_bound, bound_by=win_by,
        library_ms=lib_ms, library_device_ms=lib_dev, device_ms_from=kern_from,
        library_device_ms_from=lib_from,
        shape=f"b=1 H=32 KH=8 s={s} d=128 bf16, sliding window {W}",
        flop=flops, bytes=nbytes, **rates(flops, ms, win_bound))
    del q, k, v, band, lib

    # flash prefill, rectangular: chunked admission's last 2048-row chunk of
    # an 8192-slot scratch at Llama-3.1-8B (start 6144, k_count = k_hi = 8192)
    S, c, start = 8192, 2048, 6144
    q, k, v, qpos, kpos, cnt, hi = rect_inputs(torch, 1, 32, 8, S, c, 128, [start], [S], [S],
                                               bf16, gen)
    k_fold = fp.fold_key_validity(kpos, torch.minimum(cnt, hi)).contiguous()
    kern = lambda: fp.launch(flash_lib, q, k, v, qpos, k_fold, stream(), 0, hi)  # noqa: E731
    ms = events_ms(kern, reps=10)
    kern_dev, kern_from = device_ms(torch, kern, 5, FLASH_BF16)
    plain_ms = events_ms(lambda: fp.flash_attention_plain(
        q, k, v, qpos, cnt, None, kpos, cnt, hi), reps=2, warmup=1)
    mask = k_fold[:, None, None, :] <= qpos[:, None, :, None]
    lib = layer_sdpa(q, k[None], v[None], mask[None])
    lib_ms = events_ms(lib, reps=10)
    lib_dev, lib_from = device_ms(torch, lib, 5, "")
    flops, nbytes = flash_work(torch, q, k, v, qpos, cnt, kpos=k_fold)
    rect_bound, rect_by = bound(flops, nbytes)
    flash["rect"] = dict(
        launches=launches["flash_prefill_rect"],
        ms=ms, device_ms=kern_dev, plain_ms=plain_ms, bound_ms=rect_bound, bound_by=rect_by,
        library_ms=lib_ms, library_device_ms=lib_dev, device_ms_from=kern_from,
        library_device_ms_from=lib_from,
        shape=f"b=1 H=32 KH=8 c={c} start={start} Sk={S} d=128 bf16, k_count = k_hi = {S}",
        flop=flops, bytes=nbytes, **rates(flops, ms, rect_bound))
    del q, k, v, mask, lib

    # decode: FastKV's cache at Llama-3.1-8B (C = 904 prefill + 128 decode
    # slots, 896 kept + 31 decoded valid per head), cycling over 32 layers so
    # each call reads its cache from device memory, as the decode step does
    C = 1032
    q, kc, vc, valid = decode_inputs(torch, 32, 1, 32, 8, C, 128, 896, bf16, gen)
    plan = da.split_plan(1, 8, 4, C, build.num_sms(q.device))
    mask = valid[:, :, :, None, :].repeat_interleave(4, dim=2)
    decode = dict(
        name="decode_attn", route="cuda",
        source="fastkv_tpu_torch/kernels/csrc/decode_attn.cu",
        replaces="fastkv_tpu/ops/experimental/decode_attn.py:231",
        launches=launches["decode_attn"], max_abs_err=err["decode_attn"],
        launches_by_path={p: n["decode_attn"] for p, n in launches_by_path.items()},
        **decode_timing(torch, decode_lib, q, kc, vc, valid, plan, mask, reps=4),
        shape=f"b=1 H=32 CH=8 C={C} d=128 bf16, 927 valid slots/head")
    del mask

    # the same cache stored int8 with its per-slot scales (kv_int8)
    ki, ks = quant.quantize_kv(kc)
    vi, vs = quant.quantize_kv(vc)
    del kc, vc
    decode["int8"] = dict(
        launches=launches["decode_attn_int8"],
        max_abs_err=max(c["max_abs_err"] for c in cases if c.get("form") == "int8"),
        **decode_timing(torch, decode_lib, q, ki, vi, valid, plan, None, reps=4,
                        scales=(ks, vs)),
        library_note="none: sdpa takes no int8 cache with per-slot scales; it needs a "
                     "dequantized copy, which the port never makes",
        shape=f"b=1 H=32 CH=8 C={C} d=128, bf16 q, int8 K/V + float32 scales, 927 valid "
              f"slots/head")
    decode["int8"]["at_or_below_bf16_same_shape"] = (
        decode["int8"]["device_ms"] <= decode["device_ms"])
    del q, ki, vi, ks, vs, valid

    # the Scheduler's decode at SnapKV's layout: four slots, a per-query-head
    # cache (CH = H = 32, g = 1), each example with its own mask; four layers
    # of 67 MB each, more than the L2, cycled
    q, kc, vc, valid = decode_inputs(torch, 4, 4, 32, 32, C, 128, 896, bf16, gen)
    plan = da.split_plan(4, 32, 1, C, build.num_sms(q.device))
    decode["snapkv_b4"] = dict(
        **decode_timing(torch, decode_lib, q, kc, vc, valid, plan, valid[:, :, :, None, :],
                        reps=8),
        shape=f"b=4 H=32 CH=32 C={C} d=128 bf16, 927 valid slots/head")
    del q, kc, vc, valid

    # FullKV's cache at Llama-3.1-8B after the last step (8192 + 31 valid of
    # 8320 slots a head); four layers of 34 MB, cycled
    Cf = 8192 + 128
    q, kc, vc, valid = decode_inputs(torch, 4, 1, 32, 8, Cf, 128, 8192, bf16, gen)
    plan = da.split_plan(1, 8, 4, Cf, build.num_sms(q.device))
    decode["fullkv_C8320"] = dict(
        **decode_timing(torch, decode_lib, q, kc, vc, valid, plan,
                        valid[:, :, :, None, :].repeat_interleave(4, dim=2), reps=4),
        shape=f"b=1 H=32 CH=8 C={Cf} d=128 bf16, 8223 valid slots/head")
    del q, kc, vc, valid

    # Ministral-8B's FullKV cache after the last step (40960 kept + 31 decode
    # slots), as decode hands it over: the [b, CH, C] mask of the window's
    # rank cut (the last 32768 valid entries); two layers of 168 MB, cycled.
    # The kernel never reads the first ~8K slots, which the cut hides
    Cw, W = 40960 + 128, 32768
    q, kc, vc, valid = decode_inputs(torch, 2, 1, 32, 8, Cw, 128, 40960, bf16, gen)
    plan = da.split_plan(1, 8, 4, Cw, build.num_sms(q.device))
    cut = torch.stack([dm.window_mask(valid[l], W) for l in range(2)])
    decode["ministral_rank_cut_C41088"] = dict(
        **decode_timing(torch, decode_lib, q, kc, vc, cut, plan,
                        cut[:, :, :, None, :].repeat_interleave(4, dim=2), reps=4),
        shape=f"b=1 H=32 CH=8 C={Cw} d=128 bf16, rank cut to {W}: "
              f"{int(cut[0, 0, 0].sum())} visible slots/head")
    del cut

    # the kernel's own window term on the same cache, slot c at position c,
    # W = 32768. No engine path passes it (decode cuts the window by rank)
    k_pos = torch.arange(Cw, dtype=torch.int32, device="cuda").expand(2, 1, 8, Cw).contiguous()
    q_pos = torch.full((1,), Cw - 128 + 31, dtype=torch.int32, device="cuda")
    band = valid & (k_pos > q_pos[None, :, None, None] - W)  # [L, b, CH, C]
    decode["window"] = dict(
        launches=launches["decode_attn_window"],
        max_abs_err=max(c["max_abs_err"] for c in cases if c.get("form") == "window"),
        **decode_timing(torch, decode_lib, q, kc, vc, valid, plan,
                        band[:, :, :, None, :].repeat_interleave(4, dim=2), reps=4,
                        window=(q_pos, k_pos, W)),
        shape=f"b=1 H=32 CH=8 C={Cw} d=128 bf16, window {W} by position, "
              f"{int(band[0, 0, 0].sum())} visible slots/head")
    del q, kc, vc, valid, k_pos, band
    return [flash, decode]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from fastkv_tpu_torch.kernels import build

    gpu = gpu_line()
    print(gpu, flush=True)
    t_start = t0 = time.perf_counter()
    paths = build.build()
    ptxas = {n: [ln.strip() for ln in build.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln] for n in paths}
    # the bf16 flash kernel's instantiations (the tensor-core kernel, which
    # raises its consumers' registers with setmaxnreg; two head dims x six
    # forms) must not spill
    spills = {k: v for k, v in ptxas_spills(build.build_log("flash_prefill")).items()
              if FLASH_BF16 in k}
    # and so must the decode kernel's bf16 and int8 instantiations (two head
    # dims x bf16/int8 cache x with/without the window term)
    decode_spills = {k: v for k, v in ptxas_spills(build.build_log("decode_attn")).items()
                     if DECODE_TC in k}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {n: str(p.name) for n, p in paths.items()}, "ptxas": ptxas,
          "flash_bf16_spills": spills, "decode_tc_spills": decode_spills})
    check(len(spills) == 12 and all(v == [0, 0] for v in spills.values()),
          f"the bf16 flash kernel's ptxas report shows spills or misses instantiations: {spills}")
    check(len(decode_spills) == 8 and all(v == [0, 0] for v in decode_spills.values()),
          f"the decode kernel's ptxas report shows spills or misses instantiations: "
          f"{decode_spills}")
    cases, flash_lib, decode_lib = phase_kernels_vs_plain(torch)
    phase_tiny_card_vs_cpu(torch)
    from fastkv_tpu_torch.core.config import ModelConfig

    by_path = phase_full_width(torch, gpu)[0]
    by_path.update(phase_int8(torch, gpu))
    by_path.update(phase_serve(torch, gpu))
    # Ministral-8B: 40960 tokens, longer than its 32768 window, so the window
    # masks 8192 query rows in prefill and cuts FullKV's decode cache
    by_path["ministral_8b"] = phase_mistral(
        torch, gpu, "ministral", ModelConfig.ministral_8b(), 40960, tsp_idx=17)
    by_path["mistral_nemo_12b"] = phase_mistral(
        torch, gpu, "nemo", ModelConfig.mistral_nemo_12b(), 8192, tsp_idx=19)
    launches = {k: sum(n.get(k, 0) for n in by_path.values()) for k in LAUNCH_KEYS}
    kernels = phase_timings(torch, cases, flash_lib, decode_lib, launches, by_path)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
