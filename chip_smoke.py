#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fastkv_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, each printing one JSON line (any failure raises and exits nonzero):
  build   compile every CUDA kernel from ``fastkv_tpu_torch/kernels/csrc``
          (one nvcc per source, all at once) and print the ptxas report;
          the bf16 flash kernel's twenty-one instantiations (two head dims x
          ten forms: square, rectangular and fused scores, each with and
          without the window, and the square and rectangular forms with the
          (m, l) row statistics; and the causal square at q/k width 192, v
          width 128, DeepSeek-V2's latent attention) and the decode
          kernel's eight bf16 and int8 ones (two head dims x bf16/int8
          cache x with/without its window term) must
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
          and at batch 4 with per-example masks; and at the shapes the H2O
          and GemFilter paths give them: flash at GemFilter's pass-2 bucket
          (s = 896, count 819), decode on H2O's per-query-head cache at
          batch 1 and on GemFilter's FullKV cache of 896 + 128 slots; and flash
          at PyramidInfer's layers (PYRAMID_FLASH: s = 2048, 256 and 5376,
          each a gathered layout with a count below s); the flash kernel's
          row statistics (o, m and l each held per row, ``agreement.
          compare_stats`` for m and l): the 'full' pattern at Llama-3.1-8B's
          ring chunk (4096 queries against the 4096 keys before them), a
          ragged batch whose second chunk holds no valid key (rows that see
          no key: o = 0, m = -1e30, l = 0), Ministral-8B's 20480-token chunks
          under its 32768 window (the window's edge inside the chunk), the
          square local step at Llama width, and a float32 ragged batch; and
          a model-2 rank's shapes (flash H = 16, KH = 4 at s = 8192;
          decode CH = 4 at C = 1032 and 8320); the headline benchmark's
          shapes at Llama-3.2-1B (head_dim 64, 229376 tokens: flash's
          square form on one GQA group, FastKV's post-TSP layers, the fused
          scores at the fusion A/B's 98304 tokens on one GQA group, decode
          over FullKV's and FastKV's caches after 127 decode steps); and
          the ring's arithmetic in one process: an 8192-token Llama-width
          sequence split into P = 2 and 4 chunks, ring steps (local step,
          earlier chunks in the 'full' pattern, merged by the statistics)
          against the square kernel over the whole sequence; and the
          q/k 192, v 128 square at DeepSeek-V2-Lite's shapes (H = 16, its
          softmax scale, k and v views into the ``kv_b`` output as its
          prefill hands them over): s = 32768 with 24576 valid and a ragged
          batch of two at s = 8192, each with its ms and bound, and at
          DeepSeek-V3's (H = 128, scale 0.1352) at s = 32768, 24576 valid;
  tiny_serve_paths_card_vs_cpu
          the tiny config in float32: a FrontDoor over two replicas and a
          Coordinator with two worker threads on the card give the port's
          single Scheduler's tokens on the CPU;
  tiny_card_vs_cpu
          the tiny config in float32, without and with a sliding window:
          FastKV (maxpool) prefill and Engine.generate, and the Scheduler
          with chunked admission for FastKV and SnapKV, on the card against
          the port on the CPU; H2O (prefill, its kept sets) and GemFilter
          (its selected tokens, pass 2) the same way, through
          Engine.generate and through the Scheduler with prefill_chunk set
          (both admit whole); PyramidInfer (llama_35, exceed 4, so decode
          evicts): the prefill with its decode state and four decode steps
          (logits, each layer's kept positions and validity, past/live,
          probs), Engine.generate and the Scheduler (admits whole);
  sp_tiny_card_vs_cpu
          the tiny config (head_dim 64) in float32 as two ranks sharing the
          card (a gloo world of spawned processes; ``parallel.comm`` stages
          the collectives' bytes through pinned host memory), ring and
          Ulysses at seq 2, FastKV, FullKV and H2O (its kept sets in
          position order): the SP prefill and
          Engine.generate on each rank against the port's single-process run
          on the CPU (tokens equal, cache positions and validity equal,
          logits within 1e-3), the ring's launches of the 'full' form on
          rank 1 and none on rank 0;
  tp_tiny_card_vs_cpu
          the tiny config (head_dim 64) in float32 as four ranks sharing the
          card over gloo, data 2 x model 2 and model 2 x pipe 2, every method
          (GemFilter filter_idx 2, PyramidInfer llama_35 with exceed 4): each
          rank's prefill (its cache slice: its replica's rows, its model
          rank's heads, its stage's layers) and Engine.generate against the
          port's single process on the CPU (kept positions and validity equal,
          H2O's in position order; logits within 1e-3 and bit-identical across
          a replica's ranks; tokens equal), each rank's launches exactly its
          stage's layers (flash per prefill, decode per step);
  sp_full_width_<mode>_<method>
          Llama-3.1-8B at full width and depth as two ranks sharing the card
          (each makes the random bf16 weights from the seed, this script
          frees its own first), seq 2, ring and Ulysses, FastKV and FullKV:
          a warm-up SP prefill (its cache), then one counted Engine.generate
          on the 8192-token prompt, 32 new tokens; each rank's launches must
          equal what the path calls (ring FastKV at tsp_idx 15: 16 'full'
          launches on rank 1, none on rank 0), its prefill seconds, decode
          ms per token and peak memory; the shares of tokens and of kept
          cache positions equal to the single-process generate (rank 0),
          reported, not demanded (bf16 sums in another order); one SP
          prefill per rank under the profiler (host ms, this rank's
          device-busy ms, idle share, flash ms). Both ranks share one card:
          the seconds say nothing of SP's speed;
  full_width_<method>
          Engine.generate at Llama-3.1-8B width (random bf16 weights made on
          the card from a seed, one 8192-token prompt, 32 new tokens) for
          FullKV, FastKV, H2O and GemFilter (filter_idx 13) at the canonical
          settings, after a warm-up of a prefill and four decode steps;
          every launch counter is set to 0 just before the first generate
          and read just after, and both kernels must have launched as often
          as the path calls them (GemFilter's flash: 13 layers of pass 1
          and 32 of pass 2); two more generates per method, the
          methods alternating, give the median and spread of prefill seconds
          (GemFilter's each pass too)
          and decode ms per token, each window with this thread's CPU share,
          involuntary context switches and garbage-collector seconds, and
          two probes of the host's speed taken just before it;
  profile_<method>
          one prefill and eight decode steps under torch.profiler: host ms,
          device-busy ms, idle share and the top kernels; H2O's prefill
          also with h2o_scores' device ms (CUDA events around each call)
          beside the flash kernel's and the GEMMs', GemFilter's two passes
          each in a window of its own;
  full_width_pyramidinfer_<config>, profile_pyramidinfer_<config>
          PyramidInfer at Llama-3.1-8B width on the same prompt with the
          shipped llama_60 and llama_35 configs: a counted generate each
          (flash 32, decode kernel 0: pyramid decode attends in plain torch;
          the prologue 32 a decode step, as on every path), three
          windows each alternating with FullKV's (whose prefill seconds are
          printed beside), peak memory, each layer's valid count against its
          planned capacity; one prefill under the profiler with
          ``_rows_probs``' device ms (the kernels inside its range's spans
          on the device's timeline) beside flash and the GEMMs, and CUDA
          events around each call (host and device); eight decode steps;
  tp_full_width_<mesh>_<method>
          (inside checkpoint_and_clis, while its checkpoint exists) four
          ranks sharing the card, each loading only its shard of the
          Llama-3.1-8B checkpoint (``load_params(mesh=)``): FastKV and FullKV
          at data 2 x model 2 (two replicas of a TP pair), FastKV at model 2 x
          pipe 2, H2O under the ring at seq 2 x model 2; one counted
          Engine.generate of the 8192-token prompt, 8 new tokens; each rank's launches must equal what its
          path calls and every rank's tokens must be equal; reported: each
          rank's load seconds, shard bytes, prefill seconds, decode ms per
          token, peak memory, a profiled prefill (host ms, device-busy ms,
          idle share, flash, GEMM and memcpy ms: the gloo staging; its cache's
          kept positions), the shares of tokens and of kept positions (each
          head's set, in position order) equal to the single process's
          (full_width); four ranks on one card: the seconds say nothing of
          TP's or PP's speed;
  checkpoint_and_clis, latency_cli, evals, throughput_cli
          Llama-3.1-8B at full width and depth: the SEED params of
          full_width written as an HF bf16 checkpoint (~16.06 GB: 4 shards
          of at most 5 GB and an index, by the port's own safetensors
          writer) into a temporary directory (/dev/shm when it has room;
          removed at the end), loaded back with ``load_params`` (every leaf
          torch.equal; write and load seconds and GB/s), FastKV and FullKV
          ``Engine.generate`` from the loaded params with the in-memory
          params' tokens (counted: flash 2 x 32, decode 2 x 32 x 31); the
          latency CLI in process (``bench.latency.main``, prefill and e2e,
          FastKV and FullKV, 8192 tokens, 32 new, 3 runs: the JSON keys and
          an int ``peak_mem`` above the weights' bytes; counted); the
          LongBench (two multifieldqa_en examples of ~6000 tokens), RULER
          (two niah_single_1 examples under 8192/) and needle (context
          8000, depth 50) runners and scorers on synthetic files, with a
          byte-level stand-in tokenizer (``ByteTokenizer``: the machine has
          no ``transformers``), counted; then the throughput CLI as a
          subprocess (batches 1, 4, 16 at 8192 tokens, 16 new; one
          subprocess per method) with its tok/s lines;
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
  dsv3_ep32_<method>
          Engine.generate, FastKV (tsp_idx 14) and FullKV, at DeepSeek-V3's
          share of EP32 (the benchmark's configuration: 30 layers, MLA over
          128 heads with a query LoRA, 8 of 256 experts held; 38.8 GB of
          random bf16 weights) on one 8192-token prompt, 32 new tokens, each
          counted: flash once a layer, the decode prologue once a layer a
          step, the norm kernel three times (its two sites and the query
          LoRA's norm), the decode kernel never (absorbed attention);
  serve_<method>
          the continuous-batching Scheduler at Llama-3.1-8B width (random
          bf16 weights from a seed): four decode slots, bucket 8192, six
          requests of 2500-8192 tokens with budgets of 8-32 tokens; the first
          four admit at once, the last two chunk-wise (2048-token chunks)
          while the others decode; FastKV, FullKV, SnapKV and StreamingLLM,
          and FastKV once more with monolithic admission; H2O and GemFilter
          with the same prefill_chunk, every admission whole; PyramidInfer
          (llama_60) the same way (``serve_pyramidinfer_llama_60``, its
          admissions at the one bucket). Each run counted
          (counters set to 0 just before it, read just after), with its
          event counts, per-request TTFT and TPOT, the inter-token gaps of
          running requests, wall seconds and peak memory;
  profile_serve
          a batch-4 decode step, the last chunk of an 8000-token admission
          and its finish under the profiler;
  serve_front_door
          ``local_front_door`` over two Scheduler replicas at Llama-3.1-8B
          width (one params dict; each replica FastKV at the canonical point,
          four slots, bucket 8192, 2048-token chunks, 32 new tokens) on the
          six requests, each replica on its own thread: healthy (both serve),
          replica 0 raising at its drain's start (everything completes on
          replica 1, its tickets re-admitted) and replica 0 wedged (its drain
          sleeps; the survivor warmed first; the drain timeout marks it dead
          with a TimeoutError). Each run counted: the flash and decode
          launches must equal what the replicas' events call for, every
          decode arrival counter must be zero after it, no replica but the
          injected one may die; reported: wall, TTFT/TPOT, gaps, the share of
          tokens equal to one Scheduler(max_batch=4) over the same requests
          (and its wall), the device's idle share over a profiled healthy run;
  serve_dispatch
          a Coordinator on the loopback and two serve_worker threads, each
          over its own Scheduler, pull the six requests (both must serve);
          then one worker streams: a request of budget 200, a second
          submitted after its third decode step, admitted between decode
          steps ("DAD" in the trace); launches as called, counters zero, the
          leases that expired reported;
  long_prompt_mlp_chunk
          Llama-3.1-8B, one 131072-token prompt, 32 new tokens, tsp_idx 15:
          FastKV with the MLP chunked (auto: 32768) and unchunked
          (mlp_chunk=0), FullKV with the default; prefill seconds, decode ms
          per token, peak memory and launches of each generate; the peak
          chunked must be below the peak unchunked; reported: equal tokens
          and the largest prefill logit difference between the two;
  headline_int8w, headline_bf16
          the headline benchmark (``python -m fastkv_tpu_torch.bench.headline``,
          a subprocess whose ladder rungs are subprocesses of their own,
          after this process's memory is freed): its defaults (Llama-3.2-1B,
          int8 weights, the ladder from 229376 tokens, 128 new tokens, the
          fusion A/B at 98304) and bf16 weights at 131072 without the A/B.
          The line must come from the top rung (229376 / 131072) with a
          positive value; each method's launches (the rung's own counters)
          must equal what its prefills and decodes call for and sum to the
          rung's; every decode arrival counter zero. Reported: each method's
          prefill and decode seconds (mean, median, every run), the ratios,
          the bytes a decode step reads, the speedup ceiling, the implied
          read GB/s, peak memory, the fusion A/B;
  profile_headline_<method>
          a decode step at the top rung in this process (int8 weights):
          eight greedy decode steps over a FullKV and a FastKV cache of the
          rung's shapes (zeros, the kept slots valid) under the profiler
          (host ms, device-busy ms, idle share, top kernels, the decode
          kernel's ms a step);
  total   the seconds the script took, the build included;
  kernels one line with each kernel's launches (over every counted
          generate), error, time at the main-path shape, its bound, the plain
          version's time and one PyTorch library call's time for the same
          function (a yardstick only: the port never calls it); the prefill
          kernel's entry also carries the same readings under Ministral-8B's
          window (``window``), in its rectangular form at Llama-3.1-8B's
          last 2048-token chunk of an 8192-slot scratch (``rect``) and in
          its fused-scores form (``scores``, with its finishing pass) and at
          GemFilter's pass-2 bucket (``gemfilter_pass2_s896``) and at
          PyramidInfer's layers (``pyramid_s<s>_count<n>``), each
          flash form and the finishing pass with its achieved TFLOP/s and
          its share of its bound; the decode entry is FastKV's cache at
          Llama-3.1-8B (b = 1, C = 1032) and carries the int8 cache at that
          shape (``int8``), SnapKV's at batch 4 (``snapkv_b4``), H2O's at
          batch 1 (``h2o_b1_CH32``), GemFilter's (``gemfilter_C1024``),
          FullKV's (``fullkv_C8320``), Ministral-8B's FullKV cache under
          the rank cut (``ministral_rank_cut_C41088``) and its own window
          term on that
          cache (``window``), each with its split, its bound, its share of
          it by device time and, where sdpa computes the same function,
          whether it is at or below sdpa's device time; the flash entry's
          ``full_aux`` is the 'full' pattern with the row statistics at
          Llama-3.1-8B's ring chunk (4096 queries against the preceding
          4096 keys), its launches those of the SP phases, its library call
          sdpa with no mask over the same chunk (which returns no (m, l));
          a model-2 rank's shapes (``tp2_H16_KH4_s8192``; decode's
          ``tp2_fastkv_CH4_C1032`` and ``tp2_fullkv_CH4_C8320``, their
          launches those of tp_full_width); the shapes of the 131072-token
          prompt: flash's ``square_s131072``
          (its plain version timed on one GQA group, sdpa with is_causal)
          and decode's ``fastkv_128k_C13320`` and ``fullkv_128k_C131200``;
          the headline's shapes at Llama-3.2-1B: flash's
          ``square_1b_s229376`` and decode's ``fastkv_1b_C23176`` and
          ``fullkv_1b_C229504``. The library call of every causal square
          or rectangular form whose keys are all valid is sdpa with no
          explicit mask (``is_causal=True``; the rectangular chunk, the last
          of its keys, the lower-right causal bias), K/V by enable_gqa or
          repeated beforehand, the faster, with the backend sdpa took
          (``library_backend``, from the kernels the profiler recorded);
          the explicit-mask call stays beside it (``library_masked_ms``).
Every phase's line carries the seconds since the start (``t_s``).
The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import bisect
import gc
import json
import os
import re
import subprocess
import sys
import threading
import time

from fastkv_tpu_torch.kernels.timing import (PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_F32_FLOPS,
                                             events_ms, flash_work, graph_ms, layer_sdpa,
                                             ptxas_spills, sdpa_backend, sdpa_causal,
                                             sdpa_choice)
from fastkv_tpu_torch.ops.decode_attn import counters_at_rest
from fastkv_tpu_torch.utils.timing import gpu_line

SEED = 0
T_START = time.perf_counter()
# timed windows after the counted generate, the methods alternating: with
# the counted one, a median of three
MORE_WINDOWS = 2
# the kernels' names in profiler windows (device_ms): the bf16 flash kernel,
# and the finishing pass's two kernels
FLASH_BF16 = "flash_prefill_sm90_kernel"
FINISH = ("window_row_stats_kernel", "window_col_sums_kernel")
# the decode kernel of bf16 q (a bf16 or int8 cache), one launch a call
DECODE_TC = "decode_attn_tc_kernel"


def emit(obj) -> None:
    """One JSON line; a phase's line also carries the seconds since the
    script started (``t_s``)."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def profile_window(torch, fn, counts=None, ranges=None):
    """Run fn once under the torch profiler. Returns (host ms under the
    profiler, {kernel name: device ms}); the dict is empty where the profiler
    records no device activity. ``counts``, if given, receives {kernel name:
    instances recorded}. ``ranges``, if given, maps the names of
    ``torch.profiler.record_function`` ranges that fn opens to [calls, device
    ms of the kernels launched inside them (the profiler's attribution of
    each kernel to the op that launched it; the device's idle gaps inside a
    range are not in it), and by timestamps: the summed and the merged ms of
    the kernels that start inside the range's spans on the device's
    timeline (None where the profiler records no such span), and the number
    of those spans]."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    per_kernel, spans, kernels = {}, {}, []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if getattr(e, "is_user_annotation", False) or (ranges and e.name in ranges):
                # a range's span on the device's timeline, not a kernel
                spans.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
                continue
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            kernels.append((e.time_range.start, e.time_range.end))
            if counts is not None:
                counts[e.name] = counts.get(e.name, 0) + 1
        elif ranges and e.name in ranges:
            ranges[e.name][0] += 1
            ranges[e.name][1] += e.device_time_total / 1e3
    for name in ranges or ():
        found = sorted(spans.get(name, []))
        ranges[name][2:] = [*kernels_in_spans(found, sorted(kernels)), len(found)]
    return wall_ms, per_kernel


def kernels_in_spans(spans, kernels):
    """(summed ms, merged ms) of the kernels (sorted (start, end) in us) that
    start inside one of the sorted spans; (None, None) without spans."""
    if not spans:
        return [None, None]
    starts = [a for a, _ in spans]
    total = merged = 0.0
    reach = float("-inf")
    for k0, k1 in kernels:
        i = bisect.bisect_right(starts, k0) - 1
        if i < 0 or k0 >= spans[i][1]:
            continue
        total += k1 - k0
        merged += max(0.0, k1 - max(k0, reach))
        reach = max(reach, k1)
    return [total / 1e3, merged / 1e3]


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


# PyramidInfer's layers at Llama-3.1-8B and bucket 8192 (capacity, count):
# the deepest llama_60 layer, the deepest llama_35 layer, a middle llama_60 one
PYRAMID_FLASH = ((2048, 1833), (256, 163), (5376, 5051))


def pyramid_flash_inputs(torch, s, count, gen):
    """Llama-3.1-8B heads at a pyramid layer's capacity ``s``: ``count``
    ascending original positions below 8192, then a zero tail, as a
    compressing layer's gather leaves them."""
    q, k, v, pos, cnt = flash_inputs(torch, 1, 32, 8, s, 128, count, torch.bfloat16, gen)
    pos.zero_()
    pos[0, :count] = torch.randperm(8192, generator=gen, device="cuda")[:count].sort().values
    return q, k, v, pos, cnt


def decode_inputs(torch, L, b, H, CH, C, d, n_kept, dtype, gen, decoded=31):
    """L layers of a cache of C slots: n_kept kept prompt slots scattered over
    the prefill part and ``decoded`` decode slots (31: after the last step of
    the main path's 32 new tokens), the decode part 128 slots."""
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
    valid[..., prefill_cap:prefill_cap + decoded] = True
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


def bf16_ulps(torch, got, want) -> float:
    """The largest |got - want| in units of want's last place in bf16."""
    w = want.float()
    step = torch.ldexp(torch.ones_like(w), torch.floor(torch.log2(w.abs().clamp_min(1e-30))).int()
                       - 7)
    return float(((got.float() - w).abs() / step).max())


# a norm site's widths: (case prefix, D) of the decode cells' models
NORM_WIDTHS = (("dsv2lite", 2048), ("ministral8b", 4096), ("nemo12b", 5120))


def norm_cases(torch) -> list:
    """A decode layer's norm sites (``ops.add_rms_norm``) at the models'
    widths, b 1 and the Scheduler's 8, bf16, against the plain version run
    on the card (PyTorch's composition): the residual of the add form bit for
    bit, both forms' norms within one bf16 ulp (the sum of squares taken in
    another order). ms: CUDA graphs of 4 x 40 calls of the add form, of the
    norm form (``norm_ms``) and of their plain versions (``plain_ms``,
    ``plain_norm_ms``); the bound: the add form's bytes (x and delta read, h
    and the norm written, w) over the card's rate."""
    from fastkv_tpu_torch.ops import add_rms_norm as arn

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    bf16, eps, out = torch.bfloat16, 1e-5, []
    for tag, D in NORM_WIDTHS:
        for b in (1, 8):
            h = (torch.randn((b, 1, D), generator=gen, device="cuda") * 4).to(bf16)
            delta = torch.randn((b, 1, D), generator=gen, device="cuda").to(bf16)
            w = torch.rand((D,), generator=gen, device="cuda") + 0.5
            before = arn.launches
            got_h, got = arn.add_rms_norm(h, delta, w, eps)
            got_n = arn.rms_norm(h, w, eps)
            torch.cuda.synchronize()
            launched = arn.launches - before
            want_h, want = arn.add_rms_norm_plain(h, delta, w, eps)
            want_n = arn.rms_norm_plain(h, w, eps)
            exact = torch.equal(got_h, want_h)
            ulp = max(bf16_ulps(torch, got, want), bf16_ulps(torch, got_n, want_n))
            ms = graph_ms(lambda: arn.add_rms_norm(h, delta, w, eps), 4 * 40)
            norm_ms = graph_ms(lambda: arn.rms_norm(h, w, eps), 4 * 40)
            plain_ms = graph_ms(lambda: arn.add_rms_norm_plain(h, delta, w, eps), 4 * 40)
            plain_norm_ms = graph_ms(lambda: arn.rms_norm_plain(h, w, eps), 4 * 40)
            nbytes = 4 * 2 * b * D + 4 * D
            bound_ms = nbytes / PEAK_BYTES * 1e3
            out.append(dict(kernel="add_rms_norm", case=f"{tag}_add_rms_norm_b{b}", D=D, b=b,
                            dtype=str(bf16), bitwise=exact, max_ulp=ulp, launches=launched,
                            ms=ms, norm_ms=norm_ms, plain_ms=plain_ms,
                            plain_norm_ms=plain_norm_ms, bytes=nbytes, bound_ms=bound_ms,
                            bound_by="bytes", bound_share=bound_ms / ms,
                            max_abs_err=max(float((a.float() - r.float()).abs().max())
                                            for a, r in ((got, want), (got_n, want_n))),
                            ok=exact and launched == 2 and ulp <= 1.0))
    emit({"phase": "norm_kernel", "cases": out})
    return out


def dsv3_config():
    """DeepSeek-V3 at one chip's share of EP32, as the benchmark's
    configuration file gives it (30 layers, 8 of 256 experts held)."""
    from fastkv_tpu_torch.core.config import ModelConfig

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "perfbench", "configs",
                        "deepseek-v3-ep32.json")
    with open(path) as f:
        conf = json.load(f)
    return ModelConfig.from_hf_config(conf["model"], name=conf["name"])


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

    def flash_case(name, b, H, KH, s, d, count, dtype, scattered=False, window=None,
                   time_plain=False, plain_heads=None):
        """``time_plain``: the plain version's ms by CUDA events (one call of
        seconds, which the kernels line reuses rather than repeating).
        ``plain_heads``: the kernel's output is held on its first query heads
        only, against the plain version over them and their kv heads (heads
        are independent; at s = 229376 one head keeps the plain version to
        seconds)."""
        q, k, v, pos, cnt = flash_inputs(torch, b, H, KH, s, d, count, dtype, gen, scattered)
        out = fp.flash_attention(q, k, v, pos, cnt, window)
        if plain_heads is not None:
            kv_heads = -(-plain_heads // (H // KH))
            out, q, k, v = (out[:, :plain_heads], q[:, :plain_heads], k[:, :kv_heads],
                            v[:, :kv_heads])
        plain = lambda: fp.flash_attention_plain(q.float(), k.float(), v.float(), pos,  # noqa: E731
                                                 cnt, window)
        extra = {}
        if time_plain:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            ref = plain()
            ev[1].record()
            torch.cuda.synchronize()
            extra["plain_ms"] = ev[0].elapsed_time(ev[1])
        else:
            ref = plain()
        record("flash_prefill", name, [b, H, KH, s, d], dtype, out, ref, count=count,
               window=window, **extra)

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

    def decode_case(name, b, H, CH, C, d, n_kept, dtype, window=None, decoded=31):
        q, k, v, valid = decode_inputs(torch, 1, b, H, CH, C, d, n_kept, dtype, gen, decoded)
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
    # H2O and GemFilter at Llama-3.1-8B: GemFilter's pass-2 bucket (896 =
    # seven query tiles, 819 valid: 0.1 of 8192); H2O's per-query-head cache
    # at batch 1 (819 kept + 8 window slots of 904, and 128 decode slots);
    # GemFilter's FullKV cache of the reduced prompt (896 + 128 slots)
    flash_case("8b_gemfilter_pass2_s896", 1, 32, 8, 896, 128, 819, bf16)
    decode_case("8b_h2o_b1_CH32_C1032", 1, 32, 32, 1032, 128, 827, bf16)
    decode_case("8b_gemfilter_C1024", 1, 32, 8, 1024, 128, 819, bf16)
    # PyramidInfer at Llama-3.1-8B, bucket 8192: the square form over a
    # gathered layout at the deepest llama_60 layer, the deepest llama_35 one
    # and a middle llama_60 one (PYRAMID_FLASH)
    for s, count in PYRAMID_FLASH:
        q, k, v, pos, cnt = pyramid_flash_inputs(torch, s, count, gen)
        out = fp.flash_attention(q, k, v, pos, cnt)
        ref = fp.flash_attention_plain(q.float(), k.float(), v.float(), pos, cnt)
        record("flash_prefill", f"8b_pyramid_s{s}_count{count}", [1, 32, 8, s, 128], bf16,
               out, ref, count=count, form="pyramid")
    # the throughput CLI's top rung at Llama-3.1-8B: batch 16, each example
    # with its own mask and cache, FastKV's and FullKV's
    decode_case("8b_fastkv_b16_C1032", 16, 32, 8, 1032, 128, 896, bf16)
    decode_case("8b_fullkv_b16_C8320", 16, 32, 8, 8320, 128, 8192, bf16)
    # a rank's shapes at tensor parallelism 2 (tp_full_width): half the query
    # and kv heads, flash over the whole prompt, decode over FastKV's and
    # FullKV's caches of four heads
    flash_case("8b_tp2_H16_KH4_s8192", 1, 16, 4, 8192, 128, 8192 - 77, bf16)
    decode_case("8b_tp2_fastkv_CH4_C1032", 1, 16, 4, 1032, 128, 896, bf16)
    decode_case("8b_tp2_fullkv_CH4_C8320", 1, 16, 4, 8320, 128, 8192, bf16)
    # the 131072-token prompt (long_prompt_mlp_chunk): flash's square form on
    # one GQA group (one kv head and its 4 query heads; heads are
    # independent, so the same function at 1/8 of the work, which keeps the
    # plain version to seconds), decode over FastKV's and FullKV's caches
    flash_case("8b_s131072_one_gqa_group", 1, 4, 1, LONG_PROMPT, 128, LONG_PROMPT, bf16,
               time_plain=True)
    fast_c = long_prompt_fastkv_capacity()
    decode_case(f"8b_fastkv_128k_C{fast_c}", 1, 32, 8, fast_c, 128, fast_c - 136, bf16)
    decode_case(f"8b_fullkv_128k_C{LONG_PROMPT + 128}", 1, 32, 8, LONG_PROMPT + 128, 128,
                LONG_PROMPT, bf16)
    # the headline benchmark (bench.headline) at Llama-3.2-1B width, head_dim
    # 64, 229376 tokens: flash's square form on one GQA group (held on its
    # first query head), FastKV's
    # post-TSP layers (45867 of 45952 rows, scattered positions), the fused
    # scores of the fusion A/B at 98304 tokens on one GQA group; decode after
    # the last of 128 new tokens over FullKV's and FastKV's caches
    hs = headline_shapes()
    flash_case(f"1b_s{HEADLINE_CTX}_one_gqa_group", 1, 4, 1, HEADLINE_CTX, 64, HEADLINE_CTX, bf16,
               time_plain=True, plain_heads=1)
    flash_case(f"1b_post_tsp_s{hs['fastkv'].tsp_capacity}", 1, 32, 8, hs["fastkv"].tsp_capacity,
               64, HEADLINE_TSP_COUNT, bf16, scattered=True)
    scores_case("1b_fused_s98304_one_gqa_group", 1, 4, 1, 98304, 64, 98304, 8, bf16)
    for m, kept in (("fullkv", HEADLINE_CTX), ("fastkv", HEADLINE_FAST_KEPT)):
        C = hs[m].total_capacity
        decode_case(f"1b_{m}_C{C}", 1, 32, 8, C, 64, kept, bf16, decoded=HEADLINE_GEN - 1)
    from fastkv_tpu_torch.parallel import ring_attention as ra

    def aux_case(name, b, H, KH, s, d, q0, count, k_count, dtype, pattern="full",
                 window=None):
        """The row statistics: s queries at positions q0, q0 + 1, ... against
        s keys, as ring attention calls the kernel: 'full', an earlier chunk
        (keys at 0, 1, ...), or 'causal', the local step (the square form
        over the queries' own chunk with its key count). o is held as every
        output, m and l by ``agreement.compare_stats``."""
        dev = "cuda"
        q = torch.randn((b, H, s, d), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, s, KH, d), generator=gen, device=dev).to(dtype).transpose(1, 2)
        v = torch.randn((b, s, KH, d), generator=gen, device=dev).to(dtype).transpose(1, 2)
        qpos = (q0 + torch.arange(s, dtype=torch.int32, device=dev))[None].repeat(b, 1)
        kp = (torch.arange(s, dtype=torch.int32, device=dev)[None].repeat(b, 1)
              if pattern == "full" else None)
        cnt = torch.tensor(count, dtype=torch.int32, device=dev)
        kcnt = torch.tensor(k_count, dtype=torch.int32, device=dev)
        before = (fp.aux_launches, fp.full_launches)
        out, m, l = fp.flash_attention(q, k, v, qpos, cnt, window, k_positions=kp, k_count=kcnt,
                                       pattern=pattern, return_aux=True)
        check((fp.aux_launches, fp.full_launches)
              == (before[0] + 1, before[1] + (pattern == "full")),
              f"{name}: the {pattern} form with row statistics did not launch")
        ref = fp.flash_attention_plain(q.float(), k.float(), v.float(), qpos, cnt, window, kp,
                                       kcnt, return_aux=True)
        extra = dict(form=f"{pattern}_aux", q0=q0, count=count, k_count=k_count, window=window)
        record("flash_prefill", name, [b, H, KH, s, d], dtype, out, ref[0], **extra)
        cases.append(dict(kernel="flash_prefill_stats", case=f"{name}/stats", shape=[b, H, s],
                          dtype="float32", **extra, **agreement.compare_stats(m, l, *ref[1:])))

    def ring_case(p, s=8192):
        """Ring attention's arithmetic in one process: the sequence split
        into p chunks, each place's steps (its local chunk, then each
        earlier chunk in the 'full' pattern, merged by the row statistics),
        against the square kernel over the whole sequence and against the
        plain version."""
        q, k, v, pos, cnt = flash_inputs(torch, 1, 32, 8, s, 128, s - 77, bf16, gen)
        n, outs = s // p, []
        for i in range(p):
            acc = None
            for t in range(p):
                o = (i - t) % p
                acc = ra.ring_step(q[:, :, i * n:(i + 1) * n], k[:, :, o * n:(o + 1) * n],
                                   v[:, :, o * n:(o + 1) * n], pos[:, o * n:(o + 1) * n],
                                   pos[:, i * n:(i + 1) * n], cnt, o, i, acc)
            outs.append(acc[0].to(bf16))
        merged = torch.cat(outs, dim=2)
        whole = fp.flash_attention(q, k, v, pos, cnt)
        record("ring_merge", f"8b_ring_P{p}_s{s}_vs_square_kernel", [1, 32, 8, s, 128], bf16,
               merged, whole, P=p, reference="the square kernel over the whole sequence")
        ref = fp.flash_attention_plain(q.float(), k.float(), v.float(), pos, cnt)
        record("ring_merge", f"8b_ring_P{p}_s{s}_vs_plain", [1, 32, 8, s, 128], bf16, merged,
               ref, P=p, reference="the plain version over the whole sequence")

    # the flash kernel's row statistics, as ring attention calls it:
    # Llama-3.1-8B's ring chunk at seq 2 (rank 1's 4096 queries against rank
    # 0's 4096 keys); a ragged batch whose second chunk holds no valid key;
    # Ministral-8B's 40960 tokens at seq 2 (20480-token chunks) under its
    # 32768 window, whose edge lies inside the earlier chunk; rank 1's local
    # step at Llama width (the square form, its chunk's own key count); a
    # float32 ragged batch
    aux_case("8b_ring_full_q4096_k4096", 1, 32, 8, 4096, 128, 4096, [8192], [4096], bf16)
    aux_case("ragged_full_b2_s1024_no_key_rows", 2, 32, 8, 1024, 128, 1024, [2048, 1500],
             [700, 0], bf16)
    aux_case("ministral_full_chunk_20480_w32768", 1, 32, 8, 20480, 128, 20480, [40960],
             [20480], bf16, window=32768)
    aux_case("8b_ring_local_causal_4096", 1, 32, 8, 4096, 128, 4096, [8192 - 77],
             [4096 - 77], bf16, pattern="causal")
    aux_case("ragged_full_b2_s200_f32", 2, 8, 2, 200, 64, 200, [400, 300], [150, 0], f32)
    for p in (2, 4):
        ring_case(p)

    def mla_flash_case(name, s, counts, mcfg=None):
        """A DeepSeek model's prefill attention (DeepSeek-V2-Lite's unless
        ``mcfg`` is given): the q/k 192, v 128 causal square at its heads (16;
        DeepSeek-V3's 128) and its softmax scale, with k and v views into the
        [b, s, H, 256] ``kv_b`` output and the shared rope key broadcast over
        the heads, as ``models.deepseek_v2.prefill_attention`` hands them
        over; a count per example below s. ms by CUDA events, the bound from
        the pairs the counts leave visible."""
        from fastkv_tpu_torch.core.config import DeepSeekV2Config

        mcfg = mcfg or DeepSeekV2Config.lite()
        mla = mcfg.mla
        n, r, vd, H, b = (mla.qk_nope_head_dim, mla.qk_rope_head_dim, mla.v_head_dim,
                          mcfg.num_heads, len(counts))
        scale = mcfg.softmax_scale
        q = torch.randn((b, H, s, n + r), generator=gen, device="cuda").to(bf16)
        kv = torch.randn((b, s, H, n + vd), generator=gen, device="cuda").to(bf16).transpose(1, 2)
        k_pe = torch.randn((b, 1, s, r), generator=gen, device="cuda").to(bf16)
        k = torch.cat([kv[..., :n], k_pe.expand(b, H, s, r)], dim=-1)
        v = kv[..., n:]
        pos = torch.arange(s, dtype=torch.int32, device="cuda")[None].repeat(b, 1)
        cnt = torch.tensor(counts, dtype=torch.int32, device="cuda")
        before = fp.launches
        out = fp.flash_attention(q, k, v, pos, cnt, scale=scale)
        check(fp.launches == before + 1 and out.shape == (b, H, s, vd),
              f"{name}: the q/k {n + r}, v {vd} form did not launch")
        ms = events_ms(lambda: fp.flash_attention(q, k, v, pos, cnt, scale=scale), 3)
        ref = fp.flash_attention_plain(q.float(), k.float(), v.float(), pos, cnt, scale=scale)
        pairs = sum(c * (c + 1) // 2 for c in counts)
        flops = 2 * (n + r + vd) * H * pairs
        nbytes = 2 * b * s * H * (2 * (n + r) + 2 * vd)  # q, k read; v read, out written
        bound_ms, bound_by = bound(flops, nbytes)
        record("flash_prefill", name, [b, H, 1, s, n + r, vd], bf16, out, ref, form="mla",
               count=counts, scale=scale, ms=ms, bound_ms=bound_ms, bound_by=bound_by,
               **rates(flops, ms, bound_ms))

    # DeepSeek-V2-Lite (its cell's bucket, 32768, at the traffic's mean
    # prompt; a ragged batch at 8192), after the cases above, which keep
    # their inputs
    mla_flash_case("dsv2lite_mla_s32768_count24576", 32768, [24576])
    mla_flash_case("dsv2lite_mla_ragged_b2_s8192", 8192, [8192 - 77, 3000])
    # DeepSeek-V3 (H 128, scale 0.1352: YaRN x40, mscale_all_dim 1) at its
    # cell's bucket and the traffic's mean prompt
    mla_flash_case("dsv3_mla_h128_s32768_count24576", 32768, [24576], dsv3_config())

    def prologue_case(name, form, b, C=2048):
        """A decode layer's attention prologue (``ops.decode_prologue``) at a
        model's widths, b rows each at a slot of its own, positions up to
        the cells' 32768 + 128, against its plain version run on the card
        (PyTorch's composition): q, the RoPE'd rows and the appends equal
        bit for bit; the MLA latent's norm within one bf16 ulp (its sum
        taken in another order). ms: CUDA graphs of 4 x 40 calls (the
        kernel's and the plain version's device time a call); the bound:
        the bytes a call moves over the card's rate."""
        from fastkv_tpu_torch.core.config import DeepSeekV2Config, ModelConfig
        from fastkv_tpu_torch.models import deepseek_v2
        from fastkv_tpu_torch.models.rope import compute_inv_freq
        from fastkv_tpu_torch.ops import decode_prologue as dp

        dev = "cuda"
        cfg = DeepSeekV2Config.lite() if form == "latent" else ModelConfig.mistral_nemo_12b()
        inv_freq = torch.from_numpy(compute_inv_freq(cfg)).to(dev)
        pos = torch.randint(16385, 32768 + 128, (b,), generator=gen, device=dev,
                            dtype=torch.int32)
        slot = torch.randperm(C, generator=gen, device=dev)[:b]
        if form == "latent":
            mla = cfg.mla
            H, n, r, R = cfg.num_heads, mla.qk_nope_head_dim, mla.qk_rope_head_dim, mla.kv_lora_rank
            q_buf = torch.randn((b, 1, H * (n + r)), generator=gen, device=dev).to(bf16)
            kv_a = torch.randn((b, 1, R + r), generator=gen, device=dev).to(bf16)
            kv_norm = torch.rand((R,), generator=gen, device=dev) + 0.5
            widths, heads = (R, r), H

            def call(fn, q_in, planes):
                return fn(q_in.view(b, 1, H, n + r).transpose(1, 2), kv_a, kv_norm, pos,
                          inv_freq, *planes, slot, eps=cfg.rms_norm_eps,
                          mscale=deepseek_v2.rope_mscale(cfg))

            kernel, plain = dp.latent_prologue, dp.latent_prologue_plain
            nbytes = 2 * (2 * b * H * r + b * (R + r) + b * (R + r)) + 4 * R
        else:
            H, KH, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
            q_buf = torch.randn((b, 1, H * d), generator=gen, device=dev).to(bf16)
            kv = torch.randn((2, b, 1, KH * d), generator=gen, device=dev).to(bf16)
            k, v = (x.view(b, 1, KH, d).transpose(1, 2) for x in kv)
            widths, heads = (d, d), KH

            def call(fn, q_in, planes):
                return fn(q_in.view(b, 1, H, d).transpose(1, 2), k, v, pos, inv_freq, *planes,
                          slot)

            kernel, plain = dp.rope_append, dp.rope_append_plain
            nbytes = 2 * (2 * b * H * d + 2 * b * KH * d + 2 * b * KH * d)
        nbytes += 4 * b + 8 * b + 4 * inv_freq.numel()
        planes = [torch.randn((b, heads if form != "latent" else 1, C, w), generator=gen,
                              device=dev).to(bf16) for w in widths]
        ref_planes = [p.clone() for p in planes]
        want = call(plain, q_buf.clone(), ref_planes)
        before = dp.launches
        got = call(kernel, q_buf.clone(), planes)
        torch.cuda.synchronize()
        launched = dp.launches - before
        ulp = None
        max_abs_err = max(float((a.float() - w.float()).abs().max())
                          for a, w in zip([got, *planes], [want, *ref_planes]))
        exact = torch.equal(got, want) and torch.equal(planes[1], ref_planes[1])
        if form == "latent":  # the written latent rows by ulps, the rest untouched
            written = torch.zeros((b, C), dtype=torch.bool, device=dev)
            written[torch.arange(b, device=dev), slot] = True
            ulp = bf16_ulps(torch, planes[0][:, 0][written], ref_planes[0][:, 0][written])
            exact = exact and torch.equal(planes[0][:, 0][~written], ref_planes[0][:, 0][~written])
        else:
            exact = exact and torch.equal(planes[0], ref_planes[0])
        q_k, q_p = q_buf.clone(), q_buf.clone()
        ms = graph_ms(lambda: call(kernel, q_k, planes), 4 * 40)
        plain_ms = graph_ms(lambda: call(plain, q_p, ref_planes), 4 * 40)
        bound_ms = nbytes / PEAK_BYTES * 1e3
        cases.append(dict(kernel="decode_prologue", case=name, form=form, b=b, dtype=str(bf16),
                          bitwise=exact, latent_max_ulp=ulp, launches=launched,
                          ms=ms, plain_ms=plain_ms, bytes=nbytes, bound_ms=bound_ms,
                          bound_by="bytes", bound_share=bound_ms / ms, max_abs_err=max_abs_err,
                          ok=exact and launched == 1 and (ulp is None or ulp <= 1.0)))

    # the decode step's prologue at the decode cells' widths, b 1 and the
    # Scheduler's 8
    for b in (1, 8):
        prologue_case(f"nemo12b_rope_append_b{b}", "rope", b)
        prologue_case(f"dsv2lite_latent_prologue_b{b}", "latent", b)
    cases += norm_cases(torch)
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
        tiny_h2o_gemfilter_card_vs_cpu(torch, cfg)
        tiny_pyramid_card_vs_cpu(torch, cfg)


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
    check_prologue(counted, f"tiny config{variant}")


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
        check_prologue(counted, f"tiny Scheduler {method.value}{variant}")


def kept_sets(torch, cache):
    """Each cache row's kept positions, ascending, invalid slots last as a
    sentinel: the keep-set whatever the order of its slots (H2O orders its
    kept tokens by score, and two masses equal to float32 rounding may sit in
    swapped slots on the card and on the CPU, which no output can see)."""
    return torch.where(cache.valid, cache.pos, 2**30).sort(dim=-1).values.cpu()


def tiny_h2o_gemfilter_card_vs_cpu(torch, cfg):
    """H2O and GemFilter (filter_idx 1) in float32 on the card against the
    port on the CPU: H2O's prefill logits and kept sets, GemFilter's selected
    tokens and its pass-2 prefill; Engine.generate's tokens; the Scheduler
    with prefill_chunk 64 (both admit whole: no chunk event), its tokens and
    events. The weights are ``tiny_params``', scaled as for FastKV."""
    import numpy as np

    from fastkv_tpu_torch.core.config import EngineConfig, Method, MethodConfig
    from fastkv_tpu_torch.engine import gemfilter
    from fastkv_tpu_torch.engine import prefill as pm
    from fastkv_tpu_torch.engine.generate import Engine
    from fastkv_tpu_torch.engine.scheduler import Scheduler

    p_cpu, p_gpu = tiny_params(torch, cfg, False)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (300, 181, 457)]
    reqs = [(rng.integers(0, cfg.vocab_size, n).tolist(), b)
            for n, b in ((230, 24), (201, 6), (140, 12))]
    tokens = np.zeros((3, 512), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    tokens = torch.from_numpy(tokens)
    n = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    ecfg = EngineConfig(prefill_buckets=(512,), max_new_tokens=16, capacity_align=8)
    serve_ecfg = EngineConfig(prefill_buckets=(256,), capacity_align=8, prefill_chunk=64)
    tol, L = 1e-3, cfg.num_layers
    for method in (Method.H2O, Method.GEMFILTER):
        mcfg = MethodConfig(method=method, eviction_mode="proportional", retain_rate=0.3,
                            filter_idx=1)
        eng_cpu = Engine(p_cpu, cfg, mcfg, ecfg, device="cpu")
        shapes = eng_cpu.shapes_for(512, 16)
        rec = {"phase": "tiny_card_vs_cpu", "path": "engine",
               "config": f"tiny(head_dim=64, sliding_window={cfg.sliding_window}) float32 "
                         f"{method.value}"}
        with torch.inference_mode():
            outs = {}
            for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
                tok, cnt, pmcfg = tokens.to(dev), n.to(dev), mcfg
                if method == Method.GEMFILTER:
                    tok, cnt, sel = gemfilter.select_tokens(params, cfg, mcfg, ecfg, tok, cnt,
                                                            shapes.bucket)
                    outs[dev, "selected"] = (tok.cpu(), cnt.cpu(), sel.cpu())
                    pmcfg = gemfilter.pass2_config(mcfg)
                outs[dev] = pm.prefill(params, cfg, pmcfg, shapes, tok, cnt, ecfg)
        (lc, cc), (lg, cg) = outs["cpu"], outs["cuda"]
        rec["prefill_logit_max_abs_err"] = (lg.cpu() - lc).abs().max().item()
        rec["tol"] = tol
        rec["kept_sets_equal"] = bool(torch.equal(kept_sets(torch, cg), kept_sets(torch, cc)))
        ok = rec["prefill_logit_max_abs_err"] <= tol and rec["kept_sets_equal"]
        if method == Method.GEMFILTER:
            rec["selected_equal"] = all(torch.equal(a, b) for a, b in
                                        zip(outs["cpu", "selected"], outs["cuda", "selected"]))
            rec["new_count"] = outs["cuda", "selected"][1].tolist()
            ok = ok and rec["selected_equal"]
        toks_cpu = eng_cpu.generate(prompts, 16)
        zero_launches()
        toks_gpu = Engine(p_gpu, cfg, mcfg, ecfg).generate(prompts, 16)
        counted = count_launches()
        rec.update(tokens_equal=toks_cpu == toks_gpu, launches=counted)
        emit(rec)
        want = (L + (mcfg.filter_idx if method == Method.GEMFILTER else 0), L * 15, L * 15)
        check(ok and toks_cpu == toks_gpu,
              f"tiny {method.value} (window {cfg.sliding_window}): the card disagrees with the CPU")
        check((counted["flash_prefill"], counted["decode_attn"], counted["decode_prologue"])
              == want, f"tiny {method.value}: launches {counted}, want flash, decode and "
                       f"prologue {want}")

        def serve(params, device):
            sched = Scheduler(params, cfg, mcfg, serve_ecfg, max_batch=2, bucket=256,
                              max_new_tokens=24, device=device)
            for prompt, budget in reqs:
                sched.submit(prompt, budget)
            toks = {r.req_id: r.tokens for r in sched.run()}
            return toks, [e if e[0] != "decode" else ("decode",) for e in sched.events]

        toks_cpu, ev_cpu = serve(p_cpu, "cpu")
        zero_launches()
        toks_gpu, ev_gpu = serve(p_gpu, "cuda")
        counted = count_launches()
        whole = not [e for e in ev_gpu if e[0] in ("chunk", "finish")]
        emit({"phase": "tiny_card_vs_cpu", "path": "scheduler",
              "config": f"tiny(head_dim=64, sliding_window={cfg.sliding_window}) float32 "
                        f"{method.value} prefill_chunk=64",
              "tokens_equal": toks_cpu == toks_gpu, "events_equal": ev_cpu == ev_gpu,
              "every_admission_whole": whole, "launches": counted,
              "new_tokens": {i: len(t) for i, t in toks_gpu.items()}})
        check(toks_cpu == toks_gpu and ev_cpu == ev_gpu and whole
              and counted["flash_prefill"] > 0 and counted["decode_attn"] > 0
              and counted["flash_prefill_rect"] == 0,
              f"tiny Scheduler {method.value} (window {cfg.sliding_window}): the card disagrees "
              f"with the CPU or admitted chunk-wise; launches {counted}")
        check_prologue(counted, f"tiny Scheduler {method.value}")


def pyramid_config(name, **kw):
    """A shipped PyramidInfer config (``fastkv_tpu_torch/configs/pyramidinfer``)."""
    import dataclasses

    from fastkv_tpu_torch.core.config import PYRAMIDINFER_CONFIGS, MethodConfig

    mcfg = MethodConfig().with_pyramidinfer_json(os.path.join(PYRAMIDINFER_CONFIGS,
                                                              f"{name}.json"))
    return dataclasses.replace(mcfg, **kw)


def pyramid_snapshot(torch, logits, cache, pstate):
    """What the tiny pyramid checks compare, copied to the CPU (a CPU
    tensor's ``.cpu()`` is itself, which the next step updates in place):
    logits, each cache row's positions on its valid slots (-1 elsewhere),
    past, live, probs."""
    return tuple(x.to("cpu", copy=True) for x in (
        logits.float(), torch.where(cache.valid, cache.pos, -1), pstate.past, pstate.live,
        pstate.probs))


def tiny_pyramid_card_vs_cpu(torch, cfg):
    """PyramidInfer (llama_35, exceed 4, so that the deeper layers evict from
    the first decode steps) in float32 on the card against the port on the
    CPU: the prefill with its decode state, then four decode steps fed the
    CPU's tokens (logits <= 1e-3, each layer's kept positions and validity,
    past and live equal, probs <= 1e-5 after the prefill and every step);
    Engine.generate's tokens (flash once a layer, the decode kernel never:
    pyramid decode attends in plain torch; the prologue once a layer a
    decode step, as on every path); the Scheduler with prefill_chunk 64 (it
    admits whole): tokens and events. Weights: ``tiny_params``'."""
    import numpy as np

    from fastkv_tpu_torch.core.config import EngineConfig
    from fastkv_tpu_torch.engine import prefill as pm
    from fastkv_tpu_torch.engine import pyramid
    from fastkv_tpu_torch.engine.generate import Engine
    from fastkv_tpu_torch.engine.scheduler import Scheduler

    p_cpu, p_gpu = tiny_params(torch, cfg, False)
    mcfg = pyramid_config("llama_35", pyramid_exceed_length_to_compress=4)
    ecfg = EngineConfig(prefill_buckets=(512,), max_new_tokens=16, capacity_align=8)
    shapes = pm.plan_shapes(cfg, mcfg, ecfg, 512)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (300, 181, 457)]
    reqs = [(rng.integers(0, cfg.vocab_size, n).tolist(), b)
            for n, b in ((230, 24), (201, 6), (140, 12))]
    tokens = np.zeros((3, 512), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    tokens = torch.from_numpy(tokens)
    n = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    r_dyn = pyramid.recent_length(n, mcfg)
    steps, tol = 4, 1e-3
    snaps, fed = {}, []
    with torch.inference_mode():
        for dev, params in (("cpu", p_cpu), ("cuda", p_gpu)):
            logits, cache, ps = pyramid.prefill(params, cfg, mcfg, ecfg, shapes, tokens.to(dev),
                                                n.to(dev), want_decode_state=True)
            snaps[dev] = [pyramid_snapshot(torch, logits, cache, ps)]
            for t in range(steps):
                if dev == "cpu":
                    fed.append(logits.argmax(-1).to(torch.int32))
                logits, cache, ps = pyramid.decode_step(
                    params, cfg, mcfg, cache, ps, fed[t].to(dev), (n + t).to(dev),
                    shapes.prefill_capacity + t, t + 1, n.to(dev), r_dyn.to(dev))
                snaps[dev].append(pyramid_snapshot(torch, logits, cache, ps))
    logit_err = max(float((g[0] - c[0]).abs().max()) for c, g in zip(snaps["cpu"], snaps["cuda"]))
    probs_err = max(float((g[4] - c[4]).abs().max()) for c, g in zip(snaps["cpu"], snaps["cuda"]))
    state_eq = all(torch.equal(c[i], g[i]) for c, g in zip(snaps["cpu"], snaps["cuda"])
                   for i in (1, 2, 3))
    live = [s[3] for s in snaps["cpu"]]
    evictions = sum(int((b < a + 1).sum()) for a, b in zip(live, live[1:]))
    toks_cpu = Engine(p_cpu, cfg, mcfg, ecfg, device="cpu").generate(prompts, 16)
    zero_launches()
    toks_gpu = Engine(p_gpu, cfg, mcfg, ecfg).generate(prompts, 16)
    counted = count_launches()
    config = (f"tiny(head_dim=64, sliding_window={cfg.sliding_window}) float32 pyramidinfer "
              f"llama_35 exceed 4")
    emit({"phase": "tiny_card_vs_cpu", "path": "engine", "config": config,
          "logit_max_abs_err": logit_err, "tol": tol, "probs_max_abs_err": probs_err,
          "probs_tol": 1e-5, "kept_valid_past_live_equal": state_eq,
          "decode_steps_compared": steps, "evictions": evictions,
          "tokens_equal": toks_cpu == toks_gpu, "launches": counted})
    check(logit_err <= tol and probs_err <= 1e-5 and state_eq and toks_cpu == toks_gpu
          and evictions > 0,
          f"tiny pyramidinfer (window {cfg.sliding_window}): the card disagrees with the CPU")
    want = (cfg.num_layers, 0, cfg.num_layers * 15)
    check((counted["flash_prefill"], counted["decode_attn"], counted["decode_prologue"])
          == want, f"tiny pyramidinfer: launches {counted}, want flash, decode and prologue "
                   f"{want}")
    check_norm(counted, "tiny pyramidinfer")

    serve_ecfg = EngineConfig(prefill_buckets=(256,), capacity_align=8, prefill_chunk=64)

    def serve(params, device):
        sched = Scheduler(params, cfg, mcfg, serve_ecfg, max_batch=2, bucket=256,
                          max_new_tokens=24, device=device)
        for prompt, budget in reqs:
            sched.submit(prompt, budget)
        toks = {r.req_id: r.tokens for r in sched.run()}
        return toks, [e if e[0] != "decode" else ("decode",) for e in sched.events]

    toks_cpu, ev_cpu = serve(p_cpu, "cpu")
    zero_launches()
    toks_gpu, ev_gpu = serve(p_gpu, "cuda")
    counted = count_launches()
    whole = not [e for e in ev_gpu if e[0] in ("chunk", "finish")]
    emit({"phase": "tiny_card_vs_cpu", "path": "scheduler", "config": config + " prefill_chunk=64",
          "tokens_equal": toks_cpu == toks_gpu, "events_equal": ev_cpu == ev_gpu,
          "every_admission_whole": whole, "launches": counted,
          "new_tokens": {i: len(t) for i, t in toks_gpu.items()}})
    steps = sum(e[0] == "decode" for e in ev_gpu)
    check(toks_cpu == toks_gpu and ev_cpu == ev_gpu and whole
          and counted["flash_prefill"] == cfg.num_layers * len(reqs)
          and counted["decode_attn"] == 0
          and counted["decode_prologue"] == cfg.num_layers * steps
          and counted["flash_prefill_rect"] == 0,
          f"tiny Scheduler pyramidinfer (window {cfg.sliding_window}): the card disagrees with "
          f"the CPU or admitted chunk-wise; launches {counted}, {steps} decode steps")
    check_norm(counted, "tiny Scheduler pyramidinfer")


# ---------------------------------------------------------------------------
# full width: Llama-3.1-8B
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# sequence parallelism: ranks that share the card
# ---------------------------------------------------------------------------

SP_SEQ = 2  # ranks of the seq group (every rank on the one card, over gloo)


def sp_workdir(tag: str) -> str:
    import tempfile

    return tempfile.mkdtemp(prefix=f"fastkv_sp_{tag}_")


def sp_results(workdir: str, world: int):
    import pickle

    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def sp_want(mode: str, method: str, rank: int, L: int, tsp_idx: int, new: int) -> dict:
    """The launches one Engine.generate makes on a rank: the sharded layers
    (FastKV's [0, tsp_idx], every layer otherwise) launch, under the ring,
    the local step (square, with statistics) and one 'full' step per earlier
    rank; under Ulysses one square call over the whole sequence. FastKV's
    later layers run whole (square), decode and its prologue every layer
    each step after the first."""
    sharded = tsp_idx + 1 if method == "fastkv" else L
    full = sharded * rank if mode == "ring" else 0
    aux = sharded if mode == "ring" else 0
    return {"flash_prefill": L + full, "flash_prefill_aux": aux + full,
            "flash_prefill_full": full, "flash_prefill_rect": full,
            "decode_attn": L * (new - 1), "decode_prologue": L * (new - 1),
            "add_rms_norm": 2 * L * (new - 1)}


def phase_sp_tiny_card_vs_cpu(torch):
    """The tiny config as two ranks on the card against one process on the
    CPU: ring and Ulysses, FastKV and FullKV."""
    import shutil

    import numpy as np

    from fastkv_tpu_torch.core.config import (EngineConfig, Method, MethodConfig, ModelConfig,
                                              ParallelConfig)
    from fastkv_tpu_torch.engine import prefill as pm
    from fastkv_tpu_torch.engine.generate import Engine
    from fastkv_tpu_torch.parallel.launch import run_world
    from fastkv_tpu_torch.utils.testing import cache_by_position, mesh_rank_cases

    cfg = ModelConfig.tiny(head_dim=64)
    p_cpu, _ = tiny_params(torch, cfg, False)
    params_np = {k: v.numpy() for k, v in p_cpu.items() if k != "layers"}
    params_np["layers"] = {k: v.numpy() for k, v in p_cpu["layers"].items()}
    ecfg = EngineConfig(prefill_buckets=(512,), max_new_tokens=16, capacity_align=8)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (300, 181, 457)]
    tokens = np.zeros((3, 512), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    n_true = np.asarray([len(p) for p in prompts], np.int32)
    methods = {"fastkv": MethodConfig(method=Method.FASTKV, eviction_mode="proportional",
                                      retain_rate=0.3, tsp_rate=0.5, tsp_idx=1,
                                      pooling="maxpool"),
               "fullkv": MethodConfig(method=Method.FULLKV),
               "h2o": MethodConfig(method=Method.H2O, eviction_mode="proportional",
                                   retain_rate=0.3)}
    names = [(mode, m) for mode in ("ring", "ulysses") for m in methods]
    cases = [dict(pcfg=ParallelConfig(seq=SP_SEQ, sp_mode=mode), mcfg=methods[m], ecfg=ecfg,
                  tokens=tokens, n_true=n_true, prompts=prompts, max_new=16)
             for mode, m in names]
    t0 = time.perf_counter()
    wd = sp_workdir("tiny")
    try:
        run_world(mesh_rank_cases, SP_SEQ, wd, (wd, cfg, params_np, cases, "cuda:0"))
        ranks = sp_results(wd, SP_SEQ)
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    world_s = time.perf_counter() - t0
    tol, ok = 1e-3, True
    with torch.inference_mode():
        for ci, (mode, m) in enumerate(names):
            mcfg = methods[m]
            shapes = pm.plan_shapes(cfg, mcfg, ecfg, 512)
            lc, cc = pm.prefill(p_cpu, cfg, mcfg, shapes, torch.from_numpy(tokens),
                                torch.from_numpy(n_true), ecfg)
            toks = Engine(p_cpu, cfg, mcfg, ecfg, device="cpu").generate(prompts, 16)
            rec = {"phase": "sp_tiny_card_vs_cpu", "mode": mode, "method": m,
                   "config": "tiny(head_dim=64) float32, 2 ranks on one card over gloo",
                   "world_s": world_s, "tol": tol, "ranks": []}
            ref = dict(pos=cc.pos.numpy(), valid=cc.valid.numpy())
            if m == "h2o":  # its cache holds kept tokens in score order
                ref = cache_by_position(ref)
            for r, outs in enumerate(ranks):
                o = outs[ci]
                if m == "h2o":
                    o = cache_by_position(o)
                want = sp_want(mode, m, r, cfg.num_layers, mcfg.tsp_idx, 16)
                got = o["launches"]
                rk = {"rank": r,
                      "logit_max_abs_err": float(np.abs(o["logits"] - lc.numpy()).max()),
                      "pos_equal": bool((o["pos"] == ref["pos"]).all()),
                      "valid_equal": bool((o["valid"] == ref["valid"]).all()),
                      "tokens_equal": o["tokens"] == toks, "launches": got}
                # three prompts of one bucket: one prefill, each step decodes all three
                rk["launches_ok"] = (got["aux"] == want["flash_prefill_aux"]
                                     and got["full"] == want["flash_prefill_full"]
                                     and got["flash"] == want["flash_prefill"]
                                     and got["decode"] == want["decode_attn"]
                                     and got["prologue"] == want["decode_prologue"]
                                     and got["norm"] == want["add_rms_norm"])
                ok = ok and rk["logit_max_abs_err"] <= tol and rk["pos_equal"] and \
                    rk["valid_equal"] and rk["tokens_equal"] and rk["launches_ok"]
                rec["ranks"].append(rk)
            emit(rec)
    check(ok, "sp_tiny_card_vs_cpu: a rank on the card disagrees with the CPU or launched "
              "other than the path calls")


def sp_full_width_rank(rank: int, world: int, workdir: str) -> None:
    """One rank of the full-width SP run (see ``phase_sp_full_width``)."""
    import pickle

    import torch
    import torch.distributed as dist

    from fastkv_tpu_torch.core.config import EngineConfig, Method, ModelConfig, ParallelConfig
    from fastkv_tpu_torch.engine import prefill as pm
    from fastkv_tpu_torch.engine.generate import Engine
    from fastkv_tpu_torch.models.llama import init_params
    from fastkv_tpu_torch.parallel.sharding import make_mesh

    torch.cuda.set_device(0)
    cfg = ModelConfig.llama_3_1_8b()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = init_params(cfg, gen)  # the weights and prompt of full_width
    torch.cuda.synchronize()
    out = {"init_s": time.perf_counter() - t0, "runs": {}, "ref": {}}
    s, new = 8192, 32
    prompt = torch.randint(0, cfg.vocab_size, (s,), generator=gen, device="cuda").tolist()
    tok_t = torch.tensor([prompt], device="cuda", dtype=torch.int32)
    n_t = torch.tensor([s], dtype=torch.int32, device="cuda")
    ecfg = EngineConfig(prefill_buckets=(s,), max_new_tokens=new)

    def kept(cache):
        return cache.pos.cpu().numpy(), cache.valid.cpu().numpy()

    for mode in ("ring", "ulysses"):
        pcfg = ParallelConfig(seq=world, sp_mode=mode)
        mesh = make_mesh(pcfg, "cuda:0")
        for m in ("fastkv", "fullkv"):
            mcfg = canonical(Method(m))
            eng = Engine(params, cfg, mcfg, ecfg, mesh=mesh)
            shapes = eng.shapes_for(s, new)
            with torch.inference_mode():  # the warm-up, and the cache it keeps
                _, cache = pm.prefill(params, cfg, mcfg, shapes, tok_t, n_t, ecfg, pcfg=pcfg,
                                      mesh=mesh)
            pos, valid = kept(cache)
            del cache
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            dist.barrier()
            zero_launches()
            toks = eng.generate([prompt], new)
            launches = count_launches()
            t = eng.last_timing
            peak = torch.cuda.max_memory_allocated()
            # where this rank's prefill time goes: its own kernels only (the
            # other rank's share the card unseen)
            with torch.inference_mode():
                wall, kern = profile_window(torch, lambda: pm.prefill(
                    params, cfg, mcfg, shapes, tok_t, n_t, ecfg, pcfg=pcfg, mesh=mesh))
            prof = breakdown(wall, kern)
            prof["flash_ms"] = kernels_ms(kern, FLASH_BF16) if kern else None
            out["runs"][f"{mode}_{m}"] = dict(
                tokens=toks[0], launches=launches, pos=pos, valid=valid,
                prefill_s=t["prefill_s"], decode_ms_per_token=1e3 * t["decode_s"] /
                t["decode_steps"], peak=peak, prefill_profile=prof)
    dist.barrier()
    if rank == 0:  # the single-process run on the same weights and prompt
        for m in ("fastkv", "fullkv"):
            mcfg = canonical(Method(m))
            eng = Engine(params, cfg, mcfg, ecfg)
            with torch.inference_mode():
                _, cache = pm.prefill(params, cfg, mcfg, eng.shapes_for(s, new), tok_t, n_t,
                                      ecfg)
            pos, valid = kept(cache)
            del cache
            out["ref"][m] = dict(tokens=eng.generate([prompt], new)[0], pos=pos, valid=valid,
                                 prefill_s=eng.last_timing["prefill_s"])
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def phase_sp_full_width(torch, gpu: str):
    """Llama-3.1-8B at full width and depth as two ranks on the card:
    ring and Ulysses at seq 2, FastKV and FullKV. Returns the launches per
    path (both ranks' counted generates)."""
    import shutil

    import numpy as np

    from fastkv_tpu_torch.core.config import ModelConfig
    from fastkv_tpu_torch.parallel.launch import run_world
    from fastkv_tpu_torch.utils.testing import cache_by_position

    cfg = ModelConfig.llama_3_1_8b()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # this process holds no weights: leave the card to the ranks
    t0 = time.perf_counter()
    wd = sp_workdir("8b")
    try:
        run_world(sp_full_width_rank, SP_SEQ, wd, (wd,))
        ranks = sp_results(wd, SP_SEQ)
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    world_s = time.perf_counter() - t0
    ref = ranks[0]["ref"]
    by_path, ok = {}, True
    for key in ranks[0]["runs"]:
        mode, m = key.split("_")
        rec = {"phase": f"sp_full_width_{key}", "model": cfg.name, "prompt_len": 8192,
               "new_tokens": 32, "seq": SP_SEQ, "gpu": gpu, "world_s": world_s,
               "note": "both ranks share one card: these seconds say nothing of SP's speed",
               "single_process_prefill_s": ref[m]["prefill_s"], "ranks": []}
        for r, res in enumerate(ranks):
            o = res["runs"][key]
            want = sp_want(mode, m, r, cfg.num_layers, 15, 32)
            got = {k: o["launches"][k] for k in want}
            ref_t, t = ref[m]["tokens"], o["tokens"]
            # the kept sets: FastKV's cache holds its tokens in score order,
            # which a bf16 near-tie reorders
            a, b = cache_by_position(o), cache_by_position(ref[m])
            either = a["valid"] | b["valid"]
            same = (a["valid"] == b["valid"]) & (a["pos"] == b["pos"])
            rk = {"rank": r, "init_s": res["init_s"], "prefill_s": o["prefill_s"],
                  "decode_ms_per_token": o["decode_ms_per_token"],
                  "prefill_profile": o["prefill_profile"],
                  "max_memory_allocated_bytes": o["peak"], "launches": o["launches"],
                  "launches_want": want, "launches_ok": got == want,
                  "equal_tokens_share": float(np.mean([a == b for a, b in zip(t, ref_t)])),
                  "equal_kept_positions_share": float(same[either].mean()),
                  "tokens_head": t[:8], "tokens_equal_rank0": t == ranks[0]["runs"][key]["tokens"]}
            ok = ok and rk["launches_ok"] and rk["tokens_equal_rank0"] and len(t) == 32
            rec["ranks"].append(rk)
            by_path[f"sp_{key}_rank{r}"] = o["launches"]
        emit(rec)
    check(ok, "sp_full_width: a rank launched other than the path calls, or the ranks' tokens "
              "differ")
    return by_path


# ---------------------------------------------------------------------------
# tensor and pipeline parallelism: ranks that share the one card over gloo
# ---------------------------------------------------------------------------

TP_WORLD = 4  # ranks of the TP/PP worlds (every rank on the one card, over gloo)
# new tokens of a full-width TP/PP generate: four ranks decode through host
# memory at ~0.2-0.3 s a step, so a few steps check the launches and tokens
TP_FULL_NEW = 8
TP_TINY_LENGTHS = (300, 181, 457, 402)


def tp_tiny_methods() -> dict:
    """Every method at the tiny settings (GemFilter's filter layer 2;
    PyramidInfer's llama_35 with exceed 4, so the pyramid shrinks and decode
    evicts)."""
    from fastkv_tpu_torch.core.config import Method, MethodConfig

    kw = dict(eviction_mode="proportional", retain_rate=0.3, tsp_rate=0.5, tsp_idx=1,
              filter_idx=2, pooling="maxpool")
    out = {m: MethodConfig(method=Method(m), **kw)
           for m in ("fullkv", "fastkv", "snapkv", "h2o", "streamingllm", "gemfilter")}
    out["pyramidinfer"] = pyramid_config("llama_35", pyramid_exceed_length_to_compress=4)
    return out


def tp_want(mcfg, L: int, pipe: int, stage: int, new: int) -> dict:
    """The launches one Engine.generate makes on a rank of stage ``stage`` of
    ``pipe``: its stage's layers of the prefill (GemFilter: also its layers
    of pass 1, [0, filter_idx)), and of every decode step after the first,
    the decode kernel and its prologue alike (PyramidInfer's decode attends
    in plain torch: its prologue only), and the norm kernel twice."""
    from fastkv_tpu_torch.core.config import Method

    lo, hi = stage * L // pipe, (stage + 1) * L // pipe
    flash = hi - lo
    if mcfg.method == Method.GEMFILTER:
        flash += len(range(lo, min(hi, mcfg.filter_idx)))
    prologue = (hi - lo) * (new - 1)
    decode = 0 if mcfg.method == Method.PYRAMIDINFER else prologue
    return {"flash": flash, "decode": decode, "prologue": prologue, "norm": 2 * prologue}


def cache_slice_equal(rank_out: dict, ref: dict, pcfg, by_position: bool) -> bool:
    """Whether a rank's cache positions and validity equal its slice of the
    single process's cache (``sharding.cache_pspec``), in position order
    where ``by_position`` (H2O's score order may swap slots of equal mass)."""
    from fastkv_tpu_torch.parallel import sharding
    from fastkv_tpu_torch.utils.testing import cache_by_position

    spec = sharding.cache_pspec()
    want = {n: ref[n][sharding.slices(ref[n].shape, getattr(spec, n), pcfg, rank_out["place"])]
            for n in ("pos", "valid", "k", "v")}
    got = rank_out
    if by_position:
        want, got = cache_by_position(want), cache_by_position(rank_out)
    return bool((got["pos"] == want["pos"]).all() and (got["valid"] == want["valid"]).all())


def phase_tp_tiny_card_vs_cpu(torch):
    """The tiny config as four ranks on the card, data 2 x model 2 and model
    2 x pipe 2, every method, against one process on the CPU."""
    import shutil

    import numpy as np

    from fastkv_tpu_torch.core.config import EngineConfig, ModelConfig, ParallelConfig
    from fastkv_tpu_torch.engine import gemfilter
    from fastkv_tpu_torch.engine import prefill as pm
    from fastkv_tpu_torch.engine.generate import Engine
    from fastkv_tpu_torch.parallel.launch import run_world
    from fastkv_tpu_torch.utils.testing import mesh_rank_cases

    cfg = ModelConfig.tiny(head_dim=64)
    p_cpu, _ = tiny_params(torch, cfg, False)
    params_np = {k: v.numpy() for k, v in p_cpu.items() if k != "layers"}
    params_np["layers"] = {k: v.numpy() for k, v in p_cpu["layers"].items()}
    ecfg = EngineConfig(prefill_buckets=(512,), max_new_tokens=16, capacity_align=8)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in TP_TINY_LENGTHS]
    tokens = np.zeros((len(prompts), 512), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    n_true = np.asarray(TP_TINY_LENGTHS, np.int32)
    methods = tp_tiny_methods()
    meshes = (ParallelConfig(data=2, model=2), ParallelConfig(model=2, pipe=2))
    names = [(pcfg, m) for pcfg in meshes for m in methods]
    cases = [dict(pcfg=pcfg, mcfg=methods[m], ecfg=ecfg, tokens=tokens, n_true=n_true,
                  prompts=prompts, max_new=16) for pcfg, m in names]
    t0 = time.perf_counter()
    wd = sp_workdir("tp_tiny")
    try:
        run_world(mesh_rank_cases, TP_WORLD, wd, (wd, cfg, params_np, cases, "cuda:0"))
        ranks = sp_results(wd, TP_WORLD)
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    world_s = time.perf_counter() - t0
    refs = {}
    with torch.inference_mode():
        for m, mcfg in methods.items():  # the single process on the CPU
            eng = Engine(p_cpu, cfg, mcfg, ecfg, device="cpu")
            shapes = eng.shapes_for(512, ecfg.max_new_tokens)
            tok_t, n_t = torch.from_numpy(tokens), torch.from_numpy(n_true)
            if m == "gemfilter":
                tok_t, n_t, _ = gemfilter.select_tokens(p_cpu, cfg, mcfg, ecfg, tok_t, n_t,
                                                        shapes.bucket)
            lc, cc = pm.prefill(p_cpu, cfg, gemfilter.pass2_config(mcfg) if m == "gemfilter"
                                else mcfg, shapes, tok_t, n_t, ecfg)
            refs[m] = dict(logits=lc.numpy(), pos=cc.pos.numpy(), valid=cc.valid.numpy(),
                           k=cc.k.numpy(), v=cc.v.numpy(), tokens=eng.generate(prompts, 16))
    tol, ok = 1e-3, True
    for ci, (pcfg, m) in enumerate(names):
        ref, mcfg = refs[m], methods[m]
        rec = {"phase": "tp_tiny_card_vs_cpu", "mesh": {k: getattr(pcfg, k) for k in
                                                        ("data", "model", "pipe")},
               "method": m, "config": "tiny(head_dim=64) float32, 4 ranks on one card over gloo",
               "world_s": world_s, "tol": tol, "ranks": []}
        outs = [r[ci] for r in ranks]
        for r, o in enumerate(outs):
            rows = slice(*o["rows"])
            want = tp_want(mcfg, cfg.num_layers, pcfg.pipe, o["place"]["pipe"], 16)
            got = {k: o["launches"][k] for k in want}
            peers = [p for p in outs if p["place"]["data"] == o["place"]["data"]]
            rk = {"rank": r, "place": o["place"],
                  "logit_max_abs_err": float(np.abs(o["logits"] - ref["logits"][rows]).max()),
                  "kept_equal": cache_slice_equal(o, ref, pcfg, m == "h2o"),
                  "tokens_equal": o["tokens"] == ref["tokens"],
                  "logits_equal_in_replica": all(np.array_equal(o["logits"], p["logits"])
                                                 for p in peers),
                  "launches": got, "launches_want": want}
            rk["ok"] = (rk["logit_max_abs_err"] <= tol and rk["kept_equal"] and rk["tokens_equal"]
                        and rk["logits_equal_in_replica"] and got == want)
            ok = ok and rk["ok"]
            rec["ranks"].append(rk)
        emit(rec)
    check(ok, "tp_tiny_card_vs_cpu: a rank on the card disagrees with the CPU, with its peers, "
              "or launched other than the path calls")


# the full-width TP/PP runs: (tag, mesh, methods); each loads its shard from
# the checkpoint that checkpoint_and_clis writes
TP_RUNS = (("m2", dict(data=2, model=2), ("fastkv", "fullkv")),
           ("m2p2", dict(model=2, pipe=2), ("fastkv",)),
           ("s2m2_ring", dict(model=2, seq=2, sp_mode="ring"), ("h2o",)))


def tp_full_width_rank(rank: int, world: int, workdir: str, model_dir: str, prompt) -> None:
    """One rank of the full-width TP/PP runs (see ``phase_tp_full_width``)."""
    import pickle

    import torch
    import torch.distributed as dist

    from fastkv_tpu_torch.core import weights
    from fastkv_tpu_torch.core.config import EngineConfig, Method, ParallelConfig
    from fastkv_tpu_torch.engine import prefill as pm
    from fastkv_tpu_torch.engine.generate import Engine
    from fastkv_tpu_torch.parallel.sharding import make_mesh

    torch.cuda.set_device(0)
    cfg = weights.model_config_from_dir(model_dir)
    s, new = len(prompt), TP_FULL_NEW
    ecfg = EngineConfig(prefill_buckets=(s,), max_new_tokens=new)
    tok_t = torch.tensor([prompt], device="cuda", dtype=torch.int32)
    n_t = torch.tensor([s], dtype=torch.int32, device="cuda")
    out = {}
    for tag, kw, methods in TP_RUNS:
        pcfg = ParallelConfig(**kw)
        mesh = make_mesh(pcfg, "cuda:0")
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        params = weights.load_params(model_dir, cfg, mesh=mesh)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        shard_bytes = sum(t.numel() * t.element_size() for t in
                          [*[v for k, v in params.items() if k != "layers"],
                           *params["layers"].values()])
        for m in methods:
            mcfg = canonical(Method(m))
            eng = Engine(params, cfg, mcfg, ecfg, mesh=mesh)
            shapes = eng.shapes_for(s, new)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            dist.barrier()
            zero_launches()
            toks = eng.generate([prompt] * pcfg.data, new)
            launches = count_launches()
            t = eng.last_timing
            peak = torch.cuda.max_memory_allocated()
            # where this rank's prefill time goes: its own kernels and copies
            # (the other ranks' share the card unseen); its cache's kept
            # positions
            dist.barrier()
            held = {}
            with torch.inference_mode():
                wall, kern = profile_window(torch, lambda: held.update(out=pm.prefill(
                    params, cfg, mcfg, shapes, tok_t, n_t, ecfg, pcfg=pcfg, mesh=mesh)))
            cache = held.pop("out")[1]
            kept = dict(pos=cache.pos.cpu().numpy(), valid=cache.valid.cpu().numpy())
            del cache
            prof = breakdown(wall, kern)
            prof["flash_ms"] = kernels_ms(kern, FLASH_BF16) if kern else None
            prof["gemm_ms"] = kernels_ms(kern, *GEMM_NAMES) if kern else None
            prof["memcpy_ms"] = kernels_ms(kern, "Memcpy", "memcpy") if kern else None
            out[f"{tag}_{m}"] = dict(
                place=mesh.place, tokens=toks, launches=launches, kept=kept,
                prefill_s=t["prefill_s"], decode_ms_per_token=1e3 * t["decode_s"] /
                t["decode_steps"], peak=peak, load_s=load_s, shard_bytes=shard_bytes,
                prefill_profile=prof)
            del eng
        del params
        torch.cuda.empty_cache()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def phase_tp_full_width(torch, gpu: str, model_dir: str, prompt, ref: dict):
    """Llama-3.1-8B at full width and depth as four ranks on the card, each
    loading only its shard of the checkpoint (``load_params(mesh=)``):
    FastKV and FullKV at model 2 (two data replicas of a TP pair), FastKV at
    model 2 x pipe 2, H2O under the ring at seq 2 x model 2. ``ref``: the
    single process's tokens and kept positions per method (full_width).
    Returns the launches per path (every rank's counted generate)."""
    import dataclasses
    import shutil

    import numpy as np

    from fastkv_tpu_torch.core.config import Method, ParallelConfig
    from fastkv_tpu_torch.parallel import sharding
    from fastkv_tpu_torch.parallel.launch import run_world
    from fastkv_tpu_torch.utils.testing import cache_by_position

    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # this process holds no weights: leave the card to the ranks
    L, new = 32, TP_FULL_NEW
    t0 = time.perf_counter()
    wd = sp_workdir("tp_8b")
    try:
        run_world(tp_full_width_rank, TP_WORLD, wd, (wd, model_dir, prompt))
        ranks = sp_results(wd, TP_WORLD)
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    world_s = time.perf_counter() - t0
    spec = sharding.cache_pspec()
    by_path, ok = {}, True
    for tag, kw, methods in TP_RUNS:
        pcfg = ParallelConfig(**kw)
        one_row = dataclasses.replace(pcfg, data=1)
        for m in methods:
            key = f"{tag}_{m}"
            rec = {"phase": f"tp_full_width_{key}", "model": "llama-3.1-8b", "prompt_len":
                   len(prompt), "new_tokens": new, "mesh": kw, "gpu": gpu, "world_s": world_s,
                   "note": "four ranks share one card over gloo: these seconds say nothing of "
                           "TP's or PP's speed", "ranks": []}
            outs = [r[key] for r in ranks]
            for r, o in enumerate(outs):
                place = o["place"]
                if pcfg.seq > 1:
                    sw = sp_want("ring", m, place["seq"], L, 15, new)
                    want = {"flash": sw["flash_prefill"], "decode": sw["decode_attn"],
                            "prologue": sw["decode_prologue"], "norm": sw["add_rms_norm"],
                            "full": sw["flash_prefill_full"]}
                else:
                    want = tp_want(canonical(Method(m)), L, pcfg.pipe, place["pipe"], new)
                got = {"flash": o["launches"]["flash_prefill"],
                       "decode": o["launches"]["decode_attn"],
                       "prologue": o["launches"]["decode_prologue"],
                       "norm": o["launches"]["add_rms_norm"]}
                if "full" in want:
                    got["full"] = o["launches"]["flash_prefill_full"]
                toks = o["tokens"][0]
                # the single process ran the one row every replica runs
                rw = {n: ref[m][n][sharding.slices(ref[m][n].shape, getattr(spec, n), one_row,
                                                   dict(place, data=0))]
                      for n in ("pos", "valid")}
                # the kept sets: FastKV's and H2O's caches hold their tokens
                # in score order, which a bf16 near-tie reorders
                rw, kept = cache_by_position(rw), cache_by_position(o["kept"])
                either = kept["valid"] | rw["valid"]
                same = (kept["valid"] == rw["valid"]) & (kept["pos"] == rw["pos"])
                rk = {"rank": r, "place": place, "load_s": o["load_s"],
                      "shard_bytes": o["shard_bytes"], "prefill_s": o["prefill_s"],
                      "decode_ms_per_token": o["decode_ms_per_token"],
                      "prefill_profile": o["prefill_profile"],
                      "max_memory_allocated_bytes": o["peak"], "launches": o["launches"],
                      "launches_want": want, "launches_ok": got == want,
                      "tokens_equal_all_ranks": all(p["tokens"] == o["tokens"] for p in outs),
                      "rows_equal": all(t == toks for t in o["tokens"]),
                      "equal_tokens_share": float(np.mean([a == b for a, b in
                                                           zip(toks, ref[m]["tokens"])])),
                      "equal_kept_positions_share": float(same[either].mean()),
                      "tokens_head": toks[:8]}
                ok = ok and rk["launches_ok"] and rk["tokens_equal_all_ranks"] and \
                    rk["rows_equal"] and len(toks) == new
                rec["ranks"].append(rk)
                by_path[f"tp_{key}_rank{r}"] = o["launches"]
            emit(rec)
    check(ok, "tp_full_width: a rank launched other than the path calls, or the ranks' tokens "
              "differ")
    return by_path


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


def method_prefill(torch, params, cfg, mcfg, shapes, tok_t, n_t):
    """One prefill as Engine.generate runs it -> (logits, cache, the method
    config decode runs under, the length decode continues from). GemFilter:
    pass 1 at the prompt's bucket, then pass 2, FullKV over the reduced
    prompt at ``shapes`` (Engine.shapes_for's plan for it)."""
    from fastkv_tpu_torch.core.config import EngineConfig, Method
    from fastkv_tpu_torch.engine import gemfilter
    from fastkv_tpu_torch.engine import prefill as pm

    if mcfg.method == Method.GEMFILTER:
        tok_t, n_t, _ = gemfilter.select_tokens(params, cfg, mcfg, EngineConfig(), tok_t, n_t,
                                                shapes.bucket)
        mcfg = gemfilter.pass2_config(mcfg)
    logits, cache = pm.prefill(params, cfg, mcfg, shapes, tok_t, n_t)
    return logits, cache, mcfg, n_t


def kernels_ms(per_kernel, *names):
    """Device ms of the profiled kernels whose names contain one of ``names``."""
    return sum(ms for k, ms in per_kernel.items() if any(n in k for n in names))


# cuBLAS's GEMM kernels on Hopper, by name; the float32 ones (no TF32) are
# h2o_scores' QK^T, the others the model's bf16 projections
GEMM_NAMES = ("gemm", "nvjet", "cutlass", "xmma")
GEMM_F32 = "f32f32"


def phase_full_width(torch, gpu: str):
    from fastkv_tpu_torch.core.config import EngineConfig, Method, ModelConfig
    from fastkv_tpu_torch.engine import decode as dm
    from fastkv_tpu_torch.engine import gemfilter
    from fastkv_tpu_torch.engine.generate import Engine
    from fastkv_tpu_torch.models.llama import init_params
    from fastkv_tpu_torch.ops import attention as att

    cfg = ModelConfig.llama_3_1_8b()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = init_params(cfg, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    s, new, L = 8192, 32, cfg.num_layers
    prompt = torch.randint(0, cfg.vocab_size, (s,), generator=gen, device="cuda").tolist()
    tok_t = torch.tensor([prompt], device="cuda", dtype=torch.int32)
    n_t = torch.tensor([s], dtype=torch.int32, device="cuda")
    ecfg = EngineConfig(prefill_buckets=(s,), max_new_tokens=new)
    methods = (Method.FULLKV, Method.FASTKV, Method.H2O, Method.GEMFILTER)
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
        # the canonical operating point (window 8, maxpool kernel 7 and
        # GemFilter's filter_idx 13 are the defaults)
        mcfg = canonical(m)
        eng = Engine(params, cfg, mcfg, ecfg)
        shapes = eng.shapes_for(s, new)  # GemFilter: its pass 2's
        runs[m] = r = {"eng": eng, "mcfg": mcfg, "shapes": shapes, "windows": []}
        # warm-up of both phases (the kernels' first launches, cuBLAS's first
        # GEMVs), and the prefill logits' check
        with torch.inference_mode():
            logits, cache, dmcfg, n_dec = method_prefill(torch, params, cfg, mcfg, shapes,
                                                         tok_t, n_t)
            check(tuple(logits.shape) == (1, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
                  f"{m.value}: prefill logits not finite or misshapen")
            check(cache.k.shape[3] == shapes.total_capacity, f"{m.value}: cache capacity")
            r["new_count"] = int(n_dec[0])
            # the kept positions, for the TP/PP runs' comparison
            r["kept"] = dict(pos=cache.pos.cpu().numpy(), valid=cache.valid.cpu().numpy())
            first = logits.argmax(-1).to(torch.int32)
            for t in range(4):
                dm.decode_step(params, cfg, dmcfg, cache, first, n_dec + t,
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
        check(len(out) == 1 and len(out[0]) == new
              and all(0 <= t < cfg.vocab_size for t in out[0]), f"{m.value}: bad tokens")
        # GemFilter's flash: layers [0, filter_idx) of pass 1, then every layer of pass 2
        want = L + (mcfg.filter_idx if m == Method.GEMFILTER else 0)
        check(r["launches"]["flash_prefill"] == want,
              f"{m.value}: flash_prefill launched {r['launches']['flash_prefill']} times, "
              f"want {want}")
        check(r["launches"]["decode_attn"] == r["launches"]["decode_prologue"] == L * (new - 1),
              f"{m.value}: decode_attn and decode_prologue launched "
              f"{r['launches']['decode_attn']} and {r['launches']['decode_prologue']} times")

    # more windows per method, the methods alternating, so that a drift of
    # the host's speed over the run falls on all alike
    for _ in range(MORE_WINDOWS):
        for m in methods:
            r = runs[m]
            r["same_tokens"] = r.get("same_tokens", True) and window(m) == r["tokens"]

    results = {}
    for m in methods:
        r, shapes, mcfg = runs[m], runs[m]["shapes"], runs[m]["mcfg"]
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
        if m == Method.GEMFILTER:
            # prefill_s (the time to the first token) is both passes
            rec.update(filter_idx=mcfg.filter_idx, filter_capacity=shapes.bucket,
                       new_count=r["new_count"],
                       pass1_s=spread([w["pass1_s"] for w in ws]),
                       pass2_s=spread([w["pass2_s"] for w in ws]))
        emit(rec)
        results[m.value] = rec

        # where the time goes: one prefill and eight decode steps under the
        # profiler; H2O's h2o_scores timed by CUDA events around each call,
        # GemFilter's passes each in a window of its own
        held, prof, spans = {}, {}, []
        with torch.inference_mode():
            if m == Method.GEMFILTER:
                wall, kern = profile_window(torch, lambda: held.update(
                    sel=gemfilter.select_tokens(params, cfg, mcfg, EngineConfig(), tok_t,
                                                n_t, shapes.bucket)))
                prof["pass1"] = breakdown(wall, kern)
                prof["pass1"]["flash_ms"] = kernels_ms(kern, FLASH_BF16) if kern else None
                tok2, n2, _ = held.pop("sel")
                dmcfg = gemfilter.pass2_config(mcfg)
                wall, kern = profile_window(torch, lambda: held.update(
                    out=method_prefill(torch, params, cfg, dmcfg, shapes, tok2, n2)))
                prof["pass2"] = breakdown(wall, kern)
                prof["pass2"]["flash_ms"] = kernels_ms(kern, FLASH_BF16) if kern else None
            else:
                real = att.h2o_scores

                def timed_h2o(*a, **kw):
                    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    e0.record()
                    out = real(*a, **kw)
                    e1.record()
                    spans.append((e0, e1))
                    return out

                att.h2o_scores = timed_h2o
                try:
                    wall, kern = profile_window(torch, lambda: held.update(
                        out=method_prefill(torch, params, cfg, mcfg, shapes, tok_t, n_t)))
                finally:
                    att.h2o_scores = real
                prof["prefill"] = breakdown(wall, kern)
                if m == Method.H2O:
                    torch.cuda.synchronize()
                    h2o_ms = sum(e0.elapsed_time(e1) for e0, e1 in spans)
                    busy = prof["prefill"]["device_busy_ms"]
                    prof["prefill"].update(
                        h2o_scores_calls=len(spans), h2o_scores_events_ms=h2o_ms,
                        h2o_scores_share_of_device_busy=None if busy is None else h2o_ms / busy,
                        flash_ms=kernels_ms(kern, FLASH_BF16) if kern else None,
                        gemm_ms=kernels_ms(kern, *GEMM_NAMES) if kern else None,
                        h2o_qk_gemm_f32_ms=kernels_ms(kern, GEMM_F32) if kern else None)
                    check(len(spans) == L, f"h2o: h2o_scores ran {len(spans)} times, want {L}")
            logits, cache, dmcfg, n_dec = held.pop("out")
            first = logits.argmax(-1).to(torch.int32)
            wall, kern = profile_window(torch, lambda: [
                dm.decode_step(params, cfg, dmcfg, cache, first, n_dec + t,
                               shapes.prefill_capacity + t) for t in range(8)])
            prof["decode_step"] = breakdown(wall, kern, calls=8)
        emit({"phase": f"profile_{m.value}", "gpu": gpu, **prof})
        del logits, cache, first
    by_path = {"llama_3_1_8b": {k: sum(runs[m]["launches"][k] for m in methods[:2])
                                for k in LAUNCH_KEYS},
               "llama_3_1_8b_h2o": runs[Method.H2O]["launches"],
               "llama_3_1_8b_gemfilter": runs[Method.GEMFILTER]["launches"]}
    ref = {m.value: dict(tokens=runs[m]["tokens"][0], **runs[m]["kept"]) for m in methods}
    del runs
    by_path.update(phase_fused(torch, gpu, params, cfg, prompt))
    by_path.update(phase_pyramid(torch, gpu, params, cfg, prompt))
    # the params go on to phase_checkpoint_and_clis, which frees them; the
    # single process's tokens and kept positions to phase_tp_full_width
    return by_path, results, {"params": params, "cfg": cfg, "prompt": prompt, "ref": ref}


def canonical(method, tsp_idx=15):
    """The canonical operating point (window 8, maxpool kernel 7 and
    GemFilter's filter_idx 13 are the defaults)."""
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
            want = (L if fused else 0, L if fused else 0, L, L * (new - 1), L * (new - 1))
            got = (counted["flash_prefill_scores"], counted["window_scores_finish"],
                   counted["flash_prefill"], counted["decode_attn"], counted["decode_prologue"])
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


PYRAMID_CONFIGS = ("llama_60", "llama_35")
ROWS_PROBS_RANGE = "pyramid._rows_probs"


def phase_pyramid(torch, gpu: str, params, cfg, prompt):
    """PyramidInfer at Llama-3.1-8B width on the 8192-token prompt, llama_60
    then llama_35, with FullKV beside them: after a warm-up generate of each,
    one counted generate each (flash 32 launches, the decode kernel none:
    pyramid decode attends in plain torch; the prologue 32 a decode step),
    two more windows per config, FullKV and
    the two alternating, for the median and spread of prefill seconds and
    decode ms per token; peak memory; each layer's valid count after the
    prefill against its planned capacity (``plan_layer_lengths``); then one
    prefill and eight decode steps under the profiler. ``_rows_probs`` runs
    in a profiler range: its device ms are the kernels inside the range's
    spans on the device's timeline (overlaps counted once), beside the
    profiler's attribution of kernels to the ops that launched them and
    CUDA events around each call, whose spans also hold the device's idle
    gaps while the host enqueues. Returns the launches per generate."""
    from fastkv_tpu_torch.core.config import EngineConfig, Method
    from fastkv_tpu_torch.engine import pyramid
    from fastkv_tpu_torch.engine.generate import Engine

    s, new, L = len(prompt), 32, cfg.num_layers
    tok_t = torch.tensor([prompt], device="cuda", dtype=torch.int32)
    n_t = torch.tensor([s], dtype=torch.int32, device="cuda")
    ecfg = EngineConfig(prefill_buckets=(s,), max_new_tokens=new)
    engines = {"fullkv": Engine(params, cfg, canonical(Method.FULLKV), ecfg)}
    for name in PYRAMID_CONFIGS:
        engines[name] = Engine(params, cfg, pyramid_config(name), ecfg)
    runs = {tag: {"windows": []} for tag in engines}

    def window(tag):
        probes = host_probes(torch)
        out, host = host_window(lambda: engines[tag].generate([prompt], new))
        w = dict(engines[tag].last_timing, **host, **probes)
        w["decode_ms_per_token"] = 1e3 * w["decode_s"] / w["decode_steps"]
        runs[tag]["windows"].append(w)
        return out

    by_path = {}
    for name in PYRAMID_CONFIGS:
        engines[name].generate([prompt], 4)  # warm-up at this config's shapes
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        out = window(name)
        r = runs[name]
        r.update(launches=count_launches(), peak=torch.cuda.max_memory_allocated(), tokens=out)
        by_path[f"llama_3_1_8b_pyramidinfer_{name}"] = r["launches"]
        check(len(out[0]) == new and all(0 <= t < cfg.vocab_size for t in out[0]),
              f"pyramidinfer {name}: bad tokens")
        want = (L, 0, L * (new - 1))
        check((r["launches"]["flash_prefill"], r["launches"]["decode_attn"],
               r["launches"]["decode_prologue"]) == want,
              f"pyramidinfer {name}: launches {r['launches']}, want flash, decode and prologue "
              f"{want}")
        check_norm(r["launches"], f"pyramidinfer {name}")
    for _ in range(MORE_WINDOWS):
        for tag in engines:
            out = window(tag)
            if tag in PYRAMID_CONFIGS:
                r = runs[tag]
                r["same_tokens"] = r.get("same_tokens", True) and out == r["tokens"]

    fullkv_prefill = spread([w["prefill_s"] for w in runs["fullkv"]["windows"]])
    for name in PYRAMID_CONFIGS:
        r, mcfg, eng = runs[name], engines[name].mcfg, engines[name]
        shapes = eng.shapes_for(s, new)
        lengths = pyramid.plan_layer_lengths(cfg, mcfg, s, ecfg.capacity_align)
        spans = []
        real = pyramid._rows_probs

        def timed_rows_probs(*a, **kw):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            with torch.profiler.record_function(ROWS_PROBS_RANGE):
                out = real(*a, **kw)
            e1.record()
            spans.append((e0, e1))
            return out

        held = {}
        with torch.inference_mode():
            pyramid._rows_probs = timed_rows_probs
            try:
                for _ in range(3):  # a window in which the profiler recorded no kernel
                    spans.clear()
                    ranges = {ROWS_PROBS_RANGE: [0, 0.0, None, None, 0]}
                    wall, kern = profile_window(torch, lambda: held.update(out=pyramid.prefill(
                        params, cfg, mcfg, ecfg, shapes, tok_t, n_t, want_decode_state=True)),
                        ranges=ranges)
                    if kern:
                        break
            finally:
                pyramid._rows_probs = real
            torch.cuda.synchronize()
            prof = {"prefill": breakdown(wall, kern)}
            rows_ms = sum(e0.elapsed_time(e1) for e0, e1 in spans)
            range_calls, attributed, in_spans, in_spans_merged, n_spans = ranges[ROWS_PROBS_RANGE]
            # the kernels on the device's timeline inside its spans, one span
            # a call; else the profiler's attribution by launching op (which
            # read more than the event spans hold at llama_60 on the H100)
            from_spans = n_spans == len(spans)
            rows_dev = in_spans_merged if from_spans else attributed
            busy = prof["prefill"]["device_busy_ms"]
            check(not kern or (range_calls == len(spans) and rows_dev > 0),
                  f"pyramidinfer {name}: the profiler saw {range_calls} of {len(spans)} "
                  f"_rows_probs calls, {rows_dev} device ms in them")
            prof["prefill"].update(
                rows_probs_calls=len(spans),
                rows_probs_device_ms=rows_dev if kern else None,
                rows_probs_device_ms_from="device_spans" if from_spans else "attribution",
                rows_probs_device_spans=n_spans,
                rows_probs_share_of_device_busy=None if busy is None else rows_dev / busy,
                rows_probs_attributed_ms=attributed if kern else None,
                rows_probs_kernels_in_device_spans_summed_ms=in_spans,
                rows_probs_events_ms=rows_ms,
                rows_probs_events_share_of_host_ms=rows_ms / prof["prefill"]["host_ms"],
                flash_ms=kernels_ms(kern, FLASH_BF16) if kern else None,
                gemm_ms=kernels_ms(kern, *GEMM_NAMES) if kern else None,
                rows_probs_qk_gemm_f32_ms=kernels_ms(kern, GEMM_F32) if kern else None)
            logits, cache, ps = held.pop("out")
            counts = cache.valid[:, 0, 0].sum(-1).tolist()  # [L] at the batch's one example
            check(len(spans) == L and counts[0] == s
                  and all(c <= cap for c, cap in zip(counts, lengths))
                  and counts[-1] < counts[0] and bool(torch.isfinite(logits).all()),
                  f"pyramidinfer {name}: rows_probs calls {len(spans)}, valid counts {counts} "
                  f"against capacities {lengths[:L]}")
            first = logits.argmax(-1).to(torch.int32)
            r_dyn = pyramid.recent_length(n_t, mcfg)
            wall, kern = profile_window(torch, lambda: [
                pyramid.decode_step(params, cfg, mcfg, cache, ps, first, n_t + t,
                                    shapes.prefill_capacity + t, t + 1, n_t, r_dyn)
                for t in range(8)])
            prof["decode_step"] = breakdown(wall, kern, calls=8)
            state_bytes = sum(x.numel() * x.element_size() for x in ps)
        del logits, cache, ps, first
        ws = r["windows"]
        emit({
            "phase": f"full_width_pyramidinfer_{name}", "model": cfg.name, "prompt_len": s,
            "new_tokens": new, "config": f"fastkv_tpu_torch/configs/pyramidinfer/{name}.json",
            "prefill_s": spread([w["prefill_s"] for w in ws]),
            "fullkv_prefill_s_same_run": fullkv_prefill,
            "decode_ms_per_token": spread([w["decode_ms_per_token"] for w in ws]),
            "fullkv_decode_ms_per_token_same_run": spread(
                [w["decode_ms_per_token"] for w in runs["fullkv"]["windows"]]),
            "max_memory_allocated_bytes": r["peak"], "decode_state_bytes": state_bytes,
            "launches": r["launches"], "layer_valid_counts": counts,
            "layer_capacities": lengths[:L], "distinct_capacities": len(set(lengths[:L])),
            "retain_rate": sum(counts) / (L * s), "score_rows": pyramid.decode_buffer_rows(mcfg, s),
            "host": {k: spread([w[k] for w in ws]) for k in ("py_loop_ms", "launch_us")},
            "gpu": gpu, "tokens_head": r["tokens"][0][:8],
            "repeats_give_the_same_tokens": r["same_tokens"]})
        emit({"phase": f"profile_pyramidinfer_{name}", "gpu": gpu, **prof})
    return by_path


def serve_pyramid(torch, gpu: str, params, cfg, prompts):
    """The serving run (SERVE_REQUESTS: four slots, bucket 8192,
    prefill_chunk 2048) under PyramidInfer llama_60: every admission whole at
    the one bucket, no chunk or finish event, every request its budget, no
    decode kernel launch and one prologue launch a layer a decode step.
    Returns the launches of the run."""
    import numpy as np

    from fastkv_tpu_torch.core.config import EngineConfig
    from fastkv_tpu_torch.engine.scheduler import Scheduler

    sched = Scheduler(params, cfg, pyramid_config("llama_60"),
                      EngineConfig(prefill_chunk=SERVE_CHUNK, chunk_decode_steps=1),
                      max_batch=4, bucket=SERVE_BUCKET, max_new_tokens=32)
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
    by_id = {r.req_id: r for r in done}
    kinds = {}
    for e in sched.events:
        kinds[e[0]] = kinds.get(e[0], 0) + 1
    stamps = [e[1] for e in sched.events if e[0] == "decode"]
    gaps_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    finished = (sorted(by_id) == list(range(len(SERVE_REQUESTS)))
                and all(len(by_id[i].tokens) == budget
                        for i, (_, budget) in enumerate(SERVE_REQUESTS)))
    emit({"phase": "serve_pyramidinfer_llama_60", "model": cfg.name, "method": "pyramidinfer",
          "prefill_chunk": SERVE_CHUNK, "max_batch": 4, "bucket": SERVE_BUCKET,
          "requests": [list(r) for r in SERVE_REQUESTS], "launches": counted, "events": kinds,
          "ttft_s": [by_id[i].metrics["ttft_s"] for i in sorted(by_id)],
          "tpot_s": [by_id[i].metrics["tpot_s"] for i in sorted(by_id)],
          "inter_token_gap_ms": {"median": float(np.median(gaps_ms)), "max": max(gaps_ms),
                                 "n": len(gaps_ms)},
          "decode_state_bytes": sum(x.numel() * x.element_size() for x in sched.pstate),
          "wall_s": wall, "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
          "all_finished_with_their_budget": finished, "gpu": gpu})
    check(finished, "serve_pyramidinfer: a request did not finish with its budget")
    check(not kinds.get("chunk") and not kinds.get("finish")
          and counted["flash_prefill"] == cfg.num_layers * len(SERVE_REQUESTS)
          and counted["decode_attn"] == 0
          and counted["decode_prologue"] == cfg.num_layers * kinds.get("decode", 0)
          and counted["flash_prefill_rect"] == 0,
          f"serve_pyramidinfer: events {kinds}, launches {counted}")
    check_norm(counted, "serve_pyramidinfer")
    return counted


# ---------------------------------------------------------------------------
# checkpoint and CLIs: Llama-3.1-8B written, loaded, evaluated, benchmarked
# ---------------------------------------------------------------------------

class ByteTokenizer:
    """A stand-in for an HF tokenizer (the card's machine has no
    ``transformers``): one id per UTF-8 byte, shifted by 3, so that a newline
    is id 13 as in Llama-3 (the needle's sentence boundary); 1 is BOS, 2 EOS.
    Every other id decodes as its byte modulo 256, so a random model's tokens
    (most of them past the bytes) reach the records and the scorers."""

    bos_token_id, eos_token_id, shift = 1, 2, 3

    def encode(self, text, add_special_tokens=True):
        ids = [b + self.shift for b in text.encode("utf-8")]
        return [self.bos_token_id] + ids if add_special_tokens else ids

    def __call__(self, text, add_special_tokens=True):
        import types

        return types.SimpleNamespace(input_ids=self.encode(text, add_special_tokens))

    def decode(self, ids, skip_special_tokens=False):
        out = bytes((i - self.shift) % 256 for i in ids if i >= self.shift)
        return out.decode("utf-8", errors="replace")

    def convert_tokens_to_ids(self, token):
        return None

    def apply_chat_template(self, messages, tokenize=False, add_generation_prompt=True):
        text = "".join(f"<|{m['role']}|>{m['content']}" for m in messages)
        return text + ("<|assistant|>" if add_generation_prompt else "")


CKPT_METHODS = ("fastkv", "fullkv")
TP_NEW = 16  # the throughput CLI's generation length
# the evals' generation lengths: LongBench multifieldqa_en, RULER, needle
EVAL_NEW = {"longbench": 64, "ruler": 64, "needle": 30}


def checkpoint_dir(need: int) -> str:
    """A fresh directory under the temporary directory (TMPDIR when set),
    which must have room for ``need`` bytes; nothing is written elsewhere."""
    import shutil
    import tempfile

    base = tempfile.gettempdir()
    free = shutil.disk_usage(base).free
    check(free > need * 1.05,
          f"checkpoint_and_clis: {base} has {free} bytes free, the checkpoint needs {need}")
    return tempfile.mkdtemp(prefix="fastkv_ckpt_", dir=base)


def filesystem(path: str) -> str:
    """The type and mount point of the filesystem that holds ``path``."""
    path, best = os.path.realpath(path), ("unknown", "")
    with open("/proc/mounts") as f:
        for line in f:
            _, mount, fstype = line.split()[:3]
            inside = path == mount or path.startswith(mount.rstrip("/") + "/")
            if inside and len(mount) >= len(best[1]):
                best = (fstype, mount)
    return f"{best[0]} at {best[1]}"


def write_eval_data(root: str) -> dict:
    """Synthetic task files: two LongBench multifieldqa_en examples of about
    6000 tokens, two RULER niah_single_1 examples under 8192/, and a
    haystack of made-up essays."""
    import random

    rnd = random.Random(SEED)
    words = ("river stone lamp orchard ledger harbor violet engine summer paper "
             "granite willow signal copper meadow lantern").split()

    def text(n_chars):
        out = []
        while sum(len(w) + 1 for w in out) < n_chars:
            out.append(rnd.choice(words))
            if rnd.random() < 0.08:
                out[-1] += ".\n"
        return " ".join(out)[:n_chars]

    lb = os.path.join(root, "LongBench")
    os.makedirs(lb)
    with open(os.path.join(lb, "multifieldqa_en.jsonl"), "w") as f:
        for i in range(2):
            f.write(json.dumps({
                "input": "Which lamp stands by the harbor?", "context": text(6000 - 300 * i),
                "answers": ["the copper lamp"], "length": 6000, "dataset": "multifieldqa_en",
                "language": "en", "all_classes": None, "_id": f"smoke{i}"}) + "\n")
    ru = os.path.join(root, "RULER", "8192")
    os.makedirs(ru)
    with open(os.path.join(ru, "niah_single_1.jsonl"), "w") as f:
        for i in range(2):
            key = 7_431_902 + i
            hay = text(7000)
            cut = len(hay) // 2
            f.write(json.dumps({
                "index": i, "input": (hay[:cut] + f" The special magic number is {key}. "
                                      + hay[cut:] + "\nWhat is the special magic number?"),
                "outputs": [str(key)], "length": 7100}) + "\n")
    hay_dir = os.path.join(root, "essays")
    os.makedirs(hay_dir)
    for i in range(2):
        with open(os.path.join(hay_dir, f"essay{i}.txt"), "w") as f:
            f.write(text(5000))
    return {"longbench": lb, "ruler": os.path.join(root, "RULER"), "haystack": hay_dir}


def eval_args(model_dir: str, method: str, save_dir: str, data_dir: str, **kw):
    """The eval CLIs' namespace (their defaults, the canonical method point)."""
    import argparse

    from fastkv_tpu_torch.evals import longbench

    p = argparse.ArgumentParser()
    longbench.add_method_args(p)
    args = p.parse_args(["--method", method])
    for k, v in dict(model_path=model_dir, save_dir=save_dir, data_dir=data_dir,
                     max_num_examples=0, **kw).items():
        setattr(args, k, v)
    return args


def phase_checkpoint_and_clis(torch, gpu: str, held: dict):
    """Llama-3.1-8B at full width and depth: the SEED params of
    ``phase_full_width`` (``held``, whose params it takes and frees) written
    as an HF bf16 checkpoint (4 shards of at most 5 GB and an index, as
    published) into a temporary directory, loaded back with ``load_params``
    (every leaf equal), FastKV and FullKV generate on the 8192-token prompt
    from the loaded params with the in-memory params' tokens (counted); then
    the latency CLI (prefill and e2e, in process), the evals through their
    runners and scorers on synthetic files (LongBench, RULER, needle) with a
    byte-level stand-in tokenizer, each counted, one LongBench record a
    method rebuilt outside its runner (prompt and tokens), and last the
    throughput CLI (its own subprocess per method, whose launches the
    children report), its batch-1 tokens held to ``Engine.generate``'s from
    the loaded params. Returns the launches per path."""
    import dataclasses
    import importlib.util
    import platform
    import shutil

    from fastkv_tpu_torch.bench import latency
    from fastkv_tpu_torch.core import weights
    from fastkv_tpu_torch.core.config import EngineConfig, Method
    from fastkv_tpu_torch.engine.generate import Engine
    from fastkv_tpu_torch.evals import longbench, needle, ruler
    from fastkv_tpu_torch.utils.testing import write_model_dir

    t_phase = time.perf_counter()
    params, cfg, prompt = held.pop("params"), held["cfg"], held["prompt"]
    L, s, new = cfg.num_layers, len(prompt), 32
    leaves = {**{k: v for k, v in params.items() if k != "layers"}, **params["layers"]}
    nbytes = sum(t.numel() * 2 for t in leaves.values())  # as bf16
    root = checkpoint_dir(nbytes + (1 << 30))
    model_dir = os.path.join(root, "Llama-3.1-8B")
    by_path, rec = {}, {"phase": "checkpoint_and_clis", "model": cfg.name, "dir": root,
                        "filesystem": filesystem(root), "host_kernel": platform.release(),
                        "gpu": gpu}
    try:
        t0 = time.perf_counter()
        written = write_model_dir(cfg, params, model_dir, dtype="bfloat16")
        rec["write_s"] = time.perf_counter() - t0
        shards = sorted(f for f in os.listdir(model_dir) if f.endswith(".safetensors"))
        sizes = [os.path.getsize(os.path.join(model_dir, f)) for f in shards]
        check(written == nbytes and len(shards) == 4 and max(sizes) <= 5 * 10**9
              and os.path.exists(os.path.join(model_dir, weights.INDEX_FILE)),
              f"checkpoint: {written} bytes in shards {sizes}, want {nbytes} in 4 of <= 5 GB")
        lcfg = weights.model_config_from_dir(model_dir)
        check(dataclasses.replace(lcfg, name=cfg.name) == cfg,
              "checkpoint: config.json does not give the model's config back")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = weights.load_params(model_dir, lcfg)
        torch.cuda.synchronize()
        rec["load_s"] = time.perf_counter() - t0
        got = {**{k: v for k, v in loaded.items() if k != "layers"}, **loaded["layers"]}
        unequal = [k for k, v in leaves.items() if not torch.equal(got[k], v)]
        check(set(got) == set(leaves) and not unequal,
              f"checkpoint: leaves not equal after a load: {unequal}")
        rec.update(bytes=written, shards=sizes, leaves_equal=len(leaves),
                   write_gb_s=written / rec["write_s"] / 1e9,
                   load_gb_s=written / rec["load_s"] / 1e9)
        # where a load's time goes, on its largest tensor: the host's copy out
        # of the mapped file into the pinned buffer, then the copy to the card
        src = weights.ShardReader(model_dir).read("model.embed_tokens.weight")
        staged = weights.Staging().view(src.dtype, src.shape)
        t0 = time.perf_counter()
        staged.copy_(src)
        t1 = time.perf_counter()
        staged.to("cuda")
        t2 = time.perf_counter()
        rec.update(embed_host_copy_gb_s=src.nbytes / (t1 - t0) / 1e9,
                   embed_to_card_gb_s=src.nbytes / (t2 - t1) / 1e9)
        del src, staged

        ecfg = EngineConfig(prefill_buckets=(s,), max_new_tokens=new)
        engines = {m: Engine(params, cfg, canonical(Method(m)), ecfg) for m in CKPT_METHODS}
        want = {m: eng.generate([prompt], new) for m, eng in engines.items()}
        del engines, params, leaves
        torch.cuda.empty_cache()
        zero_launches()
        tokens = {m: Engine(loaded, lcfg, canonical(Method(m)), ecfg).generate([prompt], new)
                  for m in CKPT_METHODS}
        by_path["llama_3_1_8b_checkpoint"] = counted = count_launches()
        check(tokens == want, "checkpoint: the loaded params generate other tokens")
        check((counted["flash_prefill"], counted["decode_attn"], counted["decode_prologue"])
              == (2 * L, 2 * L * (new - 1), 2 * L * (new - 1)),
              f"checkpoint: launches {counted}")
        rec.update(tokens_equal=True, tokens_head={m: t[0][:8] for m, t in tokens.items()},
                   launches=counted)
        emit(rec)
        # the throughput CLI's request (all-ones prompt, TP_NEW tokens) from
        # the loaded params, which are the CLI's: the preset's seed-0 weights
        ladder_want = {m: Engine(loaded, lcfg, canonical(Method(m)),
                                 EngineConfig(prefill_buckets=(s,), max_new_tokens=TP_NEW))
                       .generate([[1] * s], TP_NEW)[0] for m in CKPT_METHODS}
        weight_bytes = sum(v.numel() * v.element_size() for v in got.values())
        del loaded, got
        torch.cuda.empty_cache()

        # the latency CLI, in process, on the checkpoint
        lat, runs = {}, 3
        zero_launches()
        for mode in ("prefill", "e2e"):
            for m in CKPT_METHODS:
                out = latency.main([mode, "--model_path", model_dir, "--method", m,
                                    "--context_lengths", str(s), "--genlen", str(new),
                                    "--runs", str(runs),
                                    "--save_dir", os.path.join(root, "latency")])
                check(len(out) == 1, f"latency {mode} {m}: {out}")
                r = out[0]
                keys = ({"context", "mean_s", "std_s", "ci95_s", "peak_mem"} if mode == "prefill"
                        else {"context", "genlen", "prefill_mean_s", "prefill_ci95_s",
                              "decode_mean_s", "decode_ci95_s", "tokens_per_s", "peak_mem"})
                check(set(r) == keys and isinstance(r["peak_mem"], int)
                      and r["peak_mem"] > weight_bytes, f"latency {mode} {m}: {r}")
                lat[f"{mode}_{m}"] = r
        by_path["latency_cli"] = counted = count_launches()
        # warm-up + runs per call: prefill one token each, e2e new - 1 decode steps
        calls = 2 * (1 + runs)
        check((counted["flash_prefill"], counted["decode_attn"], counted["decode_prologue"])
              == (2 * calls * L, calls * L * (new - 1), calls * L * (new - 1)),
              f"latency CLI launches {counted}")
        emit({"phase": "latency_cli", "model": cfg.name, "context": s, "genlen": new,
              "runs": runs, "weights_bytes": weight_bytes, "records": lat, "launches": counted,
              "gpu": gpu})

        # the evals: runners and scorers on synthetic files, a stand-in tokenizer
        data = write_eval_data(os.path.join(root, "data"))
        have_rouge = importlib.util.find_spec("rouge_score") is not None
        tok = ByteTokenizer()
        zero_launches()
        evals, engines = {}, {}
        for m in CKPT_METHODS:
            lb_args = eval_args(model_dir, m, os.path.join(root, "lb"), data["longbench"])
            engines[m] = engine = longbench.build_engine(lb_args)[0]
            longbench.run_task(engine, tok, lb_args, "multifieldqa_en")
            ru_args = eval_args(model_dir, m, os.path.join(root, "ruler"), data["ruler"],
                                context_length=8192)
            ruler.run_task(engine, tok, ru_args, "niah_single_1")
            haystack = needle.read_haystack(data["haystack"], tok, 8000)
            response = needle.run_point(engine, tok, haystack, 8000, 50)
            evals[m] = {"needle_response_head": response[:40],
                        "needle_overlap_score": needle.overlap_score(response),
                        "needle_rouge1_score": needle.score_response(response) if have_rouge
                        else "not measured: rouge_score is not installed on this machine"}
            check(isinstance(evals[m]["needle_overlap_score"], float), "needle: score")
            for task, d in (("multifieldqa_en", lb_args.save_dir),
                            ("niah_single_1", ru_args.save_dir)):
                with open(os.path.join(d, task, f"{m}.json")) as f:
                    recs = [json.loads(line) for line in f]
                check(len(recs) == 2 and all(set(r) >= {"prompt", "pred", "answers", "length"}
                                             for r in recs), f"eval {task} {m}: records")
                evals[m][f"{task}_pred_head"] = recs[0]["pred"][:40]
            del engine
        by_path["evals"] = counted = count_launches()
        # the first LongBench example rebuilt outside the runner: the task's
        # template in the chat template, tokenized, cut to the model's length
        # and generated by the same engine; the runner must have sent that
        # prompt and written those tokens, decoded, as its prediction
        with open(os.path.join(data["longbench"], "multifieldqa_en.jsonl")) as f:
            ex = json.loads(f.readline())
        text = tok.apply_chat_template(
            [{"role": "user", "content": longbench.TASK_PROMPT["multifieldqa_en"].format(**ex)}],
            tokenize=False, add_generation_prompt=True)
        ids = longbench.middle_truncate(tok(text).input_ids,
                                        longbench.model_max_len(model_dir, "fastkv"))
        for m in CKPT_METHODS:
            with open(os.path.join(root, "lb", "multifieldqa_en", f"{m}.json")) as f:
                got0 = json.loads(f.readline())
            gen = engines.pop(m).generate([ids], EVAL_NEW["longbench"],
                                          eos_ids=[tok.eos_token_id])[0]
            pred = tok.decode(gen, skip_special_tokens=True)
            check(got0["prompt"] == text and got0["pred"] == pred and len(pred) > 0,
                  f"eval multifieldqa_en {m}: the runner's prompt or prediction differs from "
                  f"a direct generate: {got0['pred'][:40]!r} vs {pred[:40]!r}")
            evals[m]["multifieldqa_en_tokens_equal_direct"] = len(gen)
        torch.cuda.empty_cache()
        n_gen = 2 * (2 + 2 + 1)
        steps = 2 * (2 * (EVAL_NEW["longbench"] - 1) + 2 * (EVAL_NEW["ruler"] - 1)
                     + EVAL_NEW["needle"] - 1)
        check((counted["flash_prefill"], counted["decode_attn"], counted["decode_prologue"])
              == (n_gen * L, steps * L, steps * L), f"eval launches {counted}")
        lb_rows = longbench.score_results_dir(os.path.join(root, "lb"), ["multifieldqa_en"])
        ru_rows = ruler.score_results_dir(os.path.join(root, "ruler"))
        scores = {"longbench_multifieldqa_en": {r[0]: r[1] for r in lb_rows[1:]},
                  "ruler_niah_single_1": {r[0]: r[1] for r in ru_rows[1:]}}
        for table in scores.values():
            check(all(isinstance(table[m], float) for m in CKPT_METHODS),
                  f"eval scores not floats: {scores}")
        check(all(os.path.exists(os.path.join(root, d, "results.csv")) for d in ("lb", "ruler")),
              "eval: results.csv not written")
        emit({"phase": "evals", "model": cfg.name, "scores": scores, "per_method": evals,
              "launches": counted, "gpu": gpu})
        # tensor and pipeline parallelism: four ranks, each loading its shard
        # of this checkpoint, while it exists
        del engines
        gc.collect()
        by_path.update(phase_tp_full_width(torch, gpu, model_dir, prompt, held["ref"]))
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # the throughput CLI: its own subprocess per method, random weights (the
    # preset's seed 0, as the loaded params); each child reports its launches
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    batches, tp_runs = (1, 4, 16), 2
    cmd = [sys.executable, "-m", "fastkv_tpu_torch.bench.throughput", "--preset", "llama-3.1-8b",
           "--ctx", str(s), "--genlen", str(TP_NEW), "--runs", str(tp_runs),
           "--batches", *map(str, batches), "--methods", *CKPT_METHODS]
    r = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                       capture_output=True, text=True, timeout=600)
    lines = [ln for ln in r.stderr.splitlines() if "tok/s" in ln]
    for ln in lines:
        print(ln, flush=True)
    check(r.returncode == 0 and len([ln for ln in lines if "] B=" in ln]) == 6,
          f"throughput CLI exited {r.returncode}: {r.stderr[-2000:]}")
    counted, ladder = dict.fromkeys(LAUNCH_KEYS, 0), {}
    for m in CKPT_METHODS:
        got = re.findall(rf"\[{m}\] kernel launches: flash_prefill (\d+), decode_attn (\d+), "
                         rf"decode_prologue (\d+), add_rms_norm (\d+)", r.stderr)
        check(len(got) == 1, f"throughput CLI: no launch line for {m}")
        for key, n in zip(("flash_prefill", "decode_attn", "decode_prologue", "add_rms_norm"),
                          got[0]):
            counted[key] += int(n)
        toks = {int(b): [int(t) for t in ts.split()]
                for b, ts in re.findall(rf"\[{m}\] B=(\d+) tokens ([\d ]+)", r.stderr)}
        check(sorted(toks) == list(batches) and toks[1] == ladder_want[m],
              f"throughput CLI {m}: batch-1 tokens {toks.get(1)} differ from Engine.generate's "
              f"{ladder_want[m]}")
        # beside it, not checked: a larger batch may split the decode kernel
        # otherwise and round differently
        ladder[m] = {b: next((i for i, (x, y) in enumerate(zip(t, toks[1])) if x != y), len(t))
                     for b, t in toks.items()}
    by_path["throughput_cli"] = counted
    # each child: one prefill, then warm-up + runs generates a rung
    steps = (TP_NEW - 1) * (1 + tp_runs) * len(batches)
    check((counted["flash_prefill"], counted["decode_attn"], counted["decode_prologue"])
          == (2 * L, 2 * L * steps, 2 * L * steps), f"throughput CLI launches {counted}")
    emit({"phase": "throughput_cli", "seconds": time.perf_counter() - t0,
          "launches": counted, "batch1_tokens_equal_engine": True,
          "tokens_equal_to_batch1_leading": ladder,
          "phase_seconds": time.perf_counter() - t_phase, "gpu": gpu})
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
        want = (L, L * (new - 1), L * (new - 1), 0)  # an int8 row: no prologue kernel
        got = (counted["flash_prefill"], counted["decode_attn"], counted["decode_attn_int8"],
               counted["decode_prologue"])
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
        check(counted["decode_attn"] == counted["decode_prologue"] == cfg.num_layers * (new - 1),
              f"{tag} {m.value}: decode_attn and decode_prologue launched "
              f"{counted['decode_attn']} and {counted['decode_prologue']} times")

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


def phase_dsv3(torch, gpu: str, s: int = 8192, new: int = 32):
    """DeepSeek-V3 at one chip's share of EP32 (``dsv3_config``: 30 layers,
    MLA over 128 heads with its query LoRA, 8 of 256 experts held): FastKV
    (TSP at 14) and FullKV through Engine.generate on one s-token prompt, new
    tokens, batch 1, each run counted: flash once a layer, the decode
    prologue once a layer a step, the norm kernel three times (the two norm
    sites and the query LoRA's norm), the decode kernel never (absorbed
    latent attention in plain torch). Returns the launches summed over both."""
    from fastkv_tpu_torch.core.config import EngineConfig, Method, MethodConfig
    from fastkv_tpu_torch.engine.generate import Engine
    from fastkv_tpu_torch.models import deepseek_v2

    cfg = dsv3_config()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    t0 = time.perf_counter()
    params = deepseek_v2.init_params(cfg, gen)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompt = torch.randint(0, cfg.vocab_size, (s,), generator=gen, device="cuda").tolist()
    launches = dict.fromkeys(LAUNCH_KEYS, 0)
    L, steps = cfg.num_layers, new - 1
    for m in (Method.FASTKV, Method.FULLKV):
        mcfg = MethodConfig(method=m, eviction_mode="proportional", retain_rate=0.1,
                            tsp_rate=0.2, tsp_idx=14)
        eng = Engine(params, cfg, mcfg, EngineConfig(prefill_buckets=(s,), max_new_tokens=new))
        eng.generate([prompt[:64]], 2)  # the decode step's capture, outside the count
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        out, host = host_window(lambda: eng.generate([prompt], new))
        counted = count_launches()
        for k in launches:
            launches[k] += counted[k]
        check(len(out[0]) == new and all(0 <= t < cfg.vocab_size for t in out[0]),
              f"dsv3 {m.value}: bad tokens")
        check(counted["flash_prefill"] == L and counted["decode_attn"] == 0
              and counted["decode_prologue"] == L * steps,
              f"dsv3 {m.value}: want flash {L}, decode_attn 0, decode_prologue {L * steps}; "
              f"launches {counted}")
        check_norm(counted, f"dsv3 {m.value}", NORMS_A_LAYER["deepseek_v3_ep32"])
        timing = dict(eng.last_timing)
        emit({"phase": f"dsv3_ep32_{m.value}", "model": cfg.name, "prompt_len": s,
              "new_tokens": new, "prefill_s": timing["prefill_s"],
              "decode_ms_per_token": 1e3 * timing["decode_s"] / timing["decode_steps"],
              "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
              "launches": counted, "host": host, "weights_init_s": init_s, "gpu": gpu,
              "tokens_head": out[0][:8]})
        del eng
    del params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# serving: the continuous-batching Scheduler at Llama-3.1-8B width
# ---------------------------------------------------------------------------

SERVE_REQUESTS = ((8192, 32), (7001, 8), (4096, 24), (2500, 16), (8000, 32), (6000, 12))
SERVE_BUCKET, SERVE_CHUNK = 8192, 2048


LAUNCH_KEYS = ("flash_prefill", "flash_prefill_rect", "flash_prefill_scores",
               "window_scores_finish", "decode_attn", "decode_attn_int8", "decode_attn_window",
               "flash_prefill_aux", "flash_prefill_full", "decode_prologue", "add_rms_norm")


def count_launches():
    """The kernels' launch counts since they were last set to 0 (the forms'
    counts are those of the kernel's launches in that form; the finishing
    pass is a kernel of its own)."""
    from fastkv_tpu_torch.ops import add_rms_norm as arn
    from fastkv_tpu_torch.ops import decode_attn as da
    from fastkv_tpu_torch.ops import decode_prologue as dp
    from fastkv_tpu_torch.ops import flash_prefill as fp

    return dict(zip(LAUNCH_KEYS, (fp.launches, fp.rect_launches, fp.scores_launches,
                                  fp.finish_launches, da.launches, da.int8_launches,
                                  da.window_launches, fp.aux_launches, fp.full_launches,
                                  dp.launches, arn.launches)))


def zero_launches():
    from fastkv_tpu_torch.ops import add_rms_norm as arn
    from fastkv_tpu_torch.ops import decode_attn as da
    from fastkv_tpu_torch.ops import decode_prologue as dp
    from fastkv_tpu_torch.ops import flash_prefill as fp

    fp.launches = fp.rect_launches = fp.scores_launches = fp.finish_launches = 0
    fp.aux_launches = fp.full_launches = 0
    da.launches = da.int8_launches = da.window_launches = 0
    dp.launches = arn.launches = 0


def check_prologue(counted: dict, where: str) -> None:
    """The decode prologue (``ops.decode_prologue``) launches once a layer a
    decode step, as the decode kernel does, eager steps and replays alike:
    its count equals the decode kernel's bf16-cache launches, and is 0 over
    an int8 cache, whose row keeps the quantize-then-write composition. The
    callers hold the decode kernel's count to layers x steps. (PyramidInfer's
    decode attends in plain torch: its callers hold its prologue alone to
    layers x steps.) And the norm kernel as ``check_norm`` says."""
    want = counted["decode_attn"] - counted["decode_attn_int8"]
    check(counted["decode_prologue"] == want,
          f"{where}: decode_prologue launched {counted['decode_prologue']} times, want {want} "
          f"(one a layer a bf16-cache decode step); launches {counted}")
    check_norm(counted, where)


# the norm kernel's launches a decode layer where a path takes more than
# two: DeepSeek-V3's query LoRA norms its latent too
NORMS_A_LAYER = {"deepseek_v3_ep32": 3}


def norm_want(counted: dict, per_layer: int = 2) -> int:
    """The norm kernel's (``ops.add_rms_norm``) launches a path calls for:
    two a decode layer a step (the attention's norm; the residual add with
    the MLP's norm), on every cache and method (``per_layer``: three with a
    query LoRA). A decode layer launches the decode kernel once
    (PyramidInfer's none) and the prologue once (none over an int8 cache),
    so its steps are the larger of the two counts."""
    return per_layer * max(counted.get("decode_attn", 0), counted.get("decode_prologue", 0))


def check_norm(counted: dict, where: str, per_layer: int = 2) -> None:
    want = norm_want(counted, per_layer)
    check(counted.get("add_rms_norm") == want,
          f"{where}: add_rms_norm launched {counted.get('add_rms_norm')} times, want "
          f"{want} ({per_layer} a layer a decode step); launches {counted}")


def phase_serve(torch, gpu: str):
    """The Scheduler at Llama-3.1-8B width: four slots, bucket 8192, the six
    requests of SERVE_REQUESTS (the first four admit at once, the last two
    while the others decode: chunk-wise in 2048-token chunks, or monolithic
    with prefill_chunk None; H2O and GemFilter admit whole with the chunk
    set). One counted run per method. Returns the launches per run."""
    import numpy as np

    from fastkv_tpu_torch.core.config import EngineConfig, Method, ModelConfig
    from fastkv_tpu_torch.engine import chunked
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
                               ("fastkv_kv_int8_fused", Method.FASTKV, SERVE_CHUNK, int8_fused),
                               ("h2o", Method.H2O, SERVE_CHUNK, {}),
                               ("gemfilter", Method.GEMFILTER, SERVE_CHUNK, {})):
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
            "cache_capacity": sched.shapes.total_capacity,
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
        if chunk and chunked.supported(canonical(m), cfg):
            check(counted["flash_prefill_rect"] > 0 and kinds.get("chunk", 0) > 0,
                  f"serve_{tag}: no chunked admission through the rectangular kernel")
        else:  # every admission whole, the chunk set or not
            check(counted["flash_prefill_rect"] == 0 and not kinds.get("chunk")
                  and not kinds.get("finish"), f"serve_{tag}: a chunked admission: {kinds}")
        # fused: every layer of a monolithic admission, only segment B
        # (layers tsp_idx + 1 on) of a chunked one's finish
        seg_b = cfg.num_layers - (canonical(m).tsp_idx + 1)
        want = (cfg.num_layers * kinds.get("prefill", 0) + seg_b * kinds.get("finish", 0)
                if ekw else 0)
        check(counted["flash_prefill_scores"] == want == counted["window_scores_finish"]
              and counted["decode_attn_int8"] == (counted["decode_attn"] if ekw else 0),
              f"serve_{tag}: fused {counted['flash_prefill_scores']} (want {want}), "
              f"int8 decode {counted['decode_attn_int8']} of {counted['decode_attn']}")
        check_prologue(counted, f"serve_{tag}")
        if tag in ("fastkv", "fastkv_kv_int8_fused"):
            profile_serve(torch, gpu, params, cfg, sched, prompts[4], tag)
        del sched, done, by_id
    launches["serve_pyramidinfer_llama_60"] = serve_pyramid(torch, gpu, params, cfg, prompts)
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
# serving across replicas and processes: FrontDoor and dispatch
# ---------------------------------------------------------------------------

def free_cuda(torch) -> None:
    """Release a phase's device memory before the next phase, once the
    phase has returned: its drain wrappers (``kept_events``) and trace hooks
    make reference cycles through schedulers that hold the params and
    caches, and only the cycle collector frees them."""
    gc.collect()
    torch.cuda.empty_cache()


def kept_events(sched, method_name: str):
    """Every event of every drain of ``sched`` (``run`` and ``_run_loop``
    clear ``events`` at their start): the drain method, wrapped on the
    instance, appends them to the returned list as it returns or raises."""
    kept = []
    inner = getattr(sched, method_name)

    def drain(*args, **kwargs):
        try:
            return inner(*args, **kwargs)
        finally:
            kept.extend(sched.events)

    setattr(sched, method_name, drain)
    return kept


def launches_called(events_by_replica, cfg, mcfg):
    """The flash and decode launches FastKV Schedulers' events call for,
    summed over the replicas (with each replica's event kinds): a monolithic
    admission runs every layer's square form, a chunk the rectangular form
    in layers [0, tsp_idx], a chunked finish the square form in the layers
    after it, a decode step one decode launch and one prologue launch a
    layer, and two norm launches."""
    L, seg = cfg.num_layers, mcfg.tsp_idx + 1
    kinds_by_replica = []
    called = {"flash_prefill": 0, "flash_prefill_rect": 0, "decode_attn": 0,
              "decode_prologue": 0, "add_rms_norm": 0}
    for events in events_by_replica:
        kinds = {}
        for e in events:
            kinds[e[0]] = kinds.get(e[0], 0) + 1
        kinds_by_replica.append(kinds)
        called["flash_prefill"] += (L * kinds.get("prefill", 0) + seg * kinds.get("chunk", 0)
                                    + (L - seg) * kinds.get("finish", 0))
        called["flash_prefill_rect"] += seg * kinds.get("chunk", 0)
        called["decode_attn"] += L * kinds.get("decode", 0)
        called["decode_prologue"] += L * kinds.get("decode", 0)
        called["add_rms_norm"] += 2 * L * kinds.get("decode", 0)
    return kinds_by_replica, called


def gaps_ms(events_by_replica):
    """Inter-token gaps of running requests, each replica's decode stamps
    apart: (median, longest, count)."""
    import numpy as np

    gaps = []
    for events in events_by_replica:
        stamps = [e[1] for e in events if e[0] == "decode"]
        gaps += [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    if not gaps:
        return {"median": None, "max": None, "n": 0}
    return {"median": float(np.median(gaps)), "max": max(gaps), "n": len(gaps)}


def phase_tiny_serve_paths_card_vs_cpu(torch):
    """The tiny config in float32: a FrontDoor over two replicas and a
    Coordinator with two worker threads on the card give the port's single
    Scheduler's tokens on the CPU (chunked admission, staggered budgets)."""
    import numpy as np

    from fastkv_tpu_torch.core.config import EngineConfig, Method, MethodConfig, ModelConfig
    from fastkv_tpu_torch.engine.dispatch import Coordinator, serve_worker
    from fastkv_tpu_torch.engine.scheduler import Scheduler
    from fastkv_tpu_torch.engine.serve import local_front_door

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig.tiny(head_dim=64)
    p_cpu, p_gpu = tiny_params(torch, cfg, False)
    mcfg = MethodConfig(method=Method.FASTKV, eviction_mode="proportional", retain_rate=0.3,
                        tsp_rate=0.5, tsp_idx=1, pooling="maxpool")
    ecfg = EngineConfig(prefill_buckets=(256,), capacity_align=8, prefill_chunk=64)
    kw = dict(max_batch=2, bucket=256, max_new_tokens=24)
    rng = np.random.default_rng(SEED)
    reqs = [(rng.integers(0, cfg.vocab_size, n).tolist(), b)
            for n, b in ((230, 24), (201, 6), (140, 12), (180, 10), (90, 16), (250, 8))]
    single = Scheduler(p_cpu, cfg, mcfg, ecfg, device="cpu", **kw)
    ids = [single.submit(p, b) for p, b in reqs]
    done = {r.req_id: r.tokens for r in single.run()}
    want = [done[i] for i in ids]

    zero_launches()
    fd = local_front_door(p_gpu, cfg, mcfg, ecfg, n_replicas=2, **kw)
    for p, b in reqs:
        fd.submit(p, b)
    front = fd.run()
    fd_launches = count_launches()
    fd_ok = all(r.alive for r in fd.replicas) and {r["replica"] for r in front} == {0, 1}

    zero_launches()
    coord = Coordinator()
    served, errors = {}, []

    def work(name):
        try:
            served[name] = serve_worker(coord.address, Scheduler(p_gpu, cfg, mcfg, ecfg, **kw),
                                        name=name, batch=1)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(repr(e))

    try:
        for p, b in reqs:
            coord.submit(p, b)
        coord.seal()
        threads = [threading.Thread(target=work, args=(f"w{i}",), daemon=True)
                   for i in range(2)]
        for t in threads:
            t.start()
        res = coord.wait_results(timeout=300)
        for t in threads:
            t.join(300)
    finally:
        coord.close()
    dispatch_launches = count_launches()
    alive = [t.name for t in threads if t.is_alive()]
    rec = {"phase": "tiny_serve_paths_card_vs_cpu",
           "config": "tiny(head_dim=64) float32 fastkv maxpool prefill_chunk=64",
           "front_door_tokens_equal": [r["tokens"] for r in front] == want,
           "front_door_replicas": [r["replica"] for r in front],
           "dispatch_tokens_equal": [r["tokens"] for r in res] == want,
           "dispatch_workers": sorted({r["worker"] for r in res}), "served": served,
           "worker_errors": errors, "threads_alive": alive,
           "front_door_launches": fd_launches, "dispatch_launches": dispatch_launches,
           "decode_counters_zero": counters_at_rest()}
    emit(rec)
    check(rec["front_door_tokens_equal"] and rec["dispatch_tokens_equal"] and fd_ok,
          "tiny serving paths: the card's FrontDoor or dispatch disagrees with the CPU")
    check(not errors and not alive and rec["decode_counters_zero"],
          f"tiny dispatch: workers {served}, errors {errors}, alive {alive}")
    check(all(n["flash_prefill"] > 0 and n["decode_attn"] > 0
              for n in (fd_launches, dispatch_launches)),
          "tiny serving paths: a kernel did not launch on the card")
    check_prologue(fd_launches, "tiny FrontDoor")
    check_prologue(dispatch_launches, "tiny dispatch")


def phase_serve_paths(torch, gpu: str, cfg=None, device="cuda"):
    """Llama-3.1-8B (random bf16 weights from the seed, one params dict):
    ``serve_front_door`` (local_front_door over two replicas: healthy, replica
    0 raising at drain start, replica 0 wedged) and ``serve_dispatch`` (a
    Coordinator on the loopback, two serve_worker threads; then a streaming
    run). Returns the launches per counted run."""
    import numpy as np

    from fastkv_tpu_torch.core.config import EngineConfig, Method, ModelConfig
    from fastkv_tpu_torch.engine.scheduler import Scheduler
    from fastkv_tpu_torch.engine.serve import local_front_door
    from fastkv_tpu_torch.models.llama import init_params

    cfg = cfg or ModelConfig.llama_3_1_8b()
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = init_params(cfg, gen, device=device)
    mcfg = canonical(Method.FASTKV, tsp_idx=min(15, cfg.num_layers - 1))
    ecfg = EngineConfig(prefill_chunk=SERVE_CHUNK)
    kw = dict(max_batch=4, bucket=SERVE_BUCKET, max_new_tokens=32, device=device)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n, _ in SERVE_REQUESTS]
    budgets = [b for _, b in SERVE_REQUESTS]
    launches = {}

    def counted(tag, fn):
        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[tag] = count_launches()
        return out, wall

    # one Scheduler(max_batch=4) over the six requests: the tokens and the
    # wall the front door is compared with (the kernels are warm from serve_*)
    single = Scheduler(params, cfg, mcfg, ecfg, **kw)
    ids = [single.submit(p, b) for p, b in zip(prompts, budgets)]
    done, single_wall = counted("serve_single_b4", single.run)
    by_id = {r.req_id: r.tokens for r in done}
    single_tokens = [by_id[i] for i in ids]
    del single, done

    def front_door(**fkw):
        fd = local_front_door(params, cfg, mcfg, ecfg, n_replicas=2, **fkw, **kw)
        events = [kept_events(r.scheduler, "run") for r in fd.replicas]
        for p, b in zip(prompts, budgets):
            fd.submit(p, b)
        return fd, events

    def record(tag, fd, events, out, wall, extra):
        kinds, called = launches_called(events, cfg, mcfg)
        got = {key: launches[tag][key] for key in called}
        finished = (all(r["tokens"] is not None and len(r["tokens"]) == b
                        for r, b in zip(out, budgets)))
        same = sum(a == b for r, want in zip(out, single_tokens)
                   for a, b in zip(r["tokens"] or [], want))
        rec = {"phase": "serve_front_door", "run": tag, "model": cfg.name,
               "method": mcfg.method.value, "replicas": 2, "max_batch": 4,
               "bucket": SERVE_BUCKET, "prefill_chunk": SERVE_CHUNK,
               "requests": [list(r) for r in SERVE_REQUESTS],
               "replica_of_request": [r["replica"] for r in out],
               "readmissions": [r["readmissions"] for r in out],
               "alive": [r.alive for r in fd.replicas],
               "errors": [repr(r.error) if r.error else None for r in fd.replicas],
               "events": kinds, "launches": launches[tag], "launches_called": called,
               "ttft_s": [r.get("ttft_s") for r in out], "tpot_s": [r.get("tpot_s") for r in out],
               "inter_token_gap_ms": gaps_ms(events), "wall_s": wall,
               "single_scheduler_b4_wall_s": single_wall,
               "tokens_agreeing_with_single_scheduler_b4": same / sum(budgets),
               "all_finished_with_their_budget": finished,
               "decode_counters_zero": counters_at_rest(), "gpu": gpu, **extra}
        emit(rec)
        check(finished, f"serve_front_door {tag}: a request did not finish with its budget")
        check(got == called, f"serve_front_door {tag}: launches {got}, the path calls {called}")
        check(rec["decode_counters_zero"], f"serve_front_door {tag}: a decode arrival counter "
              "is off zero")
        return rec

    # 1. healthy: both replicas serve
    fd, events = front_door()
    out, wall = counted("serve_front_door_healthy", fd.run)
    rec = record("serve_front_door_healthy", fd, events, out, wall, {})
    check(all(rec["alive"]) and set(rec["replica_of_request"]) == {0, 1},
          f"serve_front_door healthy: replicas {rec['replica_of_request']}, alive "
          f"{rec['alive']}, errors {rec['errors']}")
    del fd, events, out
    # the device's idle share over the same run, profiled apart
    fd, events = front_door()
    held = {}
    wall_ms, kern = profile_window(torch, lambda: held.update(out=fd.run()))
    emit({"phase": "serve_front_door", "run": "healthy_profiled", "gpu": gpu,
          **breakdown(wall_ms, kern),
          "all_finished": all(len(r["tokens"] or []) == b
                              for r, b in zip(held["out"], budgets))})
    del fd, events, held

    # 2. replica 0 raises at its drain's start: everything completes on 1
    injected = RuntimeError("injected fault: replica 0 lost at drain start")

    def fault(idx):
        if idx == 0:
            raise injected

    fd, events = front_door()
    out, wall = counted("serve_front_door_fault", lambda: fd.run(fault=fault))
    rec = record("serve_front_door_fault", fd, events, out, wall, {})
    check(fd.replicas[0].error is injected and fd.replicas[1].alive
          and fd.replicas[1].error is None
          and all(r["replica"] == 1 for r in out)
          and all(r["readmissions"] > 0 for r in out if r["ticket_id"] % 2 == 0),
          f"serve_front_door fault: replicas {rec['replica_of_request']}, readmissions "
          f"{rec['readmissions']}, errors {rec['errors']}")
    del fd, events, out

    # 3. replica 0 wedged (its drain sleeps until released); the survivor
    # warmed first; the drain timeout marks 0 dead
    release = threading.Event()
    sleepers = []

    def wedged_run():
        sleepers.append(threading.current_thread())
        release.wait(120)
        return []

    fd = local_front_door(params, cfg, mcfg, ecfg, n_replicas=2,
                          drain_timeout_s=WEDGE_TIMEOUT_S, **kw)
    survivor = fd.replicas[1].scheduler
    survivor.submit(prompts[3], 2)
    survivor.run()  # warm, before any ticket is assigned
    fd.replicas[0].scheduler.run = wedged_run
    events = [[], kept_events(survivor, "run")]
    for p, b in zip(prompts, budgets):
        fd.submit(p, b)
    try:
        out, wall = counted("serve_front_door_wedged", fd.run)
    finally:
        release.set()
    for th in sleepers:
        th.join(60)
    rec = record("serve_front_door_wedged", fd, events, out, wall,
                 {"drain_timeout_s": WEDGE_TIMEOUT_S})
    check(isinstance(fd.replicas[0].error, TimeoutError) and fd.replicas[1].alive
          and fd.replicas[1].error is None and all(r["replica"] == 1 for r in out)
          and not any(th.is_alive() for th in sleepers),
          f"serve_front_door wedged: errors {rec['errors']}, replicas "
          f"{rec['replica_of_request']}")
    del fd, events, out, survivor

    launches.update(phase_serve_dispatch(torch, gpu, params, cfg, mcfg, ecfg, kw, prompts,
                                         budgets, single_tokens))
    return launches


WEDGE_TIMEOUT_S = 10.0  # a healthy replica drains the six requests in ~3 s


def phase_serve_dispatch(torch, gpu, params, cfg, mcfg, ecfg, kw, prompts, budgets,
                         single_tokens):
    """A Coordinator on the loopback and two serve_worker threads, each over
    its own Scheduler (one params dict), pull the six requests; then one
    worker streams: a request of budget 200, and a second submitted once the
    first has taken three decode steps."""
    from fastkv_tpu_torch.engine.dispatch import Coordinator, serve_worker
    from fastkv_tpu_torch.engine.scheduler import Scheduler

    launches = {}

    def workers_run(tag, scheds, submit):
        """Start a worker thread per scheduler, feed the coordinator, wait
        for every result; the launches are counted over the whole run."""
        coord = Coordinator()
        events = [kept_events(s, "_run_loop") for s in scheds]
        served, errors = {}, []

        def work(i, s):
            try:
                served[f"w{i}"] = serve_worker(coord.address, s, name=f"w{i}", batch=2)
            except Exception as e:  # noqa: BLE001 - fails the phase below
                errors.append(repr(e))

        torch.cuda.synchronize()
        zero_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=work, args=(i, s), daemon=True)
                   for i, s in enumerate(scheds)]
        try:
            for t in threads:
                t.start()
            submit(coord)
            res = coord.wait_results(timeout=600)
            for t in threads:
                t.join(120)
        finally:
            coord.close()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[tag] = count_launches()
        kinds, called = launches_called(events, cfg, mcfg)
        got = {key: launches[tag][key] for key in called}
        alive = [t.name for t in threads if t.is_alive()]
        rec = {"phase": "serve_dispatch", "run": tag, "model": cfg.name,
               "method": mcfg.method.value, "workers": len(scheds), "served": served,
               "worker_of_ticket": [r["worker"] for r in res],
               "readmissions": [r["readmissions"] for r in res],
               "lease_expiries": sum(r["lease_expiries"] for r in res),
               "events": kinds, "launches": launches[tag], "launches_called": called,
               "ttft_s": [r["ttft_s"] for r in res], "tpot_s": [r["tpot_s"] for r in res],
               "inter_token_gap_ms": gaps_ms(events), "wall_s": wall,
               "decode_counters_zero": counters_at_rest(), "worker_errors": errors,
               "threads_alive": alive, "gpu": gpu}
        return res, rec, got

    def checked(rec, got):
        """Emit the run's record, then hold it to the hard checks."""
        emit(rec)
        tag = rec["run"]
        check(not rec["worker_errors"] and not rec["threads_alive"],
              f"{tag}: errors {rec['worker_errors']}, alive {rec['threads_alive']}")
        check(got == rec["launches_called"],
              f"{tag}: launches {got}, the path calls {rec['launches_called']}")
        check(rec["decode_counters_zero"], f"{tag}: a decode arrival counter is off zero")

    def six(coord):
        for p, b in zip(prompts, budgets):
            coord.submit(p, b)
        coord.seal()

    res, rec, got = workers_run("serve_dispatch", [Scheduler(params, cfg, mcfg, ecfg, **kw)
                                                   for _ in range(2)], six)
    rec["all_finished_with_their_budget"] = all(len(r["tokens"]) == b
                                                for r, b in zip(res, budgets))
    rec["tokens_agreeing_with_single_scheduler_b4"] = sum(
        a == b for r, want in zip(res, single_tokens)
        for a, b in zip(r["tokens"], want)) / sum(budgets)
    checked(rec, got)
    check(rec["all_finished_with_their_budget"] and len(rec["served"]) == 2
          and all(n > 0 for n in rec["served"].values()),
          f"serve_dispatch: served {rec['served']}, workers {rec['worker_of_ticket']}")

    # streaming: the second ticket arrives while the first decodes
    stream_kw = dict(kw, max_new_tokens=STREAM_BUDGETS[0])
    sched = Scheduler(params, cfg, mcfg, ecfg, **stream_kw)
    order = []
    install, step = sched._install, sched._decode_one_step
    sched._install = lambda *a, **k: (order.append("A"), install(*a, **k))[1]
    sched._decode_one_step = lambda: (order.append("D"), step())[1]

    def streaming(coord):
        coord.submit(prompts[0], STREAM_BUDGETS[0])
        deadline = time.monotonic() + 300
        while order.count("D") < 3 and time.monotonic() < deadline:
            time.sleep(0.002)
        coord.submit(prompts[1], STREAM_BUDGETS[1])
        coord.seal()

    res, rec, got = workers_run("serve_dispatch_streaming", [sched], streaming)
    trace = "".join(order)
    rec.update(budgets=list(STREAM_BUDGETS), trace_head=trace[:96],
               admissions=trace.count("A"),
               dad=("D" in trace and "DAD" in trace[trace.index("D"):]),
               new_tokens=[len(r["tokens"]) for r in res])
    checked(rec, got)
    check(rec["dad"] and rec["admissions"] == 2
          and rec["new_tokens"] == list(STREAM_BUDGETS),
          f"serve_dispatch streaming: trace {trace[:64]}..., tokens {rec['new_tokens']}")
    return launches


STREAM_BUDGETS = (200, 8)


LONG_PROMPT = 131072


def long_prompt_fastkv_capacity() -> int:
    """FastKV's cache slots a head after the 131072-token prompt at the
    canonical point with 32 new tokens: the prefill capacity (the kept budget
    and the window, aligned) and 128 decode slots."""
    from fastkv_tpu_torch.core.config import EngineConfig, Method, ModelConfig
    from fastkv_tpu_torch.engine import prefill as pm

    return pm.plan_shapes(ModelConfig.llama_3_1_8b(), canonical(Method.FASTKV),
                          EngineConfig(max_new_tokens=32), LONG_PROMPT).total_capacity


def layer_step_peaks(torch, params, cfg, tok, cnt):
    """Which step of a layer sets the prefill's peak memory: layer 0's steps
    at the prompt's full length, each run alone, with the bytes it allocates
    at its peak above what was allocated before it (its inputs and the
    weights); the MLP chunked by 32768 and whole."""
    from fastkv_tpu_torch.models import llama
    from fastkv_tpu_torch.models.rope import compute_inv_freq
    from fastkv_tpu_torch.ops import flash_prefill as fpm

    lp = llama.layer_params(params, 0)
    inv_freq = torch.from_numpy(compute_inv_freq(cfg)).to(tok.device)
    pos = torch.arange(tok.shape[1], dtype=torch.int32, device=tok.device)[None]
    peaks = {}

    def step(name, fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() - base
        return out

    with torch.inference_mode():
        h = step("embed", lambda: llama.embed(params, cfg, tok))
        hn = step("rms_norm", lambda: llama.rms_norm(h, lp["ln_attn"], cfg.rms_norm_eps))
        q, k, v = step("qkv_proj", lambda: llama.qkv_proj(lp, cfg, hn))
        q, k = step("rope_qk", lambda: llama.rope_qk(q, k, pos, inv_freq))
        attn = step("flash_attention", lambda: fpm.flash_attention(q, k, v, pos, cnt))
        h = step("attn_out_proj_residual", lambda: h + llama.attn_out_proj(lp, attn))
        del q, k, v, attn, hn
        hn = llama.rms_norm(h, lp["ln_mlp"], cfg.rms_norm_eps)
        for chunk in (32768, 0):
            step(f"mlp_chunk_{chunk}", lambda: llama.mlp(lp, hn, chunk=chunk))
    del h, hn
    return peaks


def phase_long_prompt(torch, gpu: str, cfg=None, device="cuda", n=LONG_PROMPT):
    """Llama-3.1-8B, one 131072-token prompt, 32 new tokens, tsp_idx 15:
    FastKV with the MLP chunked by default (auto: 32768 at this length) and
    unchunked (mlp_chunk=0), and FullKV with the default; peak memory, prefill
    seconds and decode ms per token of each generate; logits of a FastKV
    prefill each way. Returns (launches per run, the FastKV cache's kept
    slots a head)."""
    import numpy as np

    from fastkv_tpu_torch.core.config import EngineConfig, Method, ModelConfig
    from fastkv_tpu_torch.engine import prefill as pm
    from fastkv_tpu_torch.engine.generate import Engine
    from fastkv_tpu_torch.models.llama import init_params

    cfg = cfg or ModelConfig.llama_3_1_8b()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device=device)
    prompt = np.random.default_rng(SEED + 7).integers(0, cfg.vocab_size, n).tolist()
    tok = torch.tensor([prompt], dtype=torch.int32, device=device)
    cnt = torch.tensor([n], dtype=torch.int32, device=device)
    tsp_idx = min(15, cfg.num_layers - 1)
    launches, logits, tokens, recs = {}, {}, {}, {}

    def prefill(mcfg, ecfg):
        shapes = pm.plan_shapes(cfg, mcfg, ecfg, n)
        with torch.inference_mode():
            out = pm.prefill(params, cfg, mcfg, shapes, tok, cnt, ecfg)
        torch.cuda.synchronize()
        return out

    fast = canonical(Method.FASTKV, tsp_idx=tsp_idx)
    auto = EngineConfig(max_new_tokens=32)
    # warm-up (kernels, cuBLAS at this length), and the unchunked logits
    logits["0"], cache = prefill(fast, EngineConfig(max_new_tokens=32, mlp_chunk=0))
    kept = int(cache.valid[0, 0, 0].sum())
    capacity = cache.k.shape[3]
    del cache
    for tag, mcfg, ecfg in (("fastkv_mlp_chunk_auto", fast, auto),
                            ("fastkv_mlp_chunk_0", fast, EngineConfig(max_new_tokens=32,
                                                                       mlp_chunk=0)),
                            ("fullkv", canonical(Method.FULLKV, tsp_idx=tsp_idx), auto)):
        eng = Engine(params, cfg, mcfg, ecfg, device=device)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        out = eng.generate([prompt], 32)
        torch.cuda.synchronize()
        counted = count_launches()
        launches[f"long_prompt_{tag}"] = counted
        tokens[tag] = out[0]
        t = eng.last_timing
        recs[tag] = rec = {
            "phase": "long_prompt_mlp_chunk", "run": tag, "model": cfg.name, "prompt": n,
            "new_tokens": len(out[0]), "method": mcfg.method.value, "tsp_idx": tsp_idx,
            "mlp_chunk": ecfg.mlp_chunk, "mlp_chunk_at_prompt": ecfg.mlp_chunk_for(n),
            "prefill_s": t["prefill_s"], "decode_ms_per_token": 1e3 * t["decode_s"] / 31,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "launches": counted, "gpu": gpu}
        want_flash = cfg.num_layers
        check(len(out[0]) == 32 and counted["flash_prefill"] == want_flash
              and counted["decode_attn"] == counted["decode_prologue"] == cfg.num_layers * 31
              and counted["flash_prefill_rect"] == 0,
              f"long_prompt {tag}: {len(out[0])} tokens, launches {counted}")
        del eng
    # where a chunked FastKV prefill's time goes, and its logits
    held = {}
    wall_ms, kern = profile_window(torch, lambda: held.update(out=prefill(fast, auto)))
    logits["auto"] = held.pop("out")[0]
    a, b = recs["fastkv_mlp_chunk_auto"], recs["fastkv_mlp_chunk_0"]
    a["prefill_profile"] = dict(breakdown(wall_ms, kern),
                                flash_ms=kernels_ms(kern, FLASH_BF16) if kern else None,
                                gemm_ms=kernels_ms(kern, *GEMM_NAMES) if kern else None)
    a["layer0_step_peak_bytes_above_inputs"] = layer_step_peaks(torch, params, cfg, tok, cnt)
    a["peak_drop_bytes_vs_mlp_chunk_0"] = (b["max_memory_allocated_bytes"]
                                          - a["max_memory_allocated_bytes"])
    a["tokens_equal_to_mlp_chunk_0"] = tokens["fastkv_mlp_chunk_auto"] == tokens[
        "fastkv_mlp_chunk_0"]
    a["token_share_equal_to_mlp_chunk_0"] = sum(
        x == y for x, y in zip(tokens["fastkv_mlp_chunk_auto"],
                               tokens["fastkv_mlp_chunk_0"])) / 32
    a["prefill_logit_max_abs_diff_vs_mlp_chunk_0"] = (
        logits["auto"] - logits["0"]).abs().max().item()
    a["fastkv_cache_capacity"], a["fastkv_kept_slots_layer0_head0"] = capacity, kept
    for rec in recs.values():
        emit(rec)
    check(a["max_memory_allocated_bytes"] < b["max_memory_allocated_bytes"],
          f"long_prompt: the peak with the MLP chunked ({a['max_memory_allocated_bytes']}) is "
          f"not below the peak without ({b['max_memory_allocated_bytes']})")
    return launches, kept


# ---------------------------------------------------------------------------
# timings at the main-path shapes
# ---------------------------------------------------------------------------

# the headline benchmark (fastkv_tpu_torch.bench.headline): its top rung at
# Llama-3.2-1B width, 128 new tokens; FastKV's TSP count at that rung
# (budgets.dynamic_tsp_budget: 0.2 of the prompt) and its kept slots a head
# in a layer's cache (0.1 of the prompt and the window of 8)
HEADLINE_CTX, HEADLINE_GEN = 229376, 128
HEADLINE_TSP_COUNT, HEADLINE_FAST_KEPT = 45867, 22945
# the two runs of the module: its defaults (int8 weights, the ladder from
# 229376, the fusion A/B at 98304), and bf16 weights at 131072 without the A/B
HEADLINE_RUNS = (("headline_int8w", {}, HEADLINE_CTX),
                 ("headline_bf16", {"FASTKV_BENCH_QUANT": "none", "FASTKV_BENCH_CTX": "131072",
                                    "FASTKV_BENCH_FUSION_AB": "0"}, 131072))
HEADLINE_RUNG_TIMEOUT_S, HEADLINE_TIMEOUT_S = 420, 480


def headline_shapes() -> dict:
    """The headline's FullKV and FastKV plans at its top rung."""
    from fastkv_tpu_torch.bench.headline import canonical_mcfg
    from fastkv_tpu_torch.core.config import EngineConfig, ModelConfig
    from fastkv_tpu_torch.engine import prefill as pm

    cfg = ModelConfig.llama_3_2_1b()
    ecfg = EngineConfig(prefill_buckets=(HEADLINE_CTX,), max_new_tokens=HEADLINE_GEN)
    return {m: pm.plan_shapes(cfg, canonical_mcfg(cfg, m), ecfg, HEADLINE_CTX)
            for m in ("fullkv", "fastkv")}


def headline_called(run: dict, L: int, genlen: int, fused: bool, kv_int8: bool) -> dict:
    """The launches one method's runs in the headline call for: flash once a
    layer a prefill (in its fused-scores form, with the finishing pass,
    in every layer of a fused prefill), decode once a layer a step, genlen -
    1 steps a decode run (in its int8 form over an int8 cache), the
    decode prologue with it but over an int8 cache, and the norm kernel
    twice a layer a step."""
    flash, decode = L * run["prefills"], L * (genlen - 1) * run["decodes"]
    want = dict.fromkeys(LAUNCH_KEYS, 0)
    want.update(flash_prefill=flash, decode_attn=decode, add_rms_norm=2 * decode)
    if fused:
        want.update(flash_prefill_scores=flash, window_scores_finish=flash)
    if kv_int8:
        want["decode_attn_int8"] = decode
    else:
        want["decode_prologue"] = decode
    return want


def run_headline(root: str, env_over: dict):
    """``python -m fastkv_tpu_torch.bench.headline`` from the checkout at
    root, in a session of its own (so a child it leaves behind dies with
    it on a timeout), every other FASTKV_BENCH_* knob unset. Returns
    (exit code, stdout, stderr, seconds)."""
    import signal

    env = {k: v for k, v in os.environ.items() if not k.startswith("FASTKV_BENCH_")}
    env.update(env_over, FASTKV_BENCH_RUNG_TIMEOUT=str(HEADLINE_RUNG_TIMEOUT_S))
    env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "fastkv_tpu_torch.bench.headline"], cwd=root,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=HEADLINE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return proc.returncode, out, err, time.perf_counter() - t0


def phase_headline(torch, gpu: str):
    """The headline benchmark as a user runs it, twice (HEADLINE_RUNS), each
    a subprocess whose rungs are subprocesses of their own: the line must
    come from the run's top rung with a positive value; every method's
    launches (read by the rung from its counters, which start at 0 in its
    fresh process) must equal what its prefills and decodes call for, the
    rung's totals their sum; every decode arrival counter back at zero.
    Returns the launches per run and method (``<run>_fullkv``, ``_fastkv``,
    the A/B's ``_ab_fused`` and ``_ab_unfused``)."""
    from fastkv_tpu_torch.bench.headline import RECORD_KEY

    root = os.path.dirname(os.path.abspath(__file__))
    tag_line = "{" + json.dumps(RECORD_KEY) + ":"
    by_path = {}
    for tag, env_over, want_ctx in HEADLINE_RUNS:
        rc, out, err, seconds = run_headline(root, env_over)
        details = [json.loads(ln)[RECORD_KEY] for ln in err.splitlines()
                   if ln.startswith(tag_line)]
        print("\n".join(ln for ln in err.splitlines() if not ln.startswith(tag_line)),
              file=sys.stderr, flush=True)
        check(rc == 0, f"{tag}: the headline exited {rc}")
        lines = out.strip().splitlines()
        check(len(lines) == 1, f"{tag}: the headline printed {len(lines)} lines, not one")
        line = json.loads(lines[0])
        check(set(line) == {"metric", "value", "unit", "vs_baseline"},
              f"{tag}: the line's keys are {sorted(line)}")
        check(len(details) == 1 and details[0]["ctx"] == want_ctx
              and details[0]["metric"] == line["metric"] and f"_ctx{want_ctx}_" in line["metric"],
              f"{tag}: the line {line['metric']} did not come from the rung at {want_ctx} "
              f"(rungs completed: {[d['ctx'] for d in details]})")
        check(line["value"] > 0, f"{tag}: value {line['value']}")
        d = details[0]
        L, genlen = d["num_layers"], d["genlen"]
        runs = [("fullkv", d["fullkv"], False), ("fastkv", d["fastkv"], False)]
        if d["fusion_ab"]:
            runs += [("ab_fused", d["fusion_ab"]["fused"], True),
                     ("ab_unfused", d["fusion_ab"]["unfused"], False)]
        total = dict.fromkeys(LAUNCH_KEYS, 0)
        for name, run, fused in runs:
            want = headline_called(run, L, genlen, fused, d["kv_int8"])
            check(run["launches"] == want,
                  f"{tag} {name}: launches {run['launches']}, the path calls for {want}")
            total = {k: total[k] + want[k] for k in LAUNCH_KEYS}
            by_path[f"{tag}_{name}"] = run["launches"]
        check(d["launches"] == total,
              f"{tag}: the rung launched {d['launches']}, its runs account for {total}")
        check(d["decode_counters_zero"] is True, f"{tag}: a decode arrival counter is off zero")
        emit({"phase": tag, "gpu": gpu, "line": line, "seconds": seconds, "rung": d})
    return by_path


def profile_headline(torch, gpu: str) -> None:
    """A decode step at the headline's top rung in this process
    (Llama-3.2-1B, int8 weights from the module's seed): eight greedy decode
    steps (``greedy_generate`` of 9 tokens) over a FullKV and a FastKV cache
    of the rung's shapes under the profiler: host ms, device-busy ms, idle
    share and the top kernels a step. The caches hold zeros with the slots a
    prefill keeps marked valid (229376 / 22945 a head), not a prefill's
    values: a step's work is set by the shapes and the valid slots. A window
    in which the profiler recorded nothing is taken again, up to three
    times."""
    from fastkv_tpu_torch.bench.headline import MethodRun
    from fastkv_tpu_torch.cache.kv_cache import empty_cache
    from fastkv_tpu_torch.core.config import ModelConfig
    from fastkv_tpu_torch.engine import decode as dm
    from fastkv_tpu_torch.models.llama import init_params_int8

    cfg = ModelConfig.llama_3_2_1b()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = init_params_int8(cfg, gen)
    for m, kept in (("fullkv", HEADLINE_CTX), ("fastkv", HEADLINE_FAST_KEPT)):
        run = MethodRun(m, cfg, params, HEADLINE_CTX, HEADLINE_GEN, {})
        cache = empty_cache(cfg.num_layers, 1, cfg.num_kv_heads, run.shapes.total_capacity,
                            cfg.head_dim, torch.bfloat16, "cuda")
        cache.valid[..., :kept] = True
        cache.pos[..., :kept] = torch.arange(kept, dtype=torch.int32, device="cuda")
        logits = torch.randn((1, cfg.vocab_size), generator=gen, device="cuda")

        def steps():
            res, _ = dm.greedy_generate(params, cfg, run.mcfg, run.shapes, logits, cache,
                                        run.n_true, 9)
            return res.tokens

        with torch.inference_mode():
            steps()  # warm
            for _ in range(3):
                wall, kern = profile_window(torch, steps)
                if kern:
                    break
        emit({"phase": f"profile_headline_{m}", "gpu": gpu, "model": cfg.name,
              "ctx": HEADLINE_CTX, "weights": "int8 weight-only",
              "cache_slots": run.shapes.total_capacity, "valid_a_head": kept,
              "decode_step": breakdown(wall, kern, calls=8),
              "decode_attn_ms_per_step": kernels_ms(kern, DECODE_TC) / 8})
        del logits, cache, run
    del params
    free_cuda(torch)


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


def fair_sdpa(torch, q, k, v, reps, lower_right=False) -> dict:
    """The fair library call for a causal flash form with every key valid:
    sdpa with no explicit mask (``timing.sdpa_causal``), K/V by enable_gqa
    and repeated beforehand, each timed by CUDA events; the faster one is
    ``library_ms``. Its backend: for is_causal the dispatcher's pick
    (``timing.sdpa_choice``); for the lower-right bias (dispatched in
    Python) the kernels one profiler window recorded. That window's kernel
    time is ``library_device_ms`` only where it holds at least half the
    event time: the profiler may record none of a long call's kernels
    (then None, 'not recorded')."""
    by_kv = {}
    for kv, gqa in (("enable_gqa", True), ("repeated", False)):
        try:
            call = sdpa_causal(q, k, v, gqa, lower_right)
            by_kv[kv] = events_ms(call, reps=reps, warmup=1)
        except (RuntimeError, TypeError, NotImplementedError) as e:
            by_kv[kv] = f"not run: {type(e).__name__}: {str(e)[:200]}"
        call = None
    timed = {kv: ms for kv, ms in by_kv.items() if isinstance(ms, float)}
    check(bool(timed), f"sdpa ran in neither form: {by_kv}")
    best = min(timed, key=timed.get)
    call = sdpa_causal(q, k, v, best == "enable_gqa", lower_right)
    per_kernel = {}
    for _ in range(3):
        _, per_kernel = profile_window(torch, call)
        if per_kernel:
            break
    recorded = sum(per_kernel.values())
    whole = recorded >= 0.5 * timed[best]
    backend = (sdpa_backend(per_kernel) if whole else "not recorded") if lower_right else (
        sdpa_choice(q, k, v, best == "enable_gqa"))
    return dict(library_ms=timed[best], library_kv=best, library_ms_by_kv=by_kv,
                library_device_ms=recorded if whole else None,
                library_device_ms_from="profiler" if whole else None,
                library_backend=backend,
                library_note=("sdpa with the lower-right causal bias" if lower_right else
                              "sdpa with is_causal=True") + ", no explicit mask; K/V by "
                             f"{'enable_gqa' if best == 'enable_gqa' else 'repeat_interleave'}"
                             " (the faster of the two)")


def masked(lib_ms, lib_dev, lib_from) -> dict:
    """The explicit-mask sdpa figures (``timing.layer_sdpa``), kept beside the
    fair call: an explicit mask keeps sdpa off its fused backends."""
    return dict(library_masked_ms=lib_ms, library_masked_device_ms=lib_dev,
                library_masked_device_ms_from=lib_from)


def phase_timings(torch, cases, flash_lib, decode_lib, launches, launches_by_path,
                  long_kept):
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
    flops, nbytes = flash_work(q, k, v, pos, cnt)
    flash_bound, flash_by = bound(flops, nbytes)
    flash = dict(
        name="flash_prefill", route="cuda",
        source="fastkv_tpu_torch/kernels/csrc/flash_prefill.cu",
        replaces="fastkv_tpu/ops/flash_prefill.py:472",
        launches=launches["flash_prefill"], max_abs_err=err["flash_prefill"],
        launches_by_path={p: n["flash_prefill"] for p, n in launches_by_path.items()},
        ms=ms, plain_ms=plain_ms, bound_ms=flash_bound, bound_by=flash_by,
        device_ms=kern_dev, device_ms_from=kern_from,
        **fair_sdpa(torch, q, k, v, reps=5), **masked(lib_ms, lib_dev, lib_from),
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

    # flash prefill, causal square at a long prompt, all keys valid: the
    # 131072-token prompt at Llama-3.1-8B (every FullKV layer, and FastKV's
    # layers through TSP), and the headline's top rung at Llama-3.2-1B
    # (229376 tokens, head_dim 64: 16 FullKV layers, FastKV's 8 through TSP,
    # a prefill). The plain version's time is the agreement case's (one GQA
    # group at 131072, 1/8 of the work; one query head at 229376, 1/32; a
    # call of seconds, not repeated here); the library call is the fair one alone
    # (an explicit boolean mask would be 17 GB / 53 GB)
    for key, s, d, case, prefix, share in (
            ("square_s131072", LONG_PROMPT, 128, "8b_s131072_one_gqa_group", "long_prompt_",
             "one GQA group (1 kv head, 4 query heads): 1/8"),
            (f"square_1b_s{HEADLINE_CTX}", HEADLINE_CTX, 64,
             f"1b_s{HEADLINE_CTX}_one_gqa_group", ("headline_int8w_fullkv",
                                                    "headline_int8w_fastkv"),
             "one query head and its kv head: 1/32")):
        q, k, v, pos, cnt = flash_inputs(torch, 1, 32, 8, s, d, s, bf16, gen)
        q_pos = pos.contiguous()
        k_pos = fp.fold_key_validity(pos, cnt).contiguous()
        kern = lambda: fp.launch(flash_lib, q, k, v, q_pos, k_pos, stream())  # noqa: E731
        ms = events_ms(kern, reps=2, warmup=1)
        kern_dev, kern_from = device_ms(torch, kern, 1, FLASH_BF16)
        [agree] = [c for c in cases if c["case"] == case]
        flops, nbytes = flash_work(q, k, v, pos, cnt)
        long_bound, long_by = bound(flops, nbytes)
        # FastKV runs its layers through TSP (half of them) at the whole prompt
        paths = {p: n["flash_prefill"] for p, n in launches_by_path.items()
                 if p.startswith(prefix)}
        flash[key] = dict(
            launches=sum(n // 2 if "fastkv" in p else n for p, n in paths.items()),
            launches_by_path=paths,
            max_abs_err=agree["max_abs_err"],
            ms=ms, device_ms=kern_dev, device_ms_from=kern_from, plain_ms=agree["plain_ms"],
            plain_note=f"the plain version over {share} of the work; one call in the "
                       "agreement case, by CUDA events",
            bound_ms=long_bound, bound_by=long_by, **fair_sdpa(torch, q, k, v, reps=2),
            shape=f"b=1 H=32 KH=8 s={s} d={d} bf16, causal",
            flop=flops, bytes=nbytes, **rates(flops, ms, long_bound))
        del q, k, v

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
    flops, nbytes = flash_work(q, k, v, pos, cnt, W)
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
    flops, nbytes = flash_work(q, k, v, qpos, cnt, kpos=k_fold)
    rect_bound, rect_by = bound(flops, nbytes)
    # the chunk's queries are the last c of the S keys: the lower-right bias
    flash["rect"] = dict(
        launches=launches["flash_prefill_rect"],
        ms=ms, device_ms=kern_dev, plain_ms=plain_ms, bound_ms=rect_bound, bound_by=rect_by,
        device_ms_from=kern_from, **fair_sdpa(torch, q, k, v, reps=10, lower_right=True),
        **masked(lib_ms, lib_dev, lib_from),
        shape=f"b=1 H=32 KH=8 c={c} start={start} Sk={S} d=128 bf16, k_count = k_hi = {S}",
        flop=flops, bytes=nbytes, **rates(flops, ms, rect_bound))
    del q, k, v, mask, lib

    # flash prefill, the 'full' pattern with the (m, l) row statistics: ring
    # attention's earlier chunk at Llama-3.1-8B, seq 2 (rank 1's 4096 queries
    # at positions 4096-8191 against rank 0's 4096 keys); every pair visible,
    # so the bound counts 4 b H s sk d. The library call is sdpa with no mask
    # over the same chunk (K/V repeated to the query heads beforehand), which
    # computes the output but returns no (m, l)
    n = 4096
    q, k, v, pos, cnt = flash_inputs(torch, 1, 32, 8, n, 128, n, bf16, gen)
    qpos = (pos + n).contiguous()
    k_fold = fp.fold_key_validity(pos, cnt).contiguous()
    gate = torch.full((1,), n, dtype=torch.int32, device="cuda")
    kern = lambda: fp.launch(flash_lib, q, k, v, qpos, k_fold, stream(), 0, gate,  # noqa: E731
                             aux=True, full=True)
    ms = events_ms(kern, reps=10)
    kern_dev, kern_from = device_ms(torch, kern, 5, FLASH_BF16)
    plain_ms = events_ms(lambda: fp.flash_attention_plain(
        q, k, v, qpos, cnt + n, None, pos, cnt, return_aux=True), reps=2, warmup=1)
    kr, vr = k.repeat_interleave(4, dim=1), v.repeat_interleave(4, dim=1)
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(q, kr, vr)  # noqa: E731
    lib_ms = events_ms(lib, reps=10)
    lib_dev, lib_from = device_ms(torch, lib, 5, "")
    flops, nbytes = flash_work(q, k, v, qpos, cnt, kpos=k_fold, aux=True)
    check(flops == 4 * 32 * n * n * 128, "full_aux: the bound's work is not 4 b H s sk d")
    aux_bound, aux_by = bound(flops, nbytes)
    flash["full_aux"] = dict(
        launches=launches["flash_prefill_full"], aux_launches=launches["flash_prefill_aux"],
        max_abs_err=max(c["max_abs_err"] for c in cases
                        if c["kernel"] == "flash_prefill" and c.get("form") == "full_aux"),
        stats_max_m_rel=max(c["max_m_rel"] for c in cases if c["kernel"] == "flash_prefill_stats"),
        stats_max_l_rel=max(c["max_l_rel"] for c in cases if c["kernel"] == "flash_prefill_stats"),
        ms=ms, device_ms=kern_dev, plain_ms=plain_ms, bound_ms=aux_bound, bound_by=aux_by,
        library_ms=lib_ms, library_device_ms=lib_dev, device_ms_from=kern_from,
        library_device_ms_from=lib_from,
        library_note="sdpa with no mask over the same chunk: the output only, no (m, l)",
        shape=f"b=1 H=32 KH=8 s={n} (positions {n}-{2 * n - 1}) sk={n} (positions "
              f"0-{n - 1}) d=128 bf16, 'full' pattern with (m, l)",
        flop=flops, bytes=nbytes, **rates(flops, ms, aux_bound))
    del q, k, v, kr, vr, lib

    # flash prefill at GemFilter's pass-2 bucket at Llama-3.1-8B: s = 896
    # (seven query tiles), 819 valid keys (0.1 of 8192), every layer of pass 2
    s, n_sel = 896, 819
    q, k, v, pos, cnt = flash_inputs(torch, 1, 32, 8, s, 128, n_sel, bf16, gen)
    q_pos = pos.contiguous()
    k_pos = fp.fold_key_validity(pos, cnt).contiguous()
    kern = lambda: fp.launch(flash_lib, q, k, v, q_pos, k_pos, stream())  # noqa: E731
    ms = events_ms(kern, reps=20)
    kern_dev, kern_from = device_ms(torch, kern, 10, FLASH_BF16)
    plain_ms = events_ms(lambda: fp.flash_attention_plain(q, k, v, pos, cnt), reps=5)
    mask = k_pos[:, None, None, :] <= q_pos[:, None, :, None]
    lib = layer_sdpa(q, k[None], v[None], mask[None])
    lib_ms = events_ms(lib, reps=20)
    lib_dev, lib_from = device_ms(torch, lib, 10, "")
    flops, nbytes = flash_work(q, k, v, pos, cnt)
    g_bound, g_by = bound(flops, nbytes)
    flash["gemfilter_pass2_s896"] = dict(
        ms=ms, device_ms=kern_dev, plain_ms=plain_ms, bound_ms=g_bound, bound_by=g_by,
        library_ms=lib_ms, library_device_ms=lib_dev, device_ms_from=kern_from,
        library_device_ms_from=lib_from,
        shape=f"b=1 H=32 KH=8 s={s} d=128 bf16, causal, count {n_sel}",
        flop=flops, bytes=nbytes, **rates(flops, ms, g_bound))
    del q, k, v, mask, lib

    # flash prefill at a tensor-parallel rank's shape (tp_full_width's model
    # 2): Llama-3.1-8B's s = 8192 over half the heads, H = 16, KH = 4
    s = 8192
    q, k, v, pos, cnt = flash_inputs(torch, 1, 16, 4, s, 128, s, bf16, gen)
    q_pos = pos.contiguous()
    k_pos = fp.fold_key_validity(pos, cnt).contiguous()
    kern = lambda: fp.launch(flash_lib, q, k, v, q_pos, k_pos, stream())  # noqa: E731
    ms = events_ms(kern, reps=10)
    kern_dev, kern_from = device_ms(torch, kern, 5, FLASH_BF16)
    plain_ms = events_ms(lambda: fp.flash_attention_plain(q, k, v, pos, cnt), reps=2, warmup=1)
    mask = k_pos[:, None, None, :] <= q_pos[:, None, :, None]
    lib = layer_sdpa(q, k[None], v[None], mask[None])
    lib_ms = events_ms(lib, reps=10)
    lib_dev, lib_from = device_ms(torch, lib, 5, "")
    flops, nbytes = flash_work(q, k, v, pos, cnt)
    t_bound, t_by = bound(flops, nbytes)
    tp_paths = {p: n["flash_prefill"] for p, n in launches_by_path.items()
                if p.startswith(("tp_m2_", "tp_m2p2_"))}
    flash["tp2_H16_KH4_s8192"] = dict(
        launches=sum(tp_paths.values()), launches_by_path=tp_paths,
        max_abs_err=max(c["max_abs_err"] for c in cases if c["case"] == "8b_tp2_H16_KH4_s8192"),
        ms=ms, device_ms=kern_dev, plain_ms=plain_ms, bound_ms=t_bound, bound_by=t_by,
        device_ms_from=kern_from, **fair_sdpa(torch, q, k, v, reps=10),
        **masked(lib_ms, lib_dev, lib_from),
        shape=f"b=1 H=16 KH=4 s={s} d=128 bf16, causal (a model-2 rank of Llama-3.1-8B)",
        flop=flops, bytes=nbytes, **rates(flops, ms, t_bound))
    del q, k, v, mask, lib

    # flash prefill at PyramidInfer's layers at Llama-3.1-8B (PYRAMID_FLASH):
    # a gathered layout of ascending positions below 8192, a zero tail
    for s, count in PYRAMID_FLASH:
        q, k, v, pos, cnt = pyramid_flash_inputs(torch, s, count, gen)
        q_pos = pos.contiguous()
        k_pos = fp.fold_key_validity(pos, cnt).contiguous()
        kern = lambda: fp.launch(flash_lib, q, k, v, q_pos, k_pos, stream())  # noqa: E731
        ms = events_ms(kern, reps=20)
        kern_dev, kern_from = device_ms(torch, kern, 10, FLASH_BF16)
        plain_ms = events_ms(lambda: fp.flash_attention_plain(q, k, v, pos, cnt), reps=3)
        mask = k_pos[:, None, None, :] <= q_pos[:, None, :, None]
        lib = layer_sdpa(q, k[None], v[None], mask[None])
        lib_ms = events_ms(lib, reps=20)
        lib_dev, lib_from = device_ms(torch, lib, 10, "")
        flops, nbytes = flash_work(q, k, v, pos, cnt)
        p_bound, p_by = bound(flops, nbytes)
        flash[f"pyramid_s{s}_count{count}"] = dict(
            ms=ms, device_ms=kern_dev, plain_ms=plain_ms, bound_ms=p_bound, bound_by=p_by,
            library_ms=lib_ms, library_device_ms=lib_dev, device_ms_from=kern_from,
            library_device_ms_from=lib_from,
            shape=f"b=1 H=32 KH=8 s={s} d=128 bf16, causal over gathered positions, "
                  f"count {count}",
            flop=flops, bytes=nbytes, **rates(flops, ms, p_bound))
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

    # the throughput CLI's batch 16 over FastKV's cache (C = 1032; four
    # layers of 68 MB, cycled) and FullKV's (C = 8320; two layers of 545 MB)
    for name, C16, kept, L16 in (("fastkv_b16_C1032", C, 896, 4),
                                 ("fullkv_b16_C8320", 8192 + 128, 8192, 2)):
        q, kc, vc, valid = decode_inputs(torch, L16, 16, 32, 8, C16, 128, kept, bf16, gen)
        plan = da.split_plan(16, 8, 4, C16, build.num_sms(q.device))
        decode[name] = dict(
            **decode_timing(torch, decode_lib, q, kc, vc, valid, plan,
                            valid[:, :, :, None, :].repeat_interleave(4, dim=2), reps=4),
            shape=f"b=16 H=32 CH=8 C={C16} d=128 bf16, {kept + 31} valid slots/head")
        del q, kc, vc, valid

    # decode after the 131072-token prompt, b = 1: FastKV's cache (the
    # long-prompt phase's kept slots a head; four layers of ~55 MB, cycled)
    # and FullKV's (C = 131200; two layers of 537 MB)
    fast_c = long_prompt_fastkv_capacity()
    for name, Cl, kept, Ll, tag in ((f"fastkv_128k_C{fast_c}", fast_c, long_kept, 4, "fastkv"),
                                    (f"fullkv_128k_C{LONG_PROMPT + 128}", LONG_PROMPT + 128,
                                     LONG_PROMPT, 2, "fullkv")):
        q, kc, vc, valid = decode_inputs(torch, Ll, 1, 32, 8, Cl, 128, kept, bf16, gen)
        plan = da.split_plan(1, 8, 4, Cl, build.num_sms(q.device))
        paths = {p: n["decode_attn"] for p, n in launches_by_path.items()
                 if p.startswith(f"long_prompt_{tag}")}
        decode[name] = dict(
            launches=sum(paths.values()), launches_by_path=paths,
            max_abs_err=max(c["max_abs_err"] for c in cases if c["case"] == f"8b_{name}"),
            **decode_timing(torch, decode_lib, q, kc, vc, valid, plan,
                            valid[:, :, :, None, :].repeat_interleave(4, dim=2), reps=4),
            shape=f"b=1 H=32 CH=8 C={Cl} d=128 bf16, {kept + 31} valid slots/head")
        del q, kc, vc, valid

    # decode after the headline's top rung at Llama-3.2-1B (b = 1, head_dim
    # 64, 127 decoded slots): FastKV's cache (four layers of 47 MB, cycled)
    # and FullKV's (C = 229504; two layers of 470 MB)
    hs = headline_shapes()
    for m, kept, Ll in (("fastkv", HEADLINE_FAST_KEPT, 4), ("fullkv", HEADLINE_CTX, 2)):
        Cl = hs[m].total_capacity
        q, kc, vc, valid = decode_inputs(torch, Ll, 1, 32, 8, Cl, 64, kept, bf16, gen,
                                         HEADLINE_GEN - 1)
        plan = da.split_plan(1, 8, 4, Cl, build.num_sms(q.device))
        path = f"headline_int8w_{m}"
        decode[f"{m}_1b_C{Cl}"] = dict(
            launches=launches_by_path[path]["decode_attn"], launches_by_path={
                p: n["decode_attn"] for p, n in launches_by_path.items()
                if p.startswith("headline_") and p.endswith(m)},
            max_abs_err=max(c["max_abs_err"] for c in cases if c["case"] == f"1b_{m}_C{Cl}"),
            **decode_timing(torch, decode_lib, q, kc, vc, valid, plan,
                            valid[:, :, :, None, :].repeat_interleave(4, dim=2), reps=4),
            shape=f"b=1 H=32 CH=8 C={Cl} d=64 bf16, {kept + HEADLINE_GEN - 1} valid "
                  f"slots/head (the headline's top rung, Llama-3.2-1B)")
        del q, kc, vc, valid

    # a tensor-parallel rank's caches (tp_full_width's model 2): FastKV's C =
    # 1032 and FullKV's C = 8320 over four cache heads, 16 query heads
    # (32 layers of 2.1 MB and eight of 17 MB, cycled)
    for name, Cl, kept, Ll, tag in (("tp2_fastkv_CH4_C1032", 1032, 896, 32, "fastkv"),
                                    ("tp2_fullkv_CH4_C8320", 8320, 8192, 8, "fullkv")):
        q, kc, vc, valid = decode_inputs(torch, Ll, 1, 16, 4, Cl, 128, kept, bf16, gen)
        plan = da.split_plan(1, 4, 4, Cl, build.num_sms(q.device))
        paths = {p: n["decode_attn"] for p, n in launches_by_path.items()
                 if p.startswith((f"tp_m2_{tag}", f"tp_m2p2_{tag}"))}
        decode[name] = dict(
            launches=sum(paths.values()), launches_by_path=paths,
            max_abs_err=max(c["max_abs_err"] for c in cases if c["case"] == f"8b_{name}"),
            **decode_timing(torch, decode_lib, q, kc, vc, valid, plan,
                            valid[:, :, :, None, :].repeat_interleave(4, dim=2), reps=4),
            shape=f"b=1 H=16 CH=4 C={Cl} d=128 bf16, {kept + 31} valid slots/head "
                  f"(a model-2 rank of Llama-3.1-8B)")
        del q, kc, vc, valid

    # H2O's per-query-head cache at batch 1 (CH = H = 32, 819 kept + 8
    # window slots of 904, 128 decode slots; eight layers of 17 MB, cycled)
    # and GemFilter's FullKV cache of the reduced prompt (896 + 128 slots,
    # 819 kept; 32 layers of 4.2 MB, cycled)
    q, kc, vc, valid = decode_inputs(torch, 8, 1, 32, 32, C, 128, 827, bf16, gen)
    plan = da.split_plan(1, 32, 1, C, build.num_sms(q.device))
    decode["h2o_b1_CH32"] = dict(
        **decode_timing(torch, decode_lib, q, kc, vc, valid, plan, valid[:, :, :, None, :],
                        reps=4),
        shape=f"b=1 H=32 CH=32 C={C} d=128 bf16, 858 valid slots/head")
    del q, kc, vc, valid
    Cg = 896 + 128
    q, kc, vc, valid = decode_inputs(torch, 32, 1, 32, 8, Cg, 128, 819, bf16, gen)
    plan = da.split_plan(1, 8, 4, Cg, build.num_sms(q.device))
    decode["gemfilter_C1024"] = dict(
        **decode_timing(torch, decode_lib, q, kc, vc, valid, plan,
                        valid[:, :, :, None, :].repeat_interleave(4, dim=2), reps=4),
        shape=f"b=1 H=32 CH=8 C={Cg} d=128 bf16, 850 valid slots/head")
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

    # the decode prologue: its cases in kernels_vs_plain (each form at its
    # model's widths, b 1 and 8), the main paths' launches
    pro = [c for c in cases if c["kernel"] == "decode_prologue"]
    head = next(c for c in pro if c["form"] == "rope" and c["b"] == 1)
    prologue = dict(
        name="decode_prologue", route="cuda",
        source="fastkv_tpu_torch/kernels/csrc/decode_prologue.cu",
        replaces="none: XLA fuses the JAX package's RoPE and cache write; in the port they "
                 "were ~25-37 small launches a decode layer",
        launches=launches["decode_prologue"], max_abs_err=max(c["max_abs_err"] for c in pro),
        launches_by_path={p: n["decode_prologue"] for p, n in launches_by_path.items()},
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], shape=head["case"],
        cases={c["case"]: {k: c[k] for k in ("ms", "plain_ms", "bound_ms", "max_abs_err",
                                             "latent_max_ulp", "bitwise")} for c in pro})

    # the norm kernel: its cases in kernels_vs_plain (both forms at the
    # models' widths, b 1 and 8), the main paths' launches, two a decode
    # layer a step on each
    nc = [c for c in cases if c["kernel"] == "add_rms_norm"]
    head = next(c for c in nc if c["case"] == "nemo12b_add_rms_norm_b1")
    norm = dict(
        name="add_rms_norm", route="cuda", source="fastkv_tpu_torch/kernels/csrc/add_rms_norm.cu",
        replaces="none: XLA fuses the JAX package's residual add and RMSNorm; in the port they "
                 "were ~18 small launches a decode layer",
        launches=launches["add_rms_norm"], max_abs_err=max(c["max_abs_err"] for c in nc),
        launches_by_path={p: n.get("add_rms_norm") for p, n in launches_by_path.items()},
        ms=head["ms"], plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], shape=head["case"],
        cases={c["case"]: {k: c[k] for k in ("ms", "norm_ms", "plain_ms", "plain_norm_ms",
                                             "bound_ms", "max_abs_err", "max_ulp", "bitwise")}
               for c in nc})
    for p, n in launches_by_path.items():
        check_norm(n, p, NORMS_A_LAYER.get(p, 2))
    return [flash, decode, prologue, norm]


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
    # raises its consumers' registers with setmaxnreg; two head dims x ten
    # forms, and MLA's q/k 192, v 128 square) must not spill
    spills = {k: v for k, v in ptxas_spills(build.build_log("flash_prefill")).items()
              if FLASH_BF16 in k}
    # and so must the decode kernel's bf16 and int8 instantiations (two head
    # dims x bf16/int8 cache x with/without the window term)
    decode_spills = {k: v for k, v in ptxas_spills(build.build_log("decode_attn")).items()
                     if DECODE_TC in k}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": {n: str(p.name) for n, p in paths.items()}, "ptxas": ptxas,
          "flash_bf16_spills": spills, "decode_tc_spills": decode_spills})
    check(len(spills) == 21 and all(v == [0, 0] for v in spills.values()),
          f"the bf16 flash kernel's ptxas report shows spills or misses instantiations: {spills}")
    check(len(decode_spills) == 8 and all(v == [0, 0] for v in decode_spills.values()),
          f"the decode kernel's ptxas report shows spills or misses instantiations: "
          f"{decode_spills}")
    cases, flash_lib, decode_lib = phase_kernels_vs_plain(torch)
    phase_tiny_card_vs_cpu(torch)
    phase_tiny_serve_paths_card_vs_cpu(torch)
    # sequence parallelism, while this process holds no weights
    phase_sp_tiny_card_vs_cpu(torch)
    phase_tp_tiny_card_vs_cpu(torch)
    sp_by_path = phase_sp_full_width(torch, gpu)
    from fastkv_tpu_torch.core.config import ModelConfig

    by_path, _, held = phase_full_width(torch, gpu)
    by_path.update(sp_by_path)
    by_path.update(phase_checkpoint_and_clis(torch, gpu, held))
    del held
    by_path.update(phase_int8(torch, gpu))
    by_path.update(phase_serve(torch, gpu))
    free_cuda(torch)
    by_path.update(phase_serve_paths(torch, gpu))
    free_cuda(torch)
    long_launches, long_kept = phase_long_prompt(torch, gpu)
    free_cuda(torch)
    by_path.update(long_launches)
    # Ministral-8B: 40960 tokens, longer than its 32768 window, so the window
    # masks 8192 query rows in prefill and cuts FullKV's decode cache
    by_path["ministral_8b"] = phase_mistral(
        torch, gpu, "ministral", ModelConfig.ministral_8b(), 40960, tsp_idx=17)
    by_path["mistral_nemo_12b"] = phase_mistral(
        torch, gpu, "nemo", ModelConfig.mistral_nemo_12b(), 8192, tsp_idx=19)
    by_path["deepseek_v3_ep32"] = phase_dsv3(torch, gpu)
    # the headline benchmark's subprocesses, with this process's memory freed
    free_cuda(torch)
    by_path.update(phase_headline(torch, gpu))
    profile_headline(torch, gpu)
    launches = {k: sum(n.get(k, 0) for n in by_path.values()) for k in LAUNCH_KEYS}
    kernels = phase_timings(torch, cases, flash_lib, decode_lib, launches, by_path, long_kept)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
