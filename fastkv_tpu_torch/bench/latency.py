"""Latency benchmarks: prefill (TTFT) and e2e prefill + decode.

Port of ``fastkv_tpu.bench.latency``, with the reference's protocols:
  * prefill: a synthetic all-ones prompt, a warm-up and N measured runs,
    mean/std/95% CI and peak memory, appended to a txt report per rung
    (reference: benchmark/prefill.py:53-176);
  * e2e: prefill + genlen greedy decode, tokens/s (reference:
    benchmark/e2e.py:152-243; H2O capped at 8192 tokens, :377-378, unless
    ``--h2o_no_cap``).

Each run is one ``Engine.generate`` (``max_new_tokens=1`` for prefill): its
seconds come from ``Engine.last_timing``, each phase ended by a device
synchronisation. So every method is timed on its own path: GemFilter's
prefill is both passes (``pass1_s + pass2_s``), PyramidInfer's includes its
decode state and its decode its own re-compressing step. ``peak_mem`` is
``torch.cuda.max_memory_allocated`` over the rung (reset before it; None on
the CPU).

CLI:
  python -m fastkv_tpu_torch.bench.latency prefill --model_path DIR --method fastkv \
      --context_lengths 8192 32768 131072
  python -m fastkv_tpu_torch.bench.latency e2e --model_path DIR --method fastkv --genlen 256
``--preset llama-3.1-8b --random_weights`` benches without a checkpoint;
``--device cpu`` runs the plain versions of the kernels (for tests).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build(args):
    from fastkv_tpu_torch.core.config import MODEL_PRESETS, Method, MethodConfig
    from fastkv_tpu_torch.core.device import resolve_device

    dev = resolve_device(args.device)
    if args.random_weights:
        from fastkv_tpu_torch.models.llama import init_params

        cfg = MODEL_PRESETS[args.preset](dtype=args.dtype)
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    else:
        from fastkv_tpu_torch.core.weights import load_params, model_config_from_dir

        cfg = model_config_from_dir(args.model_path, dtype=args.dtype)
        params = load_params(args.model_path, cfg, device=dev)
    mcfg = MethodConfig(
        method=Method(args.method),
        window_size=args.window_size,
        kernel_size=args.kernel_size,
        pooling=args.pooling,
        eviction_mode=args.eviction_mode,
        max_capacity_prompt=args.max_capacity_prompts,
        tsp_len=args.tsp_len,
        retain_rate=args.retain_rate,
        tsp_rate=args.tsp_rate,
        tsp_idx=args.tsp_idx if args.tsp_idx >= 0
        else min(max(1, round(cfg.num_layers * 15 / 32)), cfg.num_layers - 2),
        filter_idx=args.filter_idx,
    )
    return cfg, params, mcfg


def stats(times):
    a = np.asarray(times)
    mean = float(a.mean())
    std = float(a.std())
    ci = 1.96 * std / max(len(a), 1) ** 0.5
    return mean, std, ci


def _engine(args, cfg, params, mcfg, ctx: int, genlen: int):
    from fastkv_tpu_torch.core.config import EngineConfig
    from fastkv_tpu_torch.engine.generate import Engine

    if torch.device(args.device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(args.device)
    ecfg = EngineConfig(prefill_buckets=(ctx,), max_new_tokens=genlen)
    eng = Engine(params, cfg, mcfg, ecfg, device=args.device)
    prompts = [[1] * ctx for _ in range(args.batch)]
    return eng, prompts


def bench_prefill(args, cfg, params, mcfg, ctx: int):
    """TTFT: one generate of a single token per run (GemFilter: both passes;
    PyramidInfer: with its decode state)."""
    from fastkv_tpu_torch.utils.profiling import peak_bytes

    eng, prompts = _engine(args, cfg, params, mcfg, ctx, 1)
    eng.generate(prompts, 1)  # warm-up
    times = []
    for _ in range(args.runs):
        eng.generate(prompts, 1)
        times.append(eng.last_timing["prefill_s"])
    mean, std, ci = stats(times)
    return {"context": ctx, "mean_s": mean, "std_s": std, "ci95_s": ci,
            "peak_mem": peak_bytes(args.device)}


def bench_e2e(args, cfg, params, mcfg, ctx: int):
    from fastkv_tpu_torch.utils.profiling import peak_bytes

    genlen = args.genlen
    eng, prompts = _engine(args, cfg, params, mcfg, ctx, genlen)
    eng.generate(prompts, genlen)  # warm-up
    pts, dts = [], []
    for _ in range(args.runs):
        eng.generate(prompts, genlen)
        pts.append(eng.last_timing["prefill_s"])
        dts.append(eng.last_timing["decode_s"])
    pm_, ps, pci = stats(pts)
    dm_, ds, dci = stats(dts)
    tok_s = args.batch * (genlen - 1) / dm_
    return {
        "context": ctx, "genlen": genlen, "prefill_mean_s": pm_, "prefill_ci95_s": pci,
        "decode_mean_s": dm_, "decode_ci95_s": dci, "tokens_per_s": tok_s,
        "peak_mem": peak_bytes(args.device),
    }


def main(argv=None):
    """Runs the rungs; prints their records as one JSON list on stdout (and
    returns it)."""
    p = argparse.ArgumentParser()
    p.add_argument("mode", choices=["prefill", "e2e"])
    p.add_argument("--model_path", default=None)
    p.add_argument("--preset", default="llama-3.2-1b")
    p.add_argument("--random_weights", action="store_true")
    p.add_argument("--method", default="fastkv")
    p.add_argument("--context_lengths", nargs="+", type=int, default=[8192, 32768, 131072])
    p.add_argument("--genlen", type=int, default=256)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--save_dir", default="outputs/benchmark")
    p.add_argument("--window_size", type=int, default=8)
    p.add_argument("--kernel_size", type=int, default=7)
    p.add_argument("--pooling", default="maxpool")
    p.add_argument("--eviction_mode", default="proportional")
    p.add_argument("--max_capacity_prompts", type=int, default=512)
    p.add_argument("--tsp_len", type=int, default=2048)
    p.add_argument("--retain_rate", type=float, default=0.1)
    p.add_argument("--tsp_rate", type=float, default=0.2)
    p.add_argument("--tsp_idx", type=int, default=-1)
    p.add_argument("--filter_idx", type=int, default=13)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain "
                   "versions, for tests)")
    p.add_argument(
        "--trace", default=None, metavar="DIR",
        help="capture a torch.profiler trace of the measured runs into DIR/trace.json "
        "(Chrome trace format; utils.profiling.trace): the operators and kernels, and the "
        "program's own spans (engine, prefill segments, keep-sets, decode steps) in rows of "
        "their own",
    )
    p.add_argument(
        "--jsonl", default=None, metavar="PATH",
        help="append structured per-phase JSONL records (ts/phase/metrics) to PATH via "
        "utils.profiling.PhaseLogger ('-' = stderr)",
    )
    p.add_argument(
        "--h2o_no_cap", action="store_true",
        help="lift the reference's 8192-context cap on H2O: the blocked O(s)-memory scorer "
        "(ops.attention.h2o_scores) removes the O(n^2) logits that forced the cap "
        "(reference eval/run_longbench.py:117-119). Default keeps the cap for protocol parity.",
    )
    args = p.parse_args(argv)
    if not args.model_path:
        args.random_weights = True

    from fastkv_tpu_torch.utils import profiling
    from fastkv_tpu_torch.utils.timing import warmup_device

    log(f"warmup {warmup_device(args.device):.1f}s")
    cfg, params, mcfg = build(args)
    os.makedirs(args.save_dir, exist_ok=True)
    out_txt = os.path.join(args.save_dir, f"{args.mode}_{cfg.name}_{args.method}.txt")
    results = []
    plogger = None
    if args.jsonl:
        stream = sys.stderr if args.jsonl == "-" else open(args.jsonl, "a")
        plogger = profiling.PhaseLogger(stream=stream)

    tracer = profiling.trace(args.trace) if args.trace else contextlib.nullcontext()
    with tracer:
        for ctx in args.context_lengths:
            if args.method == "h2o" and ctx > 8192 and not args.h2o_no_cap:
                log(f"skip ctx {ctx} for h2o (reference caps at 8192, e2e.py:377-378; "
                    f"pass --h2o_no_cap to lift it)")
                continue
            r = (bench_prefill if args.mode == "prefill" else bench_e2e)(
                args, cfg, params, mcfg, ctx)
            results.append(r)
            log(json.dumps(r))
            if plogger is not None:
                plogger.log(args.mode, method=args.method, model=cfg.name, **r)
            with open(out_txt, "a") as f:
                f.write(json.dumps({"method": args.method, **r}) + "\n")
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
