"""Batched-decode throughput: tokens/s against the decode batch size.

Port of ``fastkv_tpu.bench.throughput``. In serving, the decode batch is the
throughput lever, and KV compression raises the batch that fits: the
compressed cache is ~retain_rate of the full one, and each step streams
fewer bytes. This measures tokens/s for each method over a ladder of batch
sizes at one context length.

Protocol (the Scheduler's execution shape: batch-1 prefill admission, one
shared batched decode): one batch-1 prefill of an all-ones prompt builds the
cache; the cache, logits and lengths are tiled to batch B (the same content
in every row: each step's work and bytes are those of B requests of that
length); greedy decode runs at batch B through the decode kernel; tok/s =
B * (genlen - 1) / decode seconds (the mean of ``--runs``, after a warm-up).
A ladder climbs and stops at its first ``torch.cuda.OutOfMemoryError``, so
the largest batch that fits is measured; any other error propagates. Each
method runs in a subprocess of its own, so one ladder's out-of-memory state
never reaches the next.

Every row of a batch is the same request, so every row must decode the same
tokens: a batch whose rows differ raises. Each rung logs row 0's tokens, and
each method the kernels' launches it made (``ops.flash_prefill.launches``,
``ops.decode_attn.launches``, ``ops.decode_prologue.launches``,
``ops.add_rms_norm.launches``; 0 on the CPU, where the plain versions run),
so a caller of the subprocesses can check them.

Run:
    python -m fastkv_tpu_torch.bench.throughput --preset llama-3.1-8b --ctx 8192 --genlen 64
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
import time

import torch

# methods whose decode is the standard step (GemFilter's prefill is two
# passes, PyramidInfer decodes with its own step)
METHODS = ("fullkv", "fastkv", "snapkv", "h2o", "streamingllm")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _tile(x: torch.Tensor, b: int, axis: int) -> torch.Tensor:
    return x.repeat_interleave(b, dim=axis)


def run(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="llama-3.2-1b")
    p.add_argument("--ctx", type=int, default=16384)
    p.add_argument("--genlen", type=int, default=64)
    p.add_argument("--runs", type=int, default=2)
    p.add_argument("--batches", nargs="+", type=int, default=[1, 4, 8, 16, 32, 64])
    p.add_argument("--methods", nargs="+", default=["fullkv", "fastkv"], choices=METHODS)
    p.add_argument("--retain_rate", type=float, default=0.1)
    p.add_argument("--tsp_rate", type=float, default=0.2)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain "
                   "versions, for tests)")
    p.add_argument("--no_subprocess", action="store_true",
                   help="run the methods in this process (each method's subprocess sets it)")
    args = p.parse_args(argv)

    if not args.no_subprocess and len(args.methods) > 1:
        peaks = {}
        for method in args.methods:
            cmd = [sys.executable, "-m", "fastkv_tpu_torch.bench.throughput",
                   "--no_subprocess", "--methods", method]
            for flag, val in (("--preset", args.preset), ("--ctx", args.ctx),
                              ("--genlen", args.genlen), ("--runs", args.runs),
                              ("--retain_rate", args.retain_rate),
                              ("--tsp_rate", args.tsp_rate), ("--dtype", args.dtype),
                              ("--device", args.device)):
                cmd += [flag, str(val)]
            cmd += ["--batches"] + [str(b) for b in args.batches]
            r = subprocess.run(cmd, stderr=subprocess.PIPE, text=True, timeout=3600)
            sys.stderr.write(r.stderr)
            if r.returncode != 0:
                raise RuntimeError(f"throughput: the {method} run exited {r.returncode}")
            hits = re.findall(rf"\[{method}\] B=(\d+): (\d+) tok/s", r.stderr)
            if hits:
                peaks[method] = max((int(t), int(b)) for b, t in hits)
        if all(m in peaks for m in ("fullkv", "fastkv")):
            (tf, bf), (tk, bk) = peaks["fullkv"], peaks["fastkv"]
            log(f"peak serving throughput ctx={args.ctx}: fullkv {tf} tok/s "
                f"(B={bf}) vs fastkv {tk} tok/s (B={bk}) = {tk/tf:.2f}x")
        return

    from fastkv_tpu_torch.cache.kv_cache import KVCache
    from fastkv_tpu_torch.core.config import MODEL_PRESETS, EngineConfig, Method, MethodConfig
    from fastkv_tpu_torch.core.device import resolve_device
    from fastkv_tpu_torch.engine import decode as decode_mod
    from fastkv_tpu_torch.engine import prefill as prefill_mod
    from fastkv_tpu_torch.models.llama import init_params
    from fastkv_tpu_torch.ops import add_rms_norm, decode_attn, decode_prologue, flash_prefill
    from fastkv_tpu_torch.utils.timing import force, warmup_device

    dev = resolve_device(args.device)
    cfg = MODEL_PRESETS[args.preset](dtype=args.dtype)
    log(f"device warmup {warmup_device(dev):.1f}s")
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    leaves = [*params["layers"].values(), *(x for k, x in params.items() if k != "layers")]
    weight_bytes = sum(x.numel() * x.element_size() for x in leaves)

    results = {}
    for method in args.methods:
        mcfg = MethodConfig(
            method=Method(method), eviction_mode="proportional",
            retain_rate=args.retain_rate, tsp_rate=args.tsp_rate,
            tsp_idx=min(max(1, cfg.num_layers // 2 - 1), cfg.num_layers - 2),
            window_size=8, kernel_size=7, pooling="maxpool",
        )
        ecfg = EngineConfig(prefill_buckets=(args.ctx,), max_new_tokens=args.genlen)
        shapes = prefill_mod.plan_shapes(cfg, mcfg, ecfg, args.ctx)
        launched = (flash_prefill.launches, decode_attn.launches, decode_prologue.launches,
                    add_rms_norm.launches)
        tokens = torch.ones((1, args.ctx), dtype=torch.int32, device=dev)
        n1 = torch.tensor([args.ctx], dtype=torch.int32, device=dev)
        with torch.inference_mode():
            logits1, cache1 = prefill_mod.prefill(params, cfg, mcfg, shapes, tokens, n1, ecfg)
        force(logits1)
        cache_bytes_ex = sum(t.numel() * t.element_size() for _, t in cache1.fields())
        log(f"[{method}] prefilled ctx={args.ctx}; cache/example {cache_bytes_ex/1e9:.3f} GB")

        def generate(b):
            big = KVCache(*(None if t is None else _tile(t, b, 1) for t in cache1))
            force(big.k)  # made off the clock
            t0 = time.perf_counter()
            with torch.inference_mode():
                res, _ = decode_mod.greedy_generate(
                    params, cfg, mcfg, shapes, _tile(logits1, b, 0), big, _tile(n1, b, 0),
                    args.genlen)
            force(res.tokens)
            dt = time.perf_counter() - t0
            if not torch.equal(res.tokens, res.tokens[:1].expand_as(res.tokens)):
                raise RuntimeError(f"[{method}] B={b}: the rows, one request tiled, "
                                   "decoded different tokens")
            return dt, res.tokens[0].tolist()

        rows = []
        for b in args.batches:
            try:
                _, toks = generate(b)  # warm-up
                dt = sum(generate(b)[0] for _ in range(args.runs)) / args.runs
            except torch.cuda.OutOfMemoryError:
                log(f"[{method}] B={b}: out of memory; the ladder stops")
                break
            log(f"[{method}] B={b} tokens " + " ".join(map(str, toks)))
            tok_s = b * (args.genlen - 1) / dt
            step_bytes = weight_bytes + b * cache_bytes_ex
            bw = step_bytes * (args.genlen - 1) / dt / 1e9
            rows.append((b, tok_s, dt))
            log(f"[{method}] B={b}: {tok_s:.0f} tok/s ({dt*1e3/(args.genlen-1):.2f} ms/step, "
                f"step bytes {step_bytes/1e9:.2f} GB, implied BW {bw:.0f} GB/s)")
        results[method] = rows
        log(f"[{method}] kernel launches: flash_prefill "
            f"{flash_prefill.launches - launched[0]}, decode_attn "
            f"{decode_attn.launches - launched[1]}, decode_prologue "
            f"{decode_prologue.launches - launched[2]}, add_rms_norm "
            f"{add_rms_norm.launches - launched[3]}")

    if all(results.get(m) for m in ("fullkv", "fastkv")):
        best_full = max(t for _, t, _ in results["fullkv"])
        best_fast = max(t for _, t, _ in results["fastkv"])
        log(f"peak serving throughput ctx={args.ctx}: fullkv {best_full:.0f} tok/s vs fastkv "
            f"{best_fast:.0f} tok/s = {best_fast/best_full:.2f}x")


if __name__ == "__main__":
    run()
