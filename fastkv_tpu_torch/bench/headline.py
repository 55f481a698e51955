"""Headline benchmark: FastKV against FullKV end-to-end decode speedup on one card.

Port of the repository's ``bench.py`` (the JAX package's headline script),
with its protocol: a synthetic all-ones prompt, greedy decode, prefill and
decode timed apart, FastKV at the canonical point against FullKV; the
headline is FastKV's decode speedup over FullKV, set against the reference's
2.87x (reference README.md:16).

    python -m fastkv_tpu_torch.bench.headline                  # the card
    FASTKV_BENCH_CPU=1 python -m fastkv_tpu_torch.bench.headline  # tiny CPU smoke

Prints ONE JSON line on stdout, ``{"metric", "value", "unit", "vs_baseline"}``,
with ``bench.py``'s metric name and rounding. Everything else goes to stderr,
among it one JSON line ``{"headline_rung": {...}}`` per completed rung: each
method's record, its runs' seconds (mean and median), the kernels' launches,
whether the decode kernel's arrival counters are back at zero, peak memory
and the roofline.

The context comes from a descending ladder (``DEFAULT_LADDER``, 229376 down
to 131072), one subprocess per rung: a rung whose child exits non-zero (an
exception, ``torch.cuda.OutOfMemoryError`` among them) or times out drops to
the next, and the line comes from the largest rung that completed. The
child's stderr passes through. Nothing re-runs on the CPU: the CPU runs only
under ``FASTKV_BENCH_CPU=1``, and without a card the script raises.

Differences from ``bench.py``:
  * the methods' timed runs alternate (FullKV, FastKV, FullKV, ...) after a
    warm run of each, as ``bench.py``'s fusion A/B alternates its arms: decode
    is host-bound on the card and its speed drifts between runs. Each
    method's record keeps ``bench.py``'s keys and its means; the medians are
    logged beside them;
  * ``peak_mem`` is ``torch.cuda.max_memory_allocated``, reset before each
    run and maxed over the method's runs (None on the CPU). ``bench.py``
    reads its device's process-wide peak, so its FastKV figure repeats
    FullKV's;
  * no ``FASTKV_BENCH_PALLAS`` / ``_DECODE_PALLAS``: the kernels are the
    path, and a kernel's wrapper raises rather than giving way;
  * the fusion A/B runs at every context (the port fuses at every length)
    and on the CPU too, where the kernels' plain versions run;
  * the roofline uses the card's own memory rate
    (``kernels.timing.PEAK_BYTES``).

Env knobs: FASTKV_BENCH_MODEL (default llama-3.2-1b), FASTKV_BENCH_GEN (128),
FASTKV_BENCH_RUNS (timed runs a method, 2), FASTKV_BENCH_QUANT (``int8``
weights by default on the card, ``none`` for bf16), FASTKV_BENCH_KV=int8
(the int8 KV cache), FASTKV_BENCH_MLP_CHUNK (``EngineConfig.mlp_chunk``),
FASTKV_BENCH_FUSION_AB (1), FASTKV_BENCH_CTX (pins the top rung; the
default rungs below it stay as fallbacks), FASTKV_BENCH_LADDER (an explicit
comma-separated ladder), FASTKV_BENCH_RUNG_TIMEOUT (seconds a rung, 2400),
FASTKV_BENCH_CPU=1 (the tiny config with 4 layers, context 512, 16 new
tokens, capacity_align 8, on the CPU).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

REF_DECODE_SPEEDUP = 2.87  # reference README.md:16
DEFAULT_LADDER = (229376, 196608, 163840, 131072)
CPU_LADDER = (512,)
FUSION_AB_CTX = 98304  # bench.py's A/B context cap
RECORD_KEY = "headline_rung"  # key of a completed rung's details line on stderr
ROOT = Path(__file__).resolve().parents[2]  # the checkout the children import from


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def cpu_smoke() -> bool:
    return os.environ.get("FASTKV_BENCH_CPU") == "1"


def timed_runs() -> int:
    return int(os.environ.get("FASTKV_BENCH_RUNS", "2"))


def canonical_mcfg(cfg, method_name: str):
    """The canonical point (proportional, retain 0.1, TSP 0.2, window 8,
    maxpool 7) with tsp_idx at half the depth: 15 of 32 layers, as the
    reference's scripts/eval_longbench.sh, so L//2 - 1 at other depths."""
    from fastkv_tpu_torch.core.config import Method, MethodConfig

    return MethodConfig(
        method=Method(method_name), eviction_mode="proportional", retain_rate=0.1,
        tsp_rate=0.2, tsp_idx=min(max(1, cfg.num_layers // 2 - 1), cfg.num_layers - 2),
        window_size=8, kernel_size=7, pooling="maxpool")


def tree_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def weight_bytes(params) -> int:
    """Bytes of every weight (int8 weights with their float32 scales)."""
    return tree_bytes([*params["layers"].values(),
                       *(x for k, x in params.items() if k != "layers")])


def launch_counts() -> Dict[str, int]:
    """The kernels' launch counters (module globals; 0 on the CPU)."""
    from fastkv_tpu_torch.ops import decode_attn as da
    from fastkv_tpu_torch.ops import flash_prefill as fp

    return {"flash_prefill": fp.launches, "flash_prefill_scores": fp.scores_launches,
            "window_scores_finish": fp.finish_launches, "flash_prefill_rect": fp.rect_launches,
            "flash_prefill_aux": fp.aux_launches, "flash_prefill_full": fp.full_launches,
            "decode_attn": da.launches, "decode_attn_int8": da.int8_launches,
            "decode_attn_window": da.window_launches}


class MethodRun:
    """One method at one context on the params' device: the shapes and the
    prompt are made once; each ``run`` is a prefill and, unless
    ``prefill_only``, a greedy decode of ``genlen`` tokens from its cache,
    each timed on the host clock and ended by ``utils.timing.force`` (a
    device synchronisation). Counts its prefills, decodes and the kernels'
    launches they made. ``label`` names it in the log (default: the method)."""

    def __init__(self, method_name, cfg, params, ctx, genlen, ecfg_kw, prefill_only=False,
                 label=None):
        from fastkv_tpu_torch.core.config import EngineConfig
        from fastkv_tpu_torch.engine import prefill as prefill_mod

        self.name, self.cfg, self.params = method_name, cfg, params
        self.label = label or method_name
        self.genlen, self.prefill_only = genlen, prefill_only
        self.mcfg = canonical_mcfg(cfg, method_name)
        self.ecfg = EngineConfig(prefill_buckets=(ctx,), max_new_tokens=genlen, **ecfg_kw)
        self.shapes = prefill_mod.plan_shapes(cfg, self.mcfg, self.ecfg, ctx)
        self.device = params["final_norm"].device
        self.tokens = torch.ones((1, ctx), dtype=torch.int32, device=self.device)
        self.n_true = torch.tensor([ctx], dtype=torch.int32, device=self.device)
        self.prefill_times, self.decode_times = [], []
        self.prefills = self.decodes = 0
        self.launches = dict.fromkeys(launch_counts(), 0)
        self.cache_bytes = None
        self.peak_mem = None

    def run(self, timed: bool = True) -> None:
        from fastkv_tpu_torch.engine import decode as decode_mod
        from fastkv_tpu_torch.engine import prefill as prefill_mod
        from fastkv_tpu_torch.utils.timing import force

        on_card = self.device.type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats(self.device)
        before = launch_counts()
        with torch.inference_mode():
            t0 = time.perf_counter()
            logits, cache = prefill_mod.prefill(self.params, self.cfg, self.mcfg, self.shapes,
                                                self.tokens, self.n_true, self.ecfg)
            force(logits)
            pt = time.perf_counter() - t0
            self.prefills += 1
            dt = None
            if not self.prefill_only:
                t0 = time.perf_counter()
                res, cache = decode_mod.greedy_generate(
                    self.params, self.cfg, self.mcfg, self.shapes, logits, cache, self.n_true,
                    self.genlen)
                force(res.tokens)
                dt = time.perf_counter() - t0
                self.decodes += 1
        self.cache_bytes = tree_bytes(t for _, t in cache.fields())
        del logits, cache
        for k, n in launch_counts().items():
            self.launches[k] += n - before[k]
        if on_card:
            peak = int(torch.cuda.max_memory_allocated(self.device))
            self.peak_mem = max(self.peak_mem or 0, peak)
        if timed:
            self.prefill_times.append(pt)
            if dt is not None:
                self.decode_times.append(dt)
        else:
            log(f"[{self.label}] warm run: prefill {pt:.2f}s"
                + ("" if dt is None else f", decode {dt:.2f}s"))

    def record(self) -> dict:
        """``bench.py``'s record: the means of the timed runs."""
        pt = float(np.mean(self.prefill_times))
        dt = float(np.mean(self.decode_times)) if self.decode_times else 0.0
        return {"prefill_s": pt, "decode_s": dt,
                "tok_s": (self.genlen - 1) / dt if dt > 0 else float("inf"),
                "peak_mem": self.peak_mem, "cache_bytes": self.cache_bytes}

    def summary(self) -> dict:
        """The record with the medians, every timed run's seconds, the
        prefills and decodes run (warm runs included) and their launches."""
        med = lambda xs: float(np.median(xs)) if xs else None  # noqa: E731
        return {**self.record(), "prefill_median_s": med(self.prefill_times),
                "decode_median_s": med(self.decode_times),
                "prefill_times_s": self.prefill_times, "decode_times_s": self.decode_times,
                "prefills": self.prefills, "decodes": self.decodes,
                "launches": dict(self.launches)}

    def log_line(self) -> None:
        r = self.record()
        log(f"[{self.label}] prefill {r['prefill_s'] * 1e3:.1f}ms (median "
            f"{np.median(self.prefill_times) * 1e3:.1f})  decode {r['decode_s'] * 1e3:.1f}ms "
            + (f"(median {np.median(self.decode_times) * 1e3:.1f}) " if self.decode_times else "")
            + f"for {self.genlen - 1} toks = {r['tok_s']:.1f} tok/s  peak_mem={r['peak_mem']}")


def bench_method(method_name, cfg, params, ctx, genlen, ecfg_kw, prefill_only=False) -> dict:
    """``bench.py``'s ``bench_method``: one warm run, then FASTKV_BENCH_RUNS
    timed runs of one method; returns its record (``prefill_s``, ``decode_s``,
    ``tok_s``, ``peak_mem``, ``cache_bytes``). ``cache_bytes`` sums every set
    field of the ``KVCache``, whose layout is the JAX package's."""
    m = MethodRun(method_name, cfg, params, ctx, genlen, ecfg_kw, prefill_only)
    m.run(timed=False)
    for _ in range(timed_runs()):
        m.run()
    m.log_line()
    return m.record()


def alternate(runs, rounds: int) -> None:
    """A warm run of each, then ``rounds`` timed runs of each, in turns."""
    for m in runs:
        m.run(timed=False)
    for _ in range(rounds):
        for m in runs:
            m.run()


def fusion_ab(cfg, params, ctx, genlen, ecfg_kw, rounds=3) -> Tuple[MethodRun, MethodRun]:
    """``bench.py``'s ``_fusion_ab``: FastKV's prefill with the observation
    window's scores fused into the flash kernel against the separate scoring
    pass, the arms alternating; returns the (fused, unfused) runs."""
    arms = tuple(MethodRun("fastkv", cfg, params, ctx, genlen,
                           {**ecfg_kw, "fuse_window_scores": fuse}, prefill_only=True,
                           label=f"fastkv {arm}")
                 for arm, fuse in (("fused", True), ("unfused", False)))
    alternate(arms, rounds)
    return arms


def run_rung(ctx: int) -> dict:
    """Both methods at one context: prints the rung's details line on
    stderr and the JSON line on stdout; returns the details. Run in a
    subprocess per ladder rung (``main``)."""
    from fastkv_tpu_torch.core.config import MODEL_PRESETS, ModelConfig
    from fastkv_tpu_torch.core.device import resolve_device
    from fastkv_tpu_torch.kernels.timing import PEAK_BYTES
    from fastkv_tpu_torch.models.llama import init_params, init_params_int8
    from fastkv_tpu_torch.ops import decode_attn
    from fastkv_tpu_torch.utils.timing import force, gpu_line, warmup_device

    cpu = cpu_smoke()
    if cpu:
        dev = resolve_device("cpu")
        cfg = ModelConfig.tiny(num_layers=4)
        genlen = 16
        ecfg_kw = dict(capacity_align=8)
        gpu = None
    else:
        dev = resolve_device("cuda")
        cfg = MODEL_PRESETS[os.environ.get("FASTKV_BENCH_MODEL", "llama-3.2-1b")](
            dtype="bfloat16")
        genlen = int(os.environ.get("FASTKV_BENCH_GEN", "128"))
        ecfg_kw = {}
        mc = os.environ.get("FASTKV_BENCH_MLP_CHUNK")
        if mc is not None:
            ecfg_kw["mlp_chunk"] = int(mc)
        gpu = gpu_line()
    log(f"device: {gpu or 'cpu'}, model: {cfg.name}, ctx={ctx}, genlen={genlen}")
    log(f"device warmup {warmup_device(dev):.1f}s")
    # int8 weight-only quantization for both methods (the ratio stays a fair
    # comparison), made in int8 a layer at a time, never a whole bf16 copy
    quant_mode = "none" if cpu else os.environ.get("FASTKV_BENCH_QUANT", "int8")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = (init_params_int8(cfg, gen, device=dev) if quant_mode == "int8"
              else init_params(cfg, gen, device=dev))
    force(params["final_norm"])
    log(f"params initialised on {dev.type} ({quant_mode}) in {time.perf_counter() - t0:.1f}s")
    if os.environ.get("FASTKV_BENCH_KV", "bf16") == "int8" and not cpu:
        ecfg_kw["kv_int8"] = True

    runs = timed_runs()
    full, fast = (MethodRun(m, cfg, params, ctx, genlen, ecfg_kw) for m in ("fullkv", "fastkv"))
    alternate((full, fast), runs)
    for m in (full, fast):
        m.log_line()
    rf, rk = full.summary(), fast.summary()
    speedup = rf["decode_s"] / rk["decode_s"]
    prefill_ratio = rf["prefill_s"] / rk["prefill_s"]
    speedup_median = rf["decode_median_s"] / rk["decode_median_s"]
    log(f"ctx={ctx}: decode speedup {speedup:.2f}x (of medians {speedup_median:.2f}x)  "
        f"prefill ratio {prefill_ratio:.2f}x  fastkv {rk['tok_s']:.1f} tok/s vs fullkv "
        f"{rf['tok_s']:.1f} tok/s")

    ab = None
    if os.environ.get("FASTKV_BENCH_FUSION_AB", "1") == "1":
        ab_ctx = min(ctx, FUSION_AB_CTX)
        fused, unfused = fusion_ab(cfg, params, ab_ctx, genlen, ecfg_kw, rounds=3)
        ft, ut = fused.record()["prefill_s"], unfused.record()["prefill_s"]
        log(f"fusion A/B at ctx={ab_ctx} (interleaved, n=3): fused prefill {ft * 1e3:.1f}ms vs "
            f"unfused {ut * 1e3:.1f}ms ({ut / ft:.3f}x gain from fusion)")
        ab = {"ctx": ab_ctx, "fused": fused.summary(), "unfused": unfused.summary(),
              "gain": ut / ft}

    # Batch-1 decode reads every weight and the whole cache each step: the
    # speedup's ceiling is the ratio of those bytes
    wb = weight_bytes(params)
    bytes_full, bytes_fast = wb + rf["cache_bytes"], wb + rk["cache_bytes"]
    ceiling = bytes_full / bytes_fast
    read_gbs = {name: (wb + r["cache_bytes"]) * (genlen - 1) / r["decode_s"] / 1e9
                for name, r in (("fullkv", rf), ("fastkv", rk))}
    log(f"roofline: weights {wb / 1e9:.2f} GB; cache fullkv {rf['cache_bytes'] / 1e9:.2f} GB, "
        f"fastkv {rk['cache_bytes'] / 1e9:.2f} GB -> bytes/token {bytes_full / 1e9:.2f} vs "
        f"{bytes_fast / 1e9:.2f} GB, speedup ceiling {ceiling:.2f}x")
    log(f"roofline: measured {speedup:.2f}x = {speedup / ceiling:.0%} of ceiling; implied read "
        f"GB/s fullkv {read_gbs['fullkv']:.0f}, fastkv {read_gbs['fastkv']:.0f} "
        + ("(a CPU run: no device rate)" if cpu else f"(card peak {PEAK_BYTES / 1e9:.0f} GB/s)"))

    counters_zero = None if cpu else decode_attn.counters_at_rest()
    metric = (f"fastkv_vs_fullkv_decode_speedup_ctx{ctx}_{cfg.name}"
              + ("_int8w" if quant_mode == "int8" else "")
              + ("_int8kv" if ecfg_kw.get("kv_int8") else ""))
    details = {
        "ctx": ctx, "metric": metric, "model": cfg.name, "num_layers": cfg.num_layers,
        "tsp_idx": fast.mcfg.tsp_idx, "genlen": genlen,
        "runs": runs, "quant": quant_mode, "kv_int8": bool(ecfg_kw.get("kv_int8")),
        "device": dev.type, "gpu": gpu, "fullkv": rf, "fastkv": rk,
        "decode_speedup": speedup, "decode_speedup_of_medians": speedup_median,
        "prefill_ratio": prefill_ratio,
        "prefill_ratio_of_medians": rf["prefill_median_s"] / rk["prefill_median_s"],
        "fusion_ab": ab, "weight_bytes": wb, "bytes_per_token": {"fullkv": bytes_full,
                                                               "fastkv": bytes_fast},
        "speedup_ceiling": ceiling, "implied_read_gbs": read_gbs,
        "peak_bytes_per_s": PEAK_BYTES, "launches": launch_counts(),
        "decode_counters_zero": counters_zero,
    }
    log(json.dumps({RECORD_KEY: details}))
    print(json.dumps({"metric": metric, "value": round(speedup, 3), "unit": "x",
                      "vs_baseline": round(speedup / REF_DECODE_SPEEDUP, 3)}), flush=True)
    return details


def ladder() -> Tuple[int, ...]:
    if cpu_smoke():
        return CPU_LADDER
    if os.environ.get("FASTKV_BENCH_LADDER"):
        return tuple(int(x) for x in os.environ["FASTKV_BENCH_LADDER"].split(",") if x)
    env_ctx = os.environ.get("FASTKV_BENCH_CTX")
    if env_ctx:
        c = int(env_ctx)
        return (c,) + tuple(x for x in DEFAULT_LADDER if x < c)
    return DEFAULT_LADDER


def run_rung_process(ctx: int, timeout: float) -> Tuple[int, str]:
    """One rung as ``python -m fastkv_tpu_torch.bench.headline --rung ctx`` from
    this checkout (its root as the working directory and first on
    PYTHONPATH); stderr passes through. Returns (exit code, stdout); raises
    ``subprocess.TimeoutExpired`` after killing a child that overran."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (str(ROOT), env.get("PYTHONPATH")) if p)
    r = subprocess.run([sys.executable, "-m", "fastkv_tpu_torch.bench.headline", "--rung",
                        str(ctx)], cwd=ROOT, env=env, stdout=subprocess.PIPE, timeout=timeout)
    return r.returncode, r.stdout.decode()


def metric_line(stdout: str) -> Optional[str]:
    """The last JSON line with a ``metric`` key."""
    found = None
    for line in stdout.splitlines():
        line = line.strip()
        if line.startswith("{"):
            try:
                if "metric" in json.loads(line):
                    found = line
            except json.JSONDecodeError:
                pass
    return found


def main(argv=None, run_child: Optional[Callable[[int, float], Tuple[int, str]]] = None) -> str:
    """The ladder: one child per rung, largest first; prints and returns the
    first completed rung's JSON line. ``--rung N`` runs one rung in this
    process. ``run_child(ctx, timeout) -> (exit code, stdout)`` runs a rung
    (by default ``run_rung_process``)."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) >= 2 and argv[0] == "--rung":
        run_rung(int(argv[1]))
        return ""
    if run_child is None:
        if not cpu_smoke():
            from fastkv_tpu_torch.core.device import resolve_device

            resolve_device("cuda")  # no card: raise here, not once a rung
        run_child = run_rung_process
    rungs = ladder()
    timeout = float(os.environ.get("FASTKV_BENCH_RUNG_TIMEOUT", "2400"))
    for rung in rungs:
        log(f"=== ladder rung ctx={rung} (subprocess, timeout {timeout:.0f}s) ===")
        try:
            rc, out = run_child(rung, timeout)
        except subprocess.TimeoutExpired:
            log(f"ctx={rung}: rung timed out; dropping one ladder rung")
            continue
        result = metric_line(out)
        if rc == 0 and result:
            print(result, flush=True)
            return result
        log(f"ctx={rung}: rung failed (rc={rc}); dropping one ladder rung")
    raise RuntimeError(f"every ladder rung failed: {rungs}")


if __name__ == "__main__":
    main()
