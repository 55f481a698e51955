"""PyramidInfer retain-rate calibration.

Port of ``fastkv_tpu.bench.calibrate``: for each sequence length and
candidate ``prefill_decay_ratio``, the achieved average retain rate (the mean
over layers of each layer's cache length over the prompt length), so that a
decay ratio can be picked for a target budget. The pyramid's schedule is a
pure function of (sequence length, config) (``engine.pyramid.
plan_layer_lengths``), so the answer is analytic; ``--empirical`` also runs
the port's prefill on random weights (on the card unless ``--device cpu`` is
given) and counts the valid cache entries, a cross-check that differs only
by the static ``capacity_align`` rounding.

Usage:
  python3 -m fastkv_tpu_torch.bench.calibrate --model llama-3.2-1b \\
      --seqlens 1000 2000 4000 --decay_ratios 0.01 0.3 0.7 \\
      [--config fastkv_tpu_torch/configs/pyramidinfer/llama_60.json] \\
      [--empirical [--device cpu]]
"""

from __future__ import annotations

import argparse
import dataclasses

from fastkv_tpu_torch.core.config import (
    MODEL_PRESETS,
    EngineConfig,
    Method,
    MethodConfig,
    ModelConfig,
)
from fastkv_tpu_torch.engine import pyramid


def analytic_retain_rate(
    cfg: ModelConfig, mcfg: MethodConfig, seq_len: int, align: int = 1
) -> float:
    """Mean over layers of (per-layer cache length / seq_len). align=1 is the
    reference's dynamic shapes; the engine's static plan rounds up to
    ``capacity_align``, so its retain rate is at least this one."""
    lengths = pyramid.plan_layer_lengths(cfg, mcfg, seq_len, align=align)
    # layer l's cache is its input sequence: lengths[0..L-1]
    return sum(lengths[: cfg.num_layers]) / (cfg.num_layers * seq_len)


def empirical_retain_rate(
    cfg: ModelConfig, mcfg: MethodConfig, seq_len: int, align: int, device="cuda"
) -> float:
    """Run the port's prefill of a ones-prompt (random weights from seed 0)
    and count the valid cache entries."""
    import torch

    from fastkv_tpu_torch.core.device import resolve_device
    from fastkv_tpu_torch.engine import prefill as prefill_mod
    from fastkv_tpu_torch.models.llama import init_params

    dev = resolve_device(device)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    ecfg = EngineConfig(prefill_buckets=(seq_len,), max_new_tokens=8, capacity_align=align)
    shapes = prefill_mod.plan_shapes(cfg, mcfg, ecfg, seq_len)
    tokens = torch.ones((1, seq_len), dtype=torch.int32, device=dev)
    n = torch.tensor([seq_len], dtype=torch.int32, device=dev)
    with torch.inference_mode():
        _, cache = prefill_mod.prefill(params, cfg, mcfg, shapes, tokens, n, ecfg)
    counts = cache.valid[:, 0, 0, :].sum(dim=-1).double()
    return float(counts.mean() / seq_len)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", default="llama-3.1-8b", choices=sorted(MODEL_PRESETS))
    ap.add_argument("--config", default=None,
                    help="reference-format pyramidinfer config JSON")
    ap.add_argument("--seqlens", type=int, nargs="+", default=[1000, 2000, 3000, 4000])
    ap.add_argument("--decay_ratios", type=float, nargs="+", default=[0.01])
    ap.add_argument("--empirical", action="store_true")
    ap.add_argument("--capacity_align", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="where --empirical runs the prefill (cuda, or cpu)")
    args = ap.parse_args(argv)

    cfg = MODEL_PRESETS[args.model]()
    mcfg = MethodConfig(method=Method.PYRAMIDINFER)
    if args.config:
        mcfg = mcfg.with_pyramidinfer_json(args.config)

    for seq_len in args.seqlens:
        for dr in args.decay_ratios:
            m = dataclasses.replace(mcfg, pyramid_decay_ratio=dr)
            rate = analytic_retain_rate(cfg, m, seq_len) * 100
            line = (f"seqlen={seq_len}, prefill_decay_ratio={dr}, "
                    f"retain_rate={rate:.2f}%")
            if args.empirical:
                emp = empirical_retain_rate(cfg, m, seq_len, args.capacity_align,
                                            args.device) * 100
                line += f", measured={emp:.2f}% (align={args.capacity_align})"
            print(line)


if __name__ == "__main__":
    main()
