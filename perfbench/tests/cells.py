"""A throwaway benchmark at a size a CPU test holds: a tiny Mistral-family
configuration (float32), a closed and an open mix, limits for both, and the
metric readers, written under a temporary directory as a later PR would add
them: as files found by name."""

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY = {
    "name": "tiny", "source": "a test configuration", "reference": "mistral", "dtype": "float32",
    "model": {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 4,
              "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
              "vocab_size": 256, "rope_theta": 10000.0, "rms_norm_eps": 1e-5,
              "sliding_window": None, "max_position_embeddings": 4096,
              "tie_word_embeddings": False, "initializer_range": 0.3},
    "method": {"method": "fastkv", "eviction_mode": "proportional", "retain_rate": 0.1,
               "tsp_rate": 0.2, "tsp_idx": 1, "window_size": 8, "kernel_size": 7,
               "pooling": "maxpool"},
    "reduced": []}

MIXES = {
    "t-closed": {"loop": "closed", "prompt": {"dist": "uniform", "lo": 300, "hi": 500},
                 "new_tokens": {"dist": "fixed", "value": 12}, "strata": 4,
                 "engine": {"prefill_buckets": [512], "capacity_align": 8},
                 "check_requests": 100},
    "t-open": {"loop": "open", "rate_per_s": 30.0,
               "prompt": {"dist": "lognormal", "median": 200, "sigma": 0.8, "lo": 64, "hi": 512},
               "new_tokens": {"dist": "lognormal", "median": 12, "sigma": 0.6, "lo": 4, "hi": 32},
               "engine": {"prefill_chunk": 64, "capacity_align": 8},
               "scheduler": {"max_batch": 4, "bucket": 512, "max_new_tokens": 32},
               "check_requests": 100}}

# weights drawn wider than a real model's, so that attention is peaked and
# the logits spread at this size. The float32 program agrees with the
# float32 reference to ~1e-5 in the logits; the limits of the tiny cells
# sit between that and the float8 control
LIMITS = {"logit_gap": 1e-3, "keep_regret": 1e-4, "tsp_regret": 1e-4,
          "set_misses": 0, "token_misses": 0}


def bench(extra_metric: str = "", sliding_window=None) -> dict:
    cells = [{"name": f"tiny-{m[2:]}", "config": "tiny", "traffic": m, "chips": 1, "why": "a test"}
             for m in MIXES]
    per_layer = [
        {"name": "step.mfu.prefill", "unit": "%", "better": "higher", "source": "host_clock",
         "layer": "model step", "moves": "ttft_s", "workloads": ["tiny-closed"]},
        {"name": "sched.decode_gap_ms.serve", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "scheduler", "moves": "tpot_ms",
         "workloads": ["tiny-open"]}]
    if extra_metric:
        per_layer.append({"name": extra_metric, "unit": "1", "better": "higher",
                          "source": "host_clock", "layer": "test", "moves": "ttft_s"})
    return {"command": ["python3", "-m", "perfbench.run"], "paths": ["perfbench"],
            "run_seconds": 10,
            "configs": [{"name": "tiny", "source": "a test", "file": "perfbench/configs/tiny.json",
                         "reduced": [], "why": "a test"}],
            "workloads": cells,
            "end_to_end": [
                {"name": "ttft_s", "unit": "s", "better": "lower", "bound": 0.1,
                 "source": "host_clock", "workloads": ["tiny-closed"]},
                {"name": "ttft_s.serve", "unit": "s", "better": "lower", "bound": 0.1,
                 "source": "host_clock", "workloads": ["tiny-open"]},
                {"name": "tpot_ms", "unit": "ms/token", "better": "lower", "bound": 0.1,
                 "source": "host_clock"},
                {"name": "itl_p95_ms", "unit": "ms", "better": "lower", "bound": 0.1,
                 "source": "host_clock", "workloads": ["tiny-open"]},
                {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
                 "source": "host_clock"}],
            "per_layer": per_layer}


def write(root: Path, extra_metric: str = "", metric_source: str = "",
          sliding_window=None) -> Path:
    """The throwaway benchmark under ``root``; returns root."""
    pb = root / "perfbench"
    for sub in ("configs", "traffic", "limits"):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(REPO / "perfbench" / "metrics", pb / "metrics", dirs_exist_ok=True)
    conf = json.loads(json.dumps(TINY))
    conf["model"]["sliding_window"] = sliding_window
    (pb / "configs" / "tiny.json").write_text(json.dumps(conf))
    for name, mix in MIXES.items():
        (pb / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    (pb / "limits" / "tiny-closed.json").write_text(json.dumps(dict(LIMITS, decode_misses=0)))
    (pb / "limits" / "tiny-open.json").write_text(json.dumps(LIMITS))
    if extra_metric:
        (pb / "metrics" / f"{extra_metric}.py").write_text(metric_source)
    (root / "BENCHMARK.json").write_text(json.dumps(bench(extra_metric)))
    return root
