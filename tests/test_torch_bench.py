"""The port's latency and throughput CLIs on the CPU (tiny preset, random
weights): the latency records carry the JAX CLI's JSON keys in both modes,
every method's path runs (GemFilter's two passes, PyramidInfer's own
generate), the throughput ladder runs in process, and the profiling
helpers count at the H100's peaks."""

import json

import pytest
import torch

from fastkv_tpu.bench import latency as j_latency
from fastkv_tpu_torch.bench import latency as t_latency
from fastkv_tpu_torch.bench import throughput as t_throughput
from fastkv_tpu_torch.utils.testing import one_thread_per_module

_one_torch_thread = one_thread_per_module()

COMMON = ["--preset", "tiny", "--random_weights", "--context_lengths", "128",
          "--genlen", "4", "--runs", "2", "--dtype", "float32"]


@pytest.fixture(scope="module")
def jax_keys(tmp_path_factory):
    """Each mode's record keys from the JAX CLI, on the same settings."""
    out = {}
    for mode in ("prefill", "e2e"):
        save = str(tmp_path_factory.mktemp(f"jax_{mode}"))
        j_latency.main([mode, *COMMON, "--tsp_idx", "1", "--no_pallas", "--save_dir", save])
        with open(f"{save}/{mode}_tiny_fastkv.txt") as f:
            out[mode] = set(json.loads(f.readline())) - {"method"}
    return out


@pytest.mark.parametrize("method,extra", [
    ("fastkv", ["--tsp_idx", "1"]),
    ("fullkv", []),
    ("gemfilter", ["--filter_idx", "1"]),
    ("pyramidinfer", []),
])
@pytest.mark.parametrize("mode", ["prefill", "e2e"])
def test_latency_records_have_the_jax_keys(jax_keys, tmp_path, capsys, mode, method, extra):
    res = t_latency.main([mode, *COMMON, "--method", method, "--device", "cpu",
                          "--save_dir", str(tmp_path), *extra])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == res and len(res) == 1
    rec = res[0]
    assert set(rec) == jax_keys[mode]
    assert rec["context"] == 128 and rec["peak_mem"] is None  # no card
    times = [rec["mean_s"]] if mode == "prefill" else [rec["prefill_mean_s"], rec["decode_mean_s"]]
    assert all(t > 0 for t in times)
    with open(tmp_path / f"{mode}_tiny_{method}.txt") as f:
        assert json.loads(f.readline()) == {"method": method, **rec}


def test_latency_trace_and_phase_log(tmp_path):
    trace, jsonl = tmp_path / "trace", tmp_path / "phases.jsonl"
    res = t_latency.main(["e2e", *COMMON, "--runs", "1", "--tsp_idx", "1", "--device", "cpu",
                          "--save_dir", str(tmp_path), "--trace", str(trace),
                          "--jsonl", str(jsonl)])
    rec = json.loads(jsonl.read_text())
    assert rec["phase"] == "e2e" and rec["method"] == "fastkv" and rec["model"] == "tiny"
    assert {k: rec[k] for k in res[0]} == res[0]
    assert json.loads((trace / "trace.json").read_text())["traceEvents"]


def test_latency_caps_h2o_at_8192(tmp_path):
    args = ["prefill", "--preset", "tiny", "--random_weights", "--dtype", "float32",
            "--method", "h2o", "--runs", "1", "--device", "cpu", "--save_dir", str(tmp_path)]
    assert t_latency.main(args + ["--context_lengths", "8320"]) == []
    assert len(t_latency.main(args + ["--context_lengths", "256"])) == 1


def test_throughput_ladder_in_process(capsys):
    t_throughput.run(["--no_subprocess", "--device", "cpu", "--preset", "tiny", "--ctx", "128",
                      "--genlen", "4", "--runs", "1", "--batches", "1", "3",
                      "--methods", "fullkv", "fastkv", "--dtype", "float32"])
    err = capsys.readouterr().err
    for method in ("fullkv", "fastkv"):
        for b in (1, 3):
            assert f"[{method}] B={b}: " in err
        # the plain versions run on the CPU: no kernel launches
        assert f"[{method}] kernel launches: flash_prefill 0, decode_attn 0" in err
    assert "peak serving throughput ctx=128: fullkv" in err
    # batch 1 decodes what Engine.generate does for the same request and weights
    from fastkv_tpu_torch.core.config import EngineConfig, Method, MethodConfig, ModelConfig
    from fastkv_tpu_torch.engine.generate import Engine
    from fastkv_tpu_torch.models.llama import init_params

    cfg = ModelConfig.tiny(dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for method in ("fullkv", "fastkv"):
        mcfg = MethodConfig(method=Method(method), eviction_mode="proportional",
                            retain_rate=0.1, tsp_rate=0.2,
                            tsp_idx=min(max(1, cfg.num_layers // 2 - 1), cfg.num_layers - 2))
        eng = Engine(params, cfg, mcfg, EngineConfig(prefill_buckets=(128,), max_new_tokens=4),
                     device="cpu")
        want = " ".join(map(str, eng.generate([[1] * 128], 4)[0]))
        assert f"[{method}] B=1 tokens {want}\n" in err


def test_profiling_helpers_use_the_h100_peaks(capsys):
    from fastkv_tpu_torch.kernels.timing import PEAK_BF16_FLOPS, PEAK_BYTES, flash_work
    from fastkv_tpu_torch.utils import profiling, timing

    r = profiling.attention_prefill_roofline(1e-3, s=8192, d=128, num_heads=32, num_kv_heads=8)
    assert r.flops == 32 * 4 * 128 * (8192 * 8193 // 2)  # the causal pairs, diagonal included
    assert r.bytes_moved == 2 * 128 * 8192 * (32 + 2 * 8 + 32) + 8 * 8192
    assert r.ideal_seconds == max(r.flops / PEAK_BF16_FLOPS, r.bytes_moved / PEAK_BYTES)
    assert r.compute_bound and r.report()["bound"] == "compute"
    # a count below s, counted as chip_smoke.py counts it
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((2, 4, 96, 64), generator=gen).to(torch.bfloat16)
    k = torch.randn((2, 2, 96, 64), generator=gen).to(torch.bfloat16)
    pos = torch.arange(96, dtype=torch.int32).expand(2, 96)
    cnt = torch.tensor([70, 70], dtype=torch.int32)
    r = profiling.attention_prefill_roofline(1e-3, s=96, d=64, num_heads=4, num_kv_heads=2,
                                             b=2, count=70)
    assert (r.flops, r.bytes_moved) == flash_work(q, k, k, pos, cnt)
    assert profiling.peak_bytes("cpu") is None and profiling.memory_stats("cpu") is None
    rec = profiling.PhaseLogger().log("prefill", s=3)
    assert json.loads(capsys.readouterr().err) == rec and rec["s"] == 3
    assert timing.force((torch.ones(3), None)) == 3.0
