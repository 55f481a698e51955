"""The port's headline benchmark (``fastkv_tpu_torch.bench.headline``) against
the repository's ``bench.py`` on the CPU (``FASTKV_BENCH_CPU=1``: the tiny
config, 4 layers, context 512, 16 new tokens): the CPU smoke through ``main``
as one subprocess prints bench.py's one JSON line with bench.py's metric
name; the records carry bench.py's keys and its cache bytes on the same
weights; the weight bytes (bf16, int8 with scales) equal the JAX trees', so
both scripts log the same roofline ceiling; a rung that fails or times out
drops one rung, and a ladder of failing rungs raises; without a card and
without the CPU switch the benchmark raises."""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from fastkv_tpu.core.config import ModelConfig as JModelConfig
from fastkv_tpu.models import llama as j_llama
from fastkv_tpu_torch.bench import headline
from fastkv_tpu_torch.core.config import ModelConfig
from fastkv_tpu_torch.models import llama as t_llama
from fastkv_tpu_torch.utils.testing import one_thread_per_module

_one_torch_thread = one_thread_per_module()

ROOT = Path(__file__).resolve().parents[1]
LINE_KEYS = {"metric", "value", "unit", "vs_baseline"}
RECORD_KEYS = {"prefill_s", "decode_s", "tok_s", "peak_mem", "cache_bytes"}
CPU_ENV = {"FASTKV_BENCH_CPU": "1", "FASTKV_BENCH_RUNS": "1"}


def _bench_py():
    spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_bytes(tree) -> int:
    return sum(x.size * x.dtype.itemsize for x in jax.tree_util.tree_leaves(tree))


@pytest.fixture(scope="module")
def jax_rung():
    """bench.py's ``run_rung(512)`` on the CPU under CPU_ENV: its JSON line and
    the record its ``bench_method`` returned for each method."""
    bench = _bench_py()
    records = {}
    inner = bench.bench_method

    def spy(method_name, *a, **kw):
        records[method_name] = inner(method_name, *a, **kw)
        return records[method_name]

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        for k, v in CPU_ENV.items():
            mp.setenv(k, v)
        mp.setattr(bench, "bench_method", spy)
        with contextlib.redirect_stdout(out):
            bench.run_rung(512)
    return json.loads(headline.metric_line(out.getvalue())), records


@pytest.fixture(scope="module")
def port_smoke():
    """``python -m fastkv_tpu_torch.bench.headline`` under CPU_ENV: its main,
    which runs the one CPU rung as a child of its own, on one intra-op thread
    as this module's own CPU work."""
    env = {**os.environ, **CPU_ENV, "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-m", "fastkv_tpu_torch.bench.headline"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=900)
    details = [json.loads(ln)[headline.RECORD_KEY] for ln in r.stderr.splitlines()
               if ln.startswith("{") and headline.RECORD_KEY in ln]
    return r, details


def test_cpu_smoke_prints_one_line_with_the_bench_keys(port_smoke):
    r, _ = port_smoke
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == LINE_KEYS
    assert line["unit"] == "x" and line["value"] > 0
    assert abs(line["vs_baseline"] - line["value"] / headline.REF_DECODE_SPEEDUP) <= 1e-3


def test_cpu_smoke_metric_equals_bench_py(port_smoke, jax_rung):
    r, _ = port_smoke
    j_line, _ = jax_rung
    assert set(j_line) == LINE_KEYS
    assert json.loads(r.stdout.strip())["metric"] == j_line["metric"]


def test_cpu_smoke_rung_details(port_smoke):
    """The rung's details line: one completed rung at 512, every method's run
    counted (a warm run and FASTKV_BENCH_RUNS timed ones; the fusion A/B's
    arms prefill only), no kernel launched on the CPU."""
    _, details = port_smoke
    [d] = details
    assert d["ctx"] == 512 and d["device"] == "cpu" and d["gpu"] is None
    assert d["tsp_idx"] == 1 and d["genlen"] == 16 and d["runs"] == 1
    for name in ("fullkv", "fastkv"):
        m = d[name]
        assert RECORD_KEYS <= set(m) and m["peak_mem"] is None
        assert m["prefills"] == m["decodes"] == 2
        assert len(m["prefill_times_s"]) == len(m["decode_times_s"]) == 1
    for arm in ("fused", "unfused"):
        assert d["fusion_ab"][arm]["prefills"] == 4 and d["fusion_ab"][arm]["decodes"] == 0
    assert set(d["launches"].values()) == {0} and d["decode_counters_zero"] is None
    assert d["speedup_ceiling"] == pytest.approx(
        d["bytes_per_token"]["fullkv"] / d["bytes_per_token"]["fastkv"])


@pytest.mark.parametrize("method", ["fullkv", "fastkv"])
def test_cache_bytes_equal_bench_py(jax_rung, monkeypatch, method):
    """bench_method on the JAX script's weights (its seed, carried over by
    params_from_numpy) returns bench.py's keys and its cache bytes."""
    _, j_records = jax_rung
    for k, v in CPU_ENV.items():
        monkeypatch.setenv(k, v)
    jcfg = JModelConfig.tiny(num_layers=4)
    tree = jax.tree_util.tree_map(np.asarray, j_llama.init_params_on_device(jcfg, seed=0))
    cfg = ModelConfig.tiny(num_layers=4)
    params = t_llama.params_from_numpy(cfg, tree, device="cpu")
    rec = headline.bench_method(method, cfg, params, 512, 16, dict(capacity_align=8))
    assert set(rec) == set(j_records[method]) == RECORD_KEYS
    assert rec["cache_bytes"] == j_records[method]["cache_bytes"]
    assert rec["prefill_s"] > 0 and rec["decode_s"] > 0 and rec["peak_mem"] is None


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_weight_bytes_equal_jax(quant):
    """The weights' bytes the roofline counts equal bench.py's leaf sum over
    the JAX tree of the same config: bf16, and int8 with its scales."""
    jcfg = JModelConfig.tiny(num_layers=4, dtype="bfloat16")
    cfg = ModelConfig.tiny(num_layers=4, dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    if quant == "int8":
        jtree = j_llama.init_params_int8_on_device(jcfg, seed=0)
        params = t_llama.init_params_int8(cfg, gen, device="cpu")
    else:
        jtree = j_llama.init_params_on_device(jcfg, seed=0)
        params = t_llama.init_params(cfg, gen, device="cpu")
    assert headline.weight_bytes(params) == _jax_bytes(jtree)


def _line(ctx):
    return json.dumps({"metric": f"m{ctx}", "value": 1.5, "unit": "x", "vs_baseline": 0.523})


def _child(outcomes):
    """A rung runner: ctx -> 'ok', 'fail' (exit 1), 'silent' (exit 0 without a
    line) or 'timeout'; records the rungs it was asked for."""
    calls = []

    def run(ctx, timeout):
        calls.append(ctx)
        kind = outcomes[ctx]
        if kind == "timeout":
            raise subprocess.TimeoutExpired(cmd=["rung", str(ctx)], timeout=timeout)
        if kind == "fail":
            return 1, ""
        return 0, ("" if kind == "silent" else "noise\n" + _line(ctx) + "\n")

    return run, calls


@pytest.fixture
def ladder_env(monkeypatch):
    monkeypatch.delenv("FASTKV_BENCH_CPU", raising=False)
    monkeypatch.delenv("FASTKV_BENCH_CTX", raising=False)
    monkeypatch.setenv("FASTKV_BENCH_LADDER", "300,200,100")
    monkeypatch.setenv("FASTKV_BENCH_RUNG_TIMEOUT", "5")


@pytest.mark.parametrize("kind", ["fail", "timeout", "silent"])
def test_a_failed_rung_drops_one_rung(ladder_env, capsys, kind):
    run, calls = _child({300: kind, 200: "ok", 100: "ok"})
    assert headline.main([], run_child=run) == _line(200)
    assert calls == [300, 200]
    assert capsys.readouterr().out.strip() == _line(200)


def test_every_rung_failing_raises(ladder_env, capsys):
    run, calls = _child({300: "fail", 200: "timeout", 100: "silent"})
    with pytest.raises(RuntimeError, match="every ladder rung failed"):
        headline.main([], run_child=run)
    assert calls == [300, 200, 100]
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("env,want", [
    ({}, headline.DEFAULT_LADDER),
    ({"FASTKV_BENCH_CTX": "180000"}, (180000, 163840, 131072)),
    ({"FASTKV_BENCH_CTX": "131072"}, (131072,)),
    ({"FASTKV_BENCH_LADDER": "49152,40960,"}, (49152, 40960)),
    ({"FASTKV_BENCH_CPU": "1", "FASTKV_BENCH_CTX": "131072"}, (512,)),
])
def test_ladder_from_env(monkeypatch, env, want):
    for k in ("FASTKV_BENCH_CPU", "FASTKV_BENCH_CTX", "FASTKV_BENCH_LADDER"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert headline.ladder() == want


@pytest.mark.parametrize("entry", ["main", "run_rung"])
def test_without_a_card_it_raises(monkeypatch, entry):
    """Without FASTKV_BENCH_CPU=1 the benchmark runs on the card or raises:
    main before it starts a child, a rung before it makes its weights."""
    monkeypatch.delenv("FASTKV_BENCH_CPU", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        if entry == "main":
            headline.main([])
        else:
            headline.run_rung(512)
