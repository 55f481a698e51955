"""The harness takes new cells as data: a throwaway configuration, two mixes,
limits and a new per-layer metric written under a temporary directory run by
name, on the CPU (the dry mode: ``run.run(device="cpu")``, which no card
run takes). And the command exits without a result where the program is
missing, and where there is no card."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import run
from perfbench.tests import cells

METRIC = '''"""test.requests_done: the number of requests the window finished."""


def read(rec):
    return float(sum(r.end is not None for r in rec["requests"]))
'''


@pytest.mark.parametrize("cell", ["tiny-closed", "tiny-open"])
@pytest.mark.parametrize("trace", [0, 1])
def test_new_cell_runs_by_name(tmp_path, cell, trace):
    root = cells.write(tmp_path, "test.requests_done", METRIC)
    res = run.run(root, cell, 2**31 + 17, 3.0, bool(trace), device="cpu", log=lambda m: None)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 2 and res["failed"] == 0
    assert list(res)[-2:] == ["checks", "loaded"]  # ``loaded`` is popped before printing
    assert res["loaded"] == []
    m = res["metrics"]
    if trace:
        assert m["test.requests_done"]["value"] == float(res["attempted"])
        want = "step.mfu.prefill" if cell == "tiny-closed" else "sched.decode_gap_ms.serve"
        assert want in m
    else:
        closed = {"ttft_s", "tpot_ms", "setup_s"}
        served = {"ttft_s.serve", "tpot_ms", "itl_p95_ms", "setup_s"}
        assert set(m) == (closed if cell == "tiny-closed" else served)
    for name, c in res["checks"].items():
        assert c["value"] <= c["limit"], name


def test_same_seed_same_inputs():
    from perfbench import traffic

    mix = cells.MIXES["t-open"]
    a = traffic.open_schedule(mix, 2**33 + 5, 256, 10.0)
    b = traffic.open_schedule(mix, 2**33 + 5, 256, 10.0)
    c = traffic.open_schedule(mix, 2**33 + 6, 256, 10.0)
    assert a == b and a != c
    # every seed: the same sizes and gaps, in another order
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt) for r in c)
    assert sorted(r.new_tokens for r in a) == sorted(r.new_tokens for r in c)
    assert abs(a[-1].due_s - c[-1].due_s) < 10.0
    closed = cells.MIXES["t-closed"]
    it = traffic.closed_requests(closed, 9, 256)
    first = [len(next(it).prompt) for _ in range(closed["strata"])]
    assert sorted(first) == traffic.sizes(closed["prompt"], closed["strata"])


def _command(root, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-m", "perfbench.run", *args], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_result_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    shutil.copy(cells.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(cells.REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cell = json.loads((cells.REPO / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    out = _command(tmp_path, "--workload", cell, "--seed", "1", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_no_result_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cell = json.loads((cells.REPO / "BENCHMARK.json").read_text())["workloads"][0]["name"]
    out = _command(cells.REPO, "--workload", cell, "--seed", "1", "--seconds", "1",
                   "--trace", "0")
    assert out.returncode == 2 and out.stdout.strip() == ""


def test_sweep_repeats_rates_and_reads_the_cells_metrics(tmp_path):
    """The knee sweep (``perfbench/sweep.py``) on the tiny open cell: a
    line per rate, each with the cell's own end-to-end metrics."""
    from perfbench import sweep

    root = cells.write(tmp_path)
    lines = []
    sweep.sweep(root, "tiny-open", 2**31 + 5, 0.5, [10.0, 20.0, 10.0], "cpu", lines.append)
    assert [(o["rate_per_s"], o["seed"]) for o in lines] == [
        (10.0, 2**31 + 5), (20.0, 2**31 + 5), (10.0, 2**31 + 5)]
    for o in lines:
        assert o["arrivals"] == o["finished"] == round(o["rate_per_s"] * 0.5)
        assert {"ttft_s.serve", "tpot_ms", "itl_p95_ms"} <= set(o)
    with pytest.raises(ValueError):
        sweep.sweep(root, "tiny-closed", 1, 0.5, [1.0], "cpu", lines.append)
