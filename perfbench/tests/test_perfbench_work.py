"""The yardstick: shares read 100% at their bound, bucket padding is no
work, and the window caps a sliding-window model's pairs."""

import json
from pathlib import Path

import pytest

from perfbench import work

ROOT = Path(__file__).resolve().parents[2]
NEMO = json.loads((ROOT / "perfbench/configs/mistral-nemo-12b.json").read_text())
MINISTRAL = json.loads((ROOT / "perfbench/configs/ministral-8b.json").read_text())


@pytest.mark.parametrize("flops,nbytes", [(1e12, 1e6), (1e6, 1e10), (9.89e14, 3.35e12)])
def test_share_is_100_at_the_bound(flops, nbytes):
    least = work.least_seconds(flops, nbytes)
    assert least == max(flops / work.PEAK_BF16_FLOPS, nbytes / work.PEAK_BYTES)
    assert work.share(least, least) == pytest.approx(100.0)
    assert work.share(least, 2 * least) == pytest.approx(50.0)
    assert work.share(least, 0.0) is None


@pytest.mark.parametrize("conf", [NEMO, MINISTRAL], ids=["nemo", "ministral"])
def test_padding_adds_no_work(conf):
    """The work depends on the true prompt only: a prompt of n tokens needs
    the same FLOPs whatever bucket it is padded to (no bucket enters), and
    one more token needs more."""
    m, meth = conf["model"], conf["method"]
    for n in (16385, 30000, 40000):
        assert work.prefill_flops(m, meth, n) < work.prefill_flops(m, meth, n + 1)
        calls = work.flash_calls(m, meth, n)
        assert len(calls) == m["num_hidden_layers"]
    # a FastKV prefill needs fewer FLOPs than FullKV's at the same n
    full = dict(meth, method="fullkv")
    assert work.prefill_flops(m, meth, 32768) < work.prefill_flops(m, full, 32768)


def test_window_caps_pairs():
    W = MINISTRAL["model"]["sliding_window"]
    assert work.flash_pairs(1000) == 1000 * 1001 // 2
    assert work.flash_pairs(1000, W) == work.flash_pairs(1000)
    s = 65536
    assert work.flash_pairs(s, W) == W * (W + 1) // 2 + (s - W) * W
    assert work.flash_pairs(s, W) < work.flash_pairs(s)
    # brute force on a small case: query i sees keys (i - w, i]
    for t, w in ((50, 7), (50, 50), (50, 80)):
        assert work.flash_pairs(t, w) == sum(min(i + 1, w) for i in range(t))
    # Ministral's attention work at 65536 is the window's, not the square's
    m, meth = MINISTRAL["model"], MINISTRAL["method"]
    f_win = work.flash_calls(m, meth, s)[0][0]
    assert f_win == 4 * 128 * 32 * (W * (W + 1) // 2 + (s - W) * W)


def test_budgets_and_kept_slots():
    meth = NEMO["method"]
    n = 32768
    assert work.floor_rate(n, 0.1) == 3276
    c = work.tsp_count(n, meth["tsp_rate"], meth["window_size"])
    assert c == 6553
    kept = work.kept_per_layer(NEMO["model"], meth, n)
    assert kept[:meth["tsp_idx"] + 1] == [3276] * (meth["tsp_idx"] + 1)
    assert kept[-1] == work.keep_budget(c, 0.5, 8) + 8


def test_decode_step_work_reads_the_weights_once():
    m = NEMO["model"]
    f, b = work.decode_step_work(m, [0] * m["num_hidden_layers"])
    weights = m["num_hidden_layers"] * work.layer_params(m) + m["hidden_size"] * m["vocab_size"]
    assert b == 2 * (weights + m["hidden_size"])
    assert f == 2 * weights
    f2, b2 = work.decode_step_work(m, [8 * 1000] * m["num_hidden_layers"])
    assert b2 - b == 2 * 2 * 128 * 8 * 1000 * m["num_hidden_layers"]
    assert work.decode_attn_bytes(m, [8 * 1000]) == 2 * 128 * (2 * 32 + 2 * 8000)
