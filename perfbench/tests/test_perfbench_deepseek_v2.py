"""DeepSeek-V2 in the benchmark, on the CPU at a tiny size: its architecture
module's counts against values worked out by hand at the published widths,
its weights in the program's layout, the reference against the program,
the float8 control against the reference, and each of ``perfbench.faults``
found by the check. The tiny cells are ``cells.py``'s, with a tiny
DeepSeek-V2 configuration in the place of the Mistral one (1 dense + 3
expert layers of 8 experts, top 2, 1 shared; q/k 24, v 12, latent 32;
weights drawn at std 0.3 so that attention is peaked at this size)."""

import json

import pytest
import torch

from fastkv_tpu_torch.utils.testing import one_thread_per_module
from perfbench import check, control, faults, run, work
from perfbench.arch import deepseek_v2 as arch
from perfbench.reference import deepseek_v2 as ref
from perfbench.tests import cells

# the open cell's drain waits at most run.DRAIN_S: with torch's thread a
# core beside other test workers its tiny run took 20-60 s, on one 6 s
_one_torch_thread = one_thread_per_module()
PUBLISHED = json.loads((cells.REPO / "perfbench" / "configs" / "deepseek-v2-lite.json")
                       .read_text())


def tiny_conf() -> dict:
    from fastkv_tpu_torch.core.config import DeepSeekV2Config
    from fastkv_tpu_torch.utils.testing import deepseek_v2_hf_config

    return {"name": "tiny", "source": "a test configuration", "reference": "deepseek_v2",
            "dtype": "float32", "model": deepseek_v2_hf_config(DeepSeekV2Config.tiny(), 0.3),
            "method": dict(cells.TINY["method"]), "reduced": []}


def write(root):
    """``cells.write``'s benchmark with the tiny DeepSeek-V2 configuration."""
    cells.write(root)
    (root / "perfbench" / "configs" / "tiny.json").write_text(json.dumps(tiny_conf()))
    return root


def test_counts_at_the_published_widths():
    m = PUBLISHED["model"]
    attn = 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048
    assert arch.attn_params(m) == attn == 13_762_560
    expert = 3 * 2048 * 1408
    assert arch.mlp_params(m, 0) == 3 * 2048 * 10944
    assert arch.mlp_params(m, 1) == 2048 * 64 + 2 * expert + 6 * expert == 69_337_088
    assert arch.cache_rows(m) == 1 and work.cache_rows(m, "deepseek_v2") == 1
    assert arch.pair_flops(m) == 2 * 192 + 2 * 128 and arch.slot_flops(m) == 2 * 576 + 2 * 512
    method = PUBLISHED["method"]
    n = 20000
    t = work.tsp_count(n, 0.2, 8)
    lens = [n] * 13 + [t] * 14
    assert list(work.segment_lengths(m, method, n)) == lens
    calls = arch.flash_calls(m, method, n)
    assert calls[0] == (640 * 16 * n * (n + 1) // 2, 2 * n * 16 * (2 * 192 + 2 * 128))
    assert calls[-1][0] == 640 * 16 * t * (t + 1) // 2
    want = sum(2 * (attn + arch.mlp_params(m, l)) * s + 640 * 16 * s * (s + 1) // 2
               for l, s in enumerate(lens)) + 2 * 2048 * 102400
    assert arch.prefill_flops(m, method, n) == want
    weights = 27 * attn + 3 * 2048 * 10944 + 26 * 69_337_088 + 2048 * 102400
    assert weights == 2_451_308_544  # ~4.9 GB in bf16 a step
    live = [100 + l for l in range(27)]
    f, b = arch.decode_step_work(m, live)
    assert f == 2 * weights + 2176 * 16 * sum(live)
    assert b == 2 * (weights + 2048) + 2 * 576 * sum(live)
    f8, b8 = arch.decode_step_work(m, live, batch=8)  # k routed experts read: the least
    assert f8 == 8 * 2 * weights + 2176 * 16 * sum(live) and b8 == b + 2 * 7 * 2048
    assert arch.decode_attn_bytes(m, [3000]) == 2 * (16 * (192 + 128) + 576 * 3000)


def test_published_keys_at_the_top_level_match_the_model_group():
    """The file holds the published config.json's keys twice: at its top
    level, as the source gives them, and in ``model``, which the harness
    reads; the two copies agree, and ``model`` adds only the keys that the
    published row leaves out (``initializer_range``, ``torch_dtype``)."""
    own = {"name", "source", "reference", "dtype", "model", "method", "reduced", "assumed",
           "deployment"}
    top = {k: v for k, v in PUBLISHED.items() if k not in own}
    m = PUBLISHED["model"]
    assert {k: m[k] for k in top} == top
    assert set(m) - set(top) == {"initializer_range", "torch_dtype"}


def test_weights_take_the_program_layout():
    from fastkv_tpu_torch.core.config import DeepSeekV2Config
    from fastkv_tpu_torch.models import deepseek_v2 as ds

    conf = tiny_conf()
    cfg, _ = run.model_config(conf)
    assert cfg == DeepSeekV2Config.tiny(name="tiny")
    w = run.weights_of(conf, 2**40 + 1, "cpu")
    for group, shapes in ds.param_shapes(cfg).items():
        got = w if not group else w[group]
        assert {k: tuple(got[k].shape) for k in shapes} == shapes, group
    assert set(w) == {"embed", "final_norm", "lm_head", "layers", "dense", "moe"}


def _sound(tmp_path, cell, seed):
    root = write(tmp_path)
    return run.run(root, cell, seed, 1.5, False, device="cpu", log=lambda m: None)


@pytest.mark.parametrize("cell", ["tiny-closed", "tiny-open"])
def test_reference_follows_the_program_and_the_run_is_correct(tmp_path, cell):
    res = _sound(tmp_path, cell, 2**33 + 7)
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["logit_gap"]["value"] < 1e-4
    assert res["checks"]["set_misses"]["value"] == 0


def test_float8_control_differs_from_the_reference(tmp_path):
    """The control (the reference in float8 in the program's place) reads
    past every limit of the tiny cell's that the program stays under."""
    root = write(tmp_path)
    out = control.one_seed(root, "tiny-closed", 2**33 + 11, 1.5, "cpu", lambda m: None)
    prog, ctrl = out["program"], out["control"]
    assert prog["logit_gap"] < cells.LIMITS["logit_gap"] < ctrl["logit_gap"]
    assert ctrl["keep_regret"] > cells.LIMITS["keep_regret"]
    assert not check.verdict(ctrl, cells.LIMITS)


@pytest.mark.parametrize("cell,fault", [
    ("tiny-closed", "altered_token"), ("tiny-closed", "state_unchanged"),
    ("tiny-open", "altered_token"), ("tiny-open", "state_unchanged"),
    ("tiny-open", "half_batch")])
def test_fault_is_not_correct(tmp_path, cell, fault):
    root = write(tmp_path)
    with faults.planted(fault):
        res = run.run(root, cell, 2**33 + 3, 1.5, False, device="cpu", log=lambda m: None)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_reference_raises_on_methods_it_does_not_run():
    conf = tiny_conf()
    with pytest.raises(ValueError, match="FastKV and FullKV"):
        ref.run({}, conf["model"], {**conf["method"], "method": "snapkv"}, [1], [1], None)
