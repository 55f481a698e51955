"""DeepSeek-V3 at one chip's share of EP32 in the benchmark, on the CPU at a
tiny size: its architecture module's counts against values worked out by
hand at the published widths, its configuration file against the
published row and the program's reading of it, its weights in the
program's layout, the reference against the program, the float8 control
against the reference, and ``perfbench.faults`` found by the check. The
tiny cells are ``cells.py``'s, with the tiny DeepSeek-V3 of
``utils.testing.deepseek_v3_hf_config`` in the place of the Mistral one
(1 dense + 3 expert layers; 16 router experts in 4 groups, 4 held here,
top 4, 1 shared; q LoRA 32, q/k 24, v 12, latent 32; weights drawn at std
0.3 so that attention is peaked at this size)."""

import json

import pytest
import torch

from fastkv_tpu_torch.utils.testing import deepseek_v3_hf_config, one_thread_per_module
from perfbench import check, control, faults, run, work
from perfbench.arch import deepseek_v3 as arch
from perfbench.reference import deepseek_v3 as ref
from perfbench.tests import cells

# the open cell's drain waits at most run.DRAIN_S: one torch thread, as the
# DeepSeek-V2 tests take
_one_torch_thread = one_thread_per_module()
CONF = json.loads((cells.REPO / "perfbench" / "configs" / "deepseek-v3-ep32.json").read_text())
# the published values of the keys the configuration cuts (the catalog row's)
PUBLISHED_CUT = {"num_hidden_layers": 61, "n_routed_experts": 256, "ep_size": 1}


def tiny_conf() -> dict:
    return {"name": "tiny", "source": "a test configuration", "reference": "deepseek_v3",
            "dtype": "float32", "model": deepseek_v3_hf_config(),
            "method": dict(cells.TINY["method"]), "reduced": []}


def write(root):
    """``cells.write``'s benchmark with the tiny DeepSeek-V3 configuration."""
    cells.write(root)
    (root / "perfbench" / "configs" / "tiny.json").write_text(json.dumps(tiny_conf()))
    return root


def test_counts_at_the_published_widths():
    m = CONF["model"]
    attn = 7168 * 1536 + 1536 * 128 * 192 + 7168 * 576 + 512 * 128 * 256 + 128 * 128 * 7168
    assert arch.attn_params(m) == attn == 187_105_280
    expert = 3 * 7168 * 2048
    assert arch.router_experts(m) == 256 and arch.routed_here(m) == 8 * 8 / 256
    assert arch.mlp_params(m, 2, 0) == 3 * 7168 * 18432
    assert arch.mlp_params(m, 3, 0) == 7168 * 256 + expert
    assert arch.cache_rows(m) == 1 and work.cache_rows(m, "deepseek_v3") == 1
    method = CONF["method"]
    n = 20000
    t = work.tsp_count(n, 0.2, 8)
    lens = [n] * 15 + [t] * 15
    assert list(work.segment_lengths(m, method, n)) == lens
    calls = arch.flash_calls(m, method, n)
    assert calls[0] == (640 * 128 * n * (n + 1) // 2, 2 * n * 128 * (2 * 192 + 2 * 128))
    per_token = [attn + (3 * 7168 * 18432 if l < 3 else 7168 * 256 + expert + 0.25 * expert)
                 for l in range(30)]
    want = sum(2 * p * s + 640 * 128 * s * (s + 1) // 2 for p, s in zip(per_token, lens))
    assert arch.prefill_flops(m, method, n) == int(want) + 2 * 7168 * 129280
    # a decode step reads no routed expert: 17.9 GB of weights
    weights = 30 * attn + 3 * 3 * 7168 * 18432 + 27 * (7168 * 256 + expert) + 7168 * 129280
    assert weights == 8_967_553_024
    live = [100 + l for l in range(30)]
    f, b = arch.decode_step_work(m, live)
    assert f == 2 * weights + 2176 * 128 * sum(live)
    assert b == 2 * (weights + 7168) + 2 * 576 * sum(live)
    assert arch.decode_attn_bytes(m, [3000]) == 2 * (128 * (192 + 128) + 576 * 3000)


def test_configuration_holds_the_published_row_and_its_cut():
    """The file holds the published config.json's keys at its top level,
    the three cut keys at their values here, and the same keys in
    ``model``, which adds only what the row leaves out; the program reads
    ``model`` as the share, and a copy with the published counts as the
    published model."""
    from fastkv_tpu_torch.core.config import ModelConfig

    own = {"name", "source", "reference", "dtype", "model", "method", "reduced", "assumed",
           "deployment"}
    top = {k: v for k, v in CONF.items() if k not in own}
    m = CONF["model"]
    assert {k: m[k] for k in top} == top
    assert set(m) - set(top) == {"initializer_range", "torch_dtype",
                                 "e_score_correction_bias_std"}
    assert sorted(CONF["reduced"]) == sorted(PUBLISHED_CUT)
    assert {k: top[k] for k in PUBLISHED_CUT} == {"num_hidden_layers": 30, "n_routed_experts": 8,
                                                  "ep_size": 32}
    assert CONF["method"]["tsp_idx"] == 30 // 2 - 1
    share = ModelConfig.from_hf_config(m)
    published = ModelConfig.from_hf_config({**m, **PUBLISHED_CUT})
    assert share.moe.router_experts == published.moe.router_experts == 256
    assert (share.moe.n_routed_experts, published.moe.n_routed_experts) == (8, 256)


def test_weights_take_the_program_layout():
    from fastkv_tpu_torch.models import deepseek_v2 as ds

    conf = tiny_conf()
    cfg, _ = run.model_config(conf)
    w = run.weights_of(conf, 2**40 + 1, "cpu")
    for group, shapes in ds.param_shapes(cfg).items():
        got = w if not group else w[group]
        assert {k: tuple(got[k].shape) for k in got if not isinstance(got[k], dict)} == shapes
    assert w["moe"]["e_bias"].dtype == torch.float32
    assert 0.02 < float(w["moe"]["e_bias"].std()) < 0.1  # the configured 0.05


@pytest.mark.parametrize("cell", ["tiny-closed", "tiny-open"])
def test_reference_follows_the_program_and_the_run_is_correct(tmp_path, cell):
    res = run.run(write(tmp_path), cell, 2**33 + 7, 1.5, False, device="cpu", log=lambda m: None)
    assert res["correct"] is True, res["checks"]
    assert res["checks"]["logit_gap"]["value"] < 1e-4
    assert res["checks"]["set_misses"]["value"] == 0


def test_float8_control_differs_from_the_reference(tmp_path):
    out = control.one_seed(write(tmp_path), "tiny-closed", 2**33 + 11, 1.5, "cpu",
                           lambda m: None)
    prog, ctrl = out["program"], out["control"]
    assert prog["logit_gap"] < cells.LIMITS["logit_gap"] < ctrl["logit_gap"]
    assert not check.verdict(ctrl, cells.LIMITS)


@pytest.mark.parametrize("fault", ["altered_token", "state_unchanged"])
def test_fault_is_not_correct(tmp_path, fault):
    root = write(tmp_path)
    with faults.planted(fault):
        res = run.run(root, "tiny-closed", 2**33 + 3, 1.5, False, device="cpu",
                      log=lambda m: None)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_reference_refuses_another_router():
    conf = tiny_conf()
    with pytest.raises(ValueError, match="noaux_tc"):
        ref.Model({"embed": torch.zeros(1)}, {**conf["model"], "topk_method": "greedy"})
