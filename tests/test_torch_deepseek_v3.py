"""DeepSeek-V3 at a share of its experts on the port's normal path, on the
CPU at a tiny size.

``utils.testing.deepseek_v3_hf_config``: 1 dense + 3 expert layers, MLA
over 4 heads with a query LoRA of 32 (q/k 24 wide: 16 nope + 8 rope, v 12,
a latent of 32), a ``noaux_tc`` router over 16 experts in 4 groups (the
best 2 kept, top 4, renormalised, x 2.5), 1 shared expert, 4 devices
sharing each expert layer (4 experts held here), YaRN x4 from 64
positions; weights from ``perfbench/arch/deepseek_v3.py`` at std 0.3 (so
attention is peaked and the logits spread at this size), the correction
bias at std 0.05; the program in float32. Against the benchmark's plain
float32 reference (``perfbench/reference/deepseek_v3.py``), which follows
the program's kept and TSP sets:

  * the query LoRA's q against the reference's, within 1e-5 (float32, the
    same products; O(1) values), and against the query without its norm;
  * ``noaux_tc`` routing against the reference's: the same experts, the
    weights within 1e-6 (float32 sigmoid and one division); rows where the
    correction bias, and rows where the group limit, change the chosen set;
  * the share: the 4 devices' routed parts, plus the shared expert counted
    once, equal the uncut layer's output (16 experts held) within 1e-5 of
    its largest value (float32, the same products summed in another order
    and the shared expert taken out and put back: a few ulps of values up
    to ~20), in the program (prefill and decode forms) and in the
    reference;
  * FastKV and FullKV logits of the prefill and of each decode step within
    1e-4, as DeepSeek-V2's (both sides float32; they differ in the order of
    summation: the absorbed decode attention against the expanded one, the
    experts' weighted sums, the reference's blocks of heads); the
    reference's own kept and TSP sets equal the program's;
  * the prefill's row chunks against the whole layer within 1e-6 of its
    largest value (float32; the products over fewer rows), and the spans: ``prefill.route`` a chunk of
    an expert layer, ``prefill.moe``'s ``pairs_here`` the live pairs on
    held experts, ``decode.route`` in an eager step;
  * ``from_hf_config`` on the published config (256 experts, ``ep_size``
    1) and on the benchmark's share of it; what it refuses of a
    ``deepseek_v3`` config, by key.
"""

import dataclasses
import json
import time
from pathlib import Path

import pytest
import torch

from fastkv_tpu_torch.core.config import (DeepSeekV2Config, EngineConfig, Method, MethodConfig,
                                          ModelConfig)
from fastkv_tpu_torch.engine import decode as dm
from fastkv_tpu_torch.engine import prefill as pm
from fastkv_tpu_torch.engine.generate import Engine
from fastkv_tpu_torch.models import deepseek_v2 as ds
from fastkv_tpu_torch.models import family, llama
from fastkv_tpu_torch.models.rope import compute_inv_freq
from fastkv_tpu_torch.ops import add_rms_norm
from fastkv_tpu_torch.utils import profiling
from fastkv_tpu_torch.utils.testing import deepseek_v3_hf_config, one_thread_per_module
from perfbench.arch import deepseek_v3 as arch
from perfbench.reference import deepseek_v3 as ref

_one_torch_thread = one_thread_per_module()

REPO = Path(__file__).resolve().parents[1]
HF = deepseek_v3_hf_config()
CFG = dataclasses.replace(ModelConfig.from_hf_config(HF), dtype="float32")
CPU = [torch.profiler.ProfilerActivity.CPU]


def _weights(hf, seed=7):
    return arch.make_weights(hf, seed, "cpu", torch.float32)


@pytest.fixture(scope="module")
def params():
    return _weights(HF)


def _prompt(n, seed):
    return torch.randint(0, CFG.vocab_size, (n,), generator=torch.Generator().manual_seed(seed)
                         ).tolist()


def _rows(n, seed, scale=1.0):
    return torch.randn((n, CFG.hidden_size), generator=torch.Generator().manual_seed(seed)) * scale


def _normed(lp, x):
    return llama.rms_norm(x, lp["ln_mlp"], CFG.rms_norm_eps)


def test_q_lora_query_matches_reference(params):
    lp = ds.layer_params(params, 2)
    m = ref.Model(params, HF)
    rlp = m.layer(2)
    hn = _normed(lp, _rows(9, 1))[None]
    q, kv_a = ds.latent_proj(lp, CFG, hn)  # [1, H, 9, 24], [1, 9, 40]
    pos = torch.arange(9)
    want = m.query(rlp, m.q_latent(rlp, hn[0]), pos, 0, CFG.num_heads)  # roped
    cos, sin = ds.cos_sin(CFG, pos[None], torch.from_numpy(compute_inv_freq(CFG)))
    q_roped, latent, _ = ds.latent_rope(CFG, q, kv_a, lp["kv_norm"], cos, sin)
    assert (q_roped[0] - want).abs().max().item() < 1e-5
    # decode's norm (ops.add_rms_norm) gives the same query on the CPU
    q_dec, _ = ds.latent_proj(lp, CFG, hn[:, :1], norm=add_rms_norm.rms_norm)
    assert torch.equal(q_dec, ds.latent_proj(lp, CFG, hn[:, :1])[0])
    # and the query LoRA's norm matters at these weights
    bare = (hn @ lp["q_a"]) @ lp["q_b"]
    assert (bare.view(1, 9, CFG.num_heads, -1).transpose(1, 2) - q).abs().max().item() > 0.1


def test_noaux_tc_routing_matches_reference(params):
    lp = ds.layer_params(params, 1)
    x = _normed(lp, _rows(512, 2))
    w, idx = ds.route(lp, CFG, x)
    rw, ridx = ref.Model(params, HF).route(ref.Model(params, HF).layer(1), x)
    assert torch.equal(torch.sort(idx, dim=-1).values, torch.sort(ridx, dim=-1).values)
    order, rorder = torch.argsort(idx, dim=-1), torch.argsort(ridx, dim=-1)
    assert (w.gather(1, order) - rw.gather(1, rorder)).abs().max().item() < 1e-6
    assert idx.shape == (512, 4) and int(idx.max()) < 16
    # renormalised, then scaled by 2.5
    assert torch.allclose(w.sum(dim=-1), torch.full((512,), 2.5), atol=1e-5)
    # the chosen experts lie in the 2 kept groups of 4 experts
    assert max(len(set(r)) for r in (idx // 4).tolist()) <= 2

    def chosen(lp_, cfg_):
        return [frozenset(r) for r in ds.route(lp_, cfg_, x)[1].tolist()]

    base = chosen(lp, CFG)
    no_bias = chosen({**lp, "e_bias": torch.zeros_like(lp["e_bias"])}, CFG)
    no_limit = chosen(lp, dataclasses.replace(CFG, moe=dataclasses.replace(CFG.moe, topk_group=4)))
    assert 0 < sum(a != b for a, b in zip(base, no_bias)) < len(base)
    assert 0 < sum(a != b for a, b in zip(base, no_limit)) < len(base)


def _rank(hf_uncut, w_uncut, rank, ep=4):
    """Device ``rank``'s config and weights of an uncut model's experts."""
    held = hf_uncut["n_routed_experts"] // ep
    hf = {**hf_uncut, "n_routed_experts": held, "ep_size": ep, "ep_rank": rank}
    moe = {k: (v[:, rank * held:(rank + 1) * held] if k in ("w_gate", "w_up", "w_down") else v)
           for k, v in w_uncut["moe"].items()}
    return hf, {**w_uncut, "moe": moe}


def test_share_parts_sum_to_the_uncut_layer():
    """The 4 devices' routed parts, plus the shared expert counted once,
    equal the uncut layer: in the program (prefill over padded rows, and
    decode) and in the reference."""
    hf_all = deepseek_v3_hf_config(ep_size=1)
    w_all = _weights(hf_all, seed=11)
    cfg_all = dataclasses.replace(ModelConfig.from_hf_config(hf_all), dtype="float32")
    lp_all = ds.layer_params(w_all, 2)
    x = _normed(lp_all, _rows(24, 3))[None]
    valid = torch.arange(24)[None] < 20
    want = ds.moe_prefill(lp_all, cfg_all, x, valid)
    want_dec = ds.decode_ffn(lp_all, cfg_all, x.transpose(0, 1))
    shared = ds._shared(lp_all, x)
    m_all = ref.Model(w_all, hf_all)
    want_ref = m_all.mlp(m_all.layer(2), x[0])
    got, got_dec, got_ref = shared.clone(), shared.transpose(0, 1).clone(), shared[0].clone()
    for rank in range(4):
        hf_r, w_r = _rank(hf_all, w_all, rank)
        cfg_r = dataclasses.replace(ModelConfig.from_hf_config(hf_r), dtype="float32")
        lp_r = ds.layer_params(w_r, 2)
        got += ds.moe_prefill(lp_r, cfg_r, x, valid) - shared
        got_dec += ds.decode_ffn(lp_r, cfg_r, x.transpose(0, 1)) - shared.transpose(0, 1)
        m_r = ref.Model(w_r, hf_r)
        got_ref += m_r.mlp(m_r.layer(2), x[0]) - shared[0]
    for a, b in ((got, want), (got_dec, want_dec), (got_ref, want_ref)):
        assert (a - b).abs().max().item() < 1e-5 * b.abs().max().item()
    # the program's layer is the reference's on the valid rows
    assert (want[0, :20] - want_ref[:20]).abs().max().item() < 1e-5 * want_ref.abs().max().item()
    # padded rows take the shared expert alone
    assert torch.equal(want[:, 20:], shared[:, 20:])
    # one device's part is not the whole layer
    assert (ds.moe_prefill(ds.layer_params(_rank(hf_all, w_all, 0)[1], 2),
                           dataclasses.replace(ModelConfig.from_hf_config(
                               _rank(hf_all, w_all, 0)[0]), dtype="float32"), x, valid)
            - want).abs().max().item() > 1e-2


def _follow(cache, shapes, tsp):
    pos = cache.pos[:, 0, 0, :shapes.prefill_capacity]
    valid = cache.valid[:, 0, 0, :shapes.prefill_capacity]
    kept = [[pos[l][valid[l]].long()] for l in range(CFG.num_layers)]
    tsp_pos = None
    if tsp is not None:
        positions, idx, ok = tsp
        tsp_pos = torch.gather(positions.long(), 1, idx.long())[0][ok[0]]
    return ref.Follow(kept, tsp_pos)


@pytest.mark.parametrize("method", [Method.FASTKV, Method.FULLKV])
@pytest.mark.parametrize("n,bucket", [(300, 512), (77, 128)])
def test_logits_match_reference(params, method, n, bucket):
    """Prefill and every decode step against the reference's full forward
    pass, which follows the program's kept sets and TSP set; the
    reference's own sets equal them."""
    mcfg, new = MethodConfig(method=method, tsp_idx=1), 8
    ecfg = EngineConfig(prefill_buckets=(bucket,), capacity_align=8)
    shapes = pm.plan_shapes(CFG, mcfg, dataclasses.replace(ecfg, max_new_tokens=new), bucket)
    prompt = _prompt(n, n)
    toks = torch.zeros((1, bucket), dtype=torch.int32)
    toks[0, :n] = torch.tensor(prompt)
    seen = []
    orig = pm.tsp_gather
    pm.tsp_gather = lambda st, t: (seen.append((st.positions, t.idx, t.valid)), orig(st, t))[1]
    try:
        logits, cache = pm.prefill(params, CFG, mcfg, shapes, toks,
                                   torch.tensor([n], dtype=torch.int32), ecfg)
    finally:
        pm.tsp_gather = orig
    follow = _follow(cache, shapes, seen[0] if seen else None)
    rows, served = [logits[0]], [int(logits[0].argmax())]
    for t in range(new - 1):
        lg, cache = dm.decode_step(params, CFG, mcfg, cache,
                                   torch.tensor([served[-1]], dtype=torch.int32),
                                   torch.tensor([n + t], dtype=torch.int32),
                                   shapes.prefill_capacity + t)
        rows.append(lg[0])
        served.append(int(lg[0].argmax()))
    meth = {"method": method.value, "retain_rate": 0.1, "tsp_rate": 0.2, "tsp_idx": 1,
            "window_size": 8}
    r = ref.run(params, HF, meth, prompt, served, follow)
    assert torch.stack(rows).abs().max().item() > 1.0
    assert (r.logits - torch.stack(rows)).abs().max().item() < 1e-4
    for l, lay in enumerate(r.layers):
        kept = follow.kept[l][0]
        kept = torch.sort(kept[kept < n - 8]).values
        assert torch.equal(torch.sort(lay.own_keep[0]).values, kept), l
    if method == Method.FASTKV:
        assert torch.equal(r.own_tsp, follow.tsp)
    assert cache.k.shape[2] == 1 and cache.k.shape[-1] == 32 and cache.v.shape[-1] == 8


def test_generate_batch_rows_match_single_rows(params):
    eng = Engine(params, CFG, MethodConfig(method=Method.FASTKV, tsp_idx=1),
                 EngineConfig(prefill_buckets=(512,), capacity_align=8), device="cpu")
    a, b = _prompt(300, 1), _prompt(190, 2)
    both = eng.generate([a, b], max_new_tokens=6)
    assert both == [eng.generate([a], max_new_tokens=6)[0], eng.generate([b], max_new_tokens=6)[0]]


def test_prefill_chunks_and_route_spans(params, monkeypatch):
    """The expert layer over row chunks gives each row what it gives whole;
    under the profiler each chunk's router is a ``prefill.route`` span
    inside ``prefill.moe``, whose ``pairs_here`` counts the valid rows'
    pairs on the 4 experts held; an eager decode step records
    ``decode.route``."""
    lp = ds.layer_params(params, 3)
    x = _normed(lp, _rows(40, 4))[None]
    valid = torch.arange(40)[None] < 33
    whole = ds.moe_prefill(lp, CFG, x, valid)
    _, idx = ds.route(lp, CFG, x[0, :33])
    want_pairs = int((idx < 4).sum())
    assert 0 < want_pairs < 33 * 4
    monkeypatch.setattr(ds, "MOE_SUM_BYTES", 4 * 4 * 64 * 16)  # 16 rows a chunk
    with torch.profiler.profile(activities=CPU):
        lo = time.time_ns()
        chunked = ds.moe_prefill(lp, CFG, x, valid, layer=3)
        ds.decode_ffn(lp, CFG, x[:, :2].transpose(0, 1))
        hi = time.time_ns()
    assert (chunked - whole).abs().max().item() < 1e-6 * whole.abs().max().item()
    spans = profiling.records(lo, hi)
    [moe] = [s for s in spans if s.name == "prefill.moe"]
    routes = [s for s in spans if s.name == "prefill.route"]
    assert [s.counts for s in routes] == [{"layer": 3, "rows": r} for r in (16, 16, 8)]
    assert all(s.parent == moe.id for s in routes)
    assert moe.counts["pairs_here"] == want_pairs and moe.counts["max_load"] <= want_pairs
    [dec] = [s for s in spans if s.name == "decode.moe"]
    assert [s.parent for s in spans if s.name == "decode.route"] == [dec.id]


def test_dsv2lite_expert_layer_runs_whole_at_its_bucket():
    """DeepSeek-V2-Lite's cell prefills 32768 rows of 6 pairs at hidden 2048:
    one chunk, so its launches are those of the whole layer."""
    lite = DeepSeekV2Config.lite()
    assert ds.MOE_SUM_BYTES // (4 * lite.moe.num_experts_per_tok * lite.hidden_size) >= 32768


CATALOG_ROW = json.loads((REPO / "perfbench" / "configs" / "deepseek-v3-ep32.json").read_text())


def test_from_hf_config_reads_the_published_config_and_the_share():
    share = ModelConfig.from_hf_config(CATALOG_ROW["model"], name="dsv3")
    published = ModelConfig.from_hf_config(
        {**CATALOG_ROW["model"], "num_hidden_layers": 61, "n_routed_experts": 256, "ep_size": 1})
    for cfg, held, ep, L in ((share, 8, 32, 30), (published, 256, 1, 61)):
        assert isinstance(cfg, DeepSeekV2Config) and cfg.kind == "deepseek_v2"
        assert family.of(cfg) is ds
        assert (cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                cfg.intermediate_size, cfg.vocab_size) == (L, 7168, 128, 1, 192, 18432, 129280)
        assert cfg.mla.q_lora_rank == 1536 and cfg.mla.kv_lora_rank == 512
        moe = cfg.moe
        assert (moe.n_routed_experts, moe.ep_size, moe.ep_rank, moe.router_experts) == (
            held, ep, 0, 256)
        assert (moe.topk_method, moe.n_group, moe.topk_group, moe.norm_topk_prob,
                moe.routed_scaling_factor, moe.num_experts_per_tok, moe.n_shared_experts,
                moe.first_k_dense_replace) == ("noaux_tc", 8, 4, True, 2.5, 8, 1, 3)
        # 192^-0.5 x (0.1 ln 40 + 1)^2: YaRN x40 with mscale_all_dim 1
        assert cfg.softmax_scale == pytest.approx(0.1352338, abs=1e-6)
        assert ds.rope_mscale(cfg) == 1.0
    assert ds.param_shapes(share)["moe"]["w_gate"] == (27, 8, 7168, 2048)
    assert ds.param_shapes(share)["moe"]["router"] == (27, 7168, 256)
    assert "wq" not in ds.param_shapes(share)["layers"]


V3_UNPORTED = [("topk_method", "group_limited_greedy"), ("topk_method", "greedy"),
               ("scoring_func", "softmax"), ("attention_bias", True), ("moe_layer_freq", 2)]


@pytest.mark.parametrize("key,value", V3_UNPORTED, ids=[f"{k}={v}" for k, v in V3_UNPORTED])
def test_from_hf_config_refuses_what_v3_does_not_port(key, value):
    with pytest.raises(NotImplementedError, match=f"deepseek_v3: {key}="):
        ModelConfig.from_hf_config({**CATALOG_ROW["model"], key: value})


@pytest.mark.parametrize("over", [{"n_group": 3}, {"topk_group": 9}, {"ep_rank": 32},
                                  {"num_experts_per_tok": 129}])
def test_from_hf_config_refuses_a_router_that_does_not_fit(over):
    with pytest.raises(ValueError, match="deepseek_v3"):
        ModelConfig.from_hf_config({**CATALOG_ROW["model"], **over})
