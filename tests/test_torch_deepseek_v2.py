"""DeepSeek-V2 on the port's normal path, on the CPU at a tiny size.

``DeepSeekV2Config.tiny()``: 1 dense layer + 3 expert layers of 8 experts
(top 2) + 1 shared, MLA over 4 heads with q/k 24 wide (16 nope + 8 rope),
v 12, a latent of 32, YaRN x4 from 64 positions; seeded random weights
(std 0.3, so attention is peaked and the logits spread at this size); the
program in float32. Against the benchmark's plain float32 reference
(``perfbench/reference/deepseek_v2.py``: MLA expanded, its own routing),
which follows the program's kept and TSP sets:

  * FullKV and FastKV logits of the prefill and of each decode step within
    1e-4 (the logits are O(1): both sides are float32 and differ only in
    the order of summation: the absorbed decode attention against the
    expanded one, the experts' weighted sums); the reference's own kept
    and TSP sets equal the program's;
  * absorbed against expanded decode attention within 1e-5 (float32; one
    reassociation of the same products), and a row with no slot gives 0;
  * the decode expert path against the prefill path within 1e-5 (the same
    products batched differently), and padded rows change no valid row
    (exactly: their outputs never enter another row);
  * YaRN's frequencies and softmax scale at the published config against
    the formula's values written out here;
  * ``from_hf_config`` on the catalog's config; Mistral and Llama configs
    come out as before;
  * the Scheduler's tokens equal ``Engine.generate``'s (admitted whole);
  * every refusal of the path (and reading a checkpoint) raises
    NotImplementedError naming the kind.
"""

import dataclasses
import math
import types

import pytest
import torch

from fastkv_tpu_torch.core import quant, weights
from fastkv_tpu_torch.core.config import (DeepSeekV2Config, EngineConfig, Method, MethodConfig,
                                          ModelConfig, ParallelConfig, RopeScaling)
from fastkv_tpu_torch.engine import chunked
from fastkv_tpu_torch.engine import decode as dm
from fastkv_tpu_torch.engine import prefill as pm
from fastkv_tpu_torch.engine.generate import Engine
from fastkv_tpu_torch.engine.scheduler import Scheduler
from fastkv_tpu_torch.models import deepseek_v2 as ds
from fastkv_tpu_torch.models import family, llama
from fastkv_tpu_torch.models.rope import compute_inv_freq
from fastkv_tpu_torch.ops import latent_attn
from fastkv_tpu_torch.utils.testing import deepseek_v2_hf_config, one_thread_per_module
from perfbench.reference import deepseek_v2 as ref

_one_torch_thread = one_thread_per_module()

CFG = DeepSeekV2Config.tiny()
STD = 0.3
CATALOG = {
    "attention_bias": False, "first_k_dense_replace": 1, "hidden_act": "silu",
    "hidden_size": 2048, "intermediate_size": 10944, "kv_lora_rank": 512,
    "max_position_embeddings": 163840, "model_type": "deepseek_v2",
    "moe_intermediate_size": 1408, "moe_layer_freq": 1, "n_group": 1, "n_routed_experts": 64,
    "n_shared_experts": 2, "norm_topk_prob": False, "num_attention_heads": 16,
    "num_experts_per_tok": 6, "num_hidden_layers": 27, "num_key_value_heads": 16,
    "q_lora_rank": None, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707,
                     "mscale_all_dim": 0.707, "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 1, "scoring_func": "softmax", "seq_aux": True,
    "tie_word_embeddings": False, "topk_group": 1, "topk_method": "greedy", "v_head_dim": 128,
    "vocab_size": 102400}


@pytest.fixture(scope="module")
def params():
    return ds.init_params(CFG, torch.Generator().manual_seed(0), device="cpu", std=STD)


def _prompt(n, seed):
    return torch.randint(0, CFG.vocab_size, (n,), generator=torch.Generator().manual_seed(seed)
                         ).tolist()


def _mcfg(method):
    return MethodConfig(method=method, tsp_idx=1)


def _follow(cache, shapes, tsp, n):
    pos = cache.pos[:, 0, 0, :shapes.prefill_capacity]
    valid = cache.valid[:, 0, 0, :shapes.prefill_capacity]
    kept = [[pos[l][valid[l]].long()] for l in range(CFG.num_layers)]
    tsp_pos = None
    if tsp is not None:
        positions, idx, ok = tsp
        tsp_pos = torch.gather(positions.long(), 1, idx.long())[0][ok[0]]
    return ref.Follow(kept, tsp_pos)


@pytest.mark.parametrize("method", [Method.FASTKV, Method.FULLKV])
@pytest.mark.parametrize("n,bucket", [(300, 512), (500, 512), (77, 128)])
def test_logits_match_reference(params, method, n, bucket):
    """Prefill and every decode step against the reference that follows the
    program's kept sets and TSP set; the reference's own sets equal them."""
    mcfg, new = _mcfg(method), 8
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
    follow = _follow(cache, shapes, seen[0] if seen else None, n)
    rows, served = [logits[0]], [int(logits[0].argmax())]
    for t in range(new - 1):
        lg, cache = dm.decode_step(params, CFG, mcfg, cache,
                                   torch.tensor([served[-1]], dtype=torch.int32),
                                   torch.tensor([n + t], dtype=torch.int32),
                                   shapes.prefill_capacity + t)
        rows.append(lg[0])
        served.append(int(lg[0].argmax()))
    conf = deepseek_v2_hf_config(CFG, STD)
    meth = {"method": method.value, "retain_rate": 0.1, "tsp_rate": 0.2, "tsp_idx": 1,
            "window_size": 8}
    r = ref.run(params, conf, meth, prompt, served, follow)
    assert (r.logits - torch.stack(rows)).abs().max().item() < 1e-4
    for l, lay in enumerate(r.layers):
        kept = follow.kept[l][0]
        kept = torch.sort(kept[kept < n - 8]).values
        assert torch.equal(torch.sort(lay.own_keep[0]).values, kept), l
    if method == Method.FASTKV:
        assert torch.equal(r.own_tsp, follow.tsp)
    assert cache.k.shape[2] == 1 and cache.k.shape[-1] == 32 and cache.v.shape[-1] == 8


@pytest.mark.parametrize("b,C", [(1, 40), (3, 17)])
def test_absorbed_matches_expanded(b, C):
    gen = torch.Generator().manual_seed(C)
    H, n, r, R, v = 4, 16, 8, 32, 12
    q = torch.randn((b, H, 1, n + r), generator=gen)
    latent = torch.randn((b, 1, C, R), generator=gen)
    k_pe = torch.randn((b, 1, C, r), generator=gen)
    w = torch.randn((R, H * (n + v)), generator=gen) * 0.2
    valid = torch.rand((b, 1, C), generator=gen) < 0.6
    valid[0, 0, :] = False  # a row with no slot gives 0
    a = latent_attn.absorbed(q, latent, k_pe, valid, w, v, 0.3)
    e = latent_attn.expanded(q, latent, k_pe, valid, w, v, 0.3)
    assert a.shape == (b, H, 1, v)
    assert (a - e).abs().max().item() < 1e-5
    assert a[0].abs().max().item() == 0.0


def test_decode_experts_match_prefill_experts(params):
    lp = ds.layer_params(params, 2)
    x = torch.randn((1, 6, CFG.hidden_size), generator=torch.Generator().manual_seed(3))
    pre = ds.moe_prefill(lp, CFG, x)
    dec = ds.decode_ffn(lp, CFG, x.transpose(0, 1))  # the 6 rows as a batch of 6 steps
    assert (pre[0] - dec[:, 0]).abs().max().item() < 1e-5
    # rows past the prompt change no valid row: their experts are never run
    valid = torch.tensor([[True, True, True, False, False, False]])
    masked = ds.moe_prefill(lp, CFG, x, valid)
    assert torch.equal(masked[:, :3], ds.moe_prefill(lp, CFG, x[:, :3]))
    shared = ds._shared(lp, x)
    assert torch.equal(masked[:, 3:], shared[:, 3:])


def test_padded_batch_rows_match_single_rows(params):
    mcfg = _mcfg(Method.FASTKV)
    eng = Engine(params, CFG, mcfg, EngineConfig(prefill_buckets=(512,), capacity_align=8),
                 device="cpu")
    a, b = _prompt(300, 1), _prompt(190, 2)
    both = eng.generate([a, b], max_new_tokens=6)
    assert both == [eng.generate([a], max_new_tokens=6)[0], eng.generate([b], max_new_tokens=6)[0]]


def test_yarn_inv_freq_and_softmax_scale_at_the_published_config():
    cfg = ModelConfig.from_hf_config(CATALOG)
    inv = compute_inv_freq(cfg)
    # r = 64, theta 1e4, 4096 original positions: the correction dims of 32
    # and 1 rotations are 64 ln(4096 / (64 pi)) / (2 ln 1e4) = 10.47 -> 10
    # and 64 ln(4096 / (2 pi)) / (2 ln 1e4) = 22.51 -> 23; frequency i is
    # theta^(-2i/64), divided by 40 with weight (i - 10) / 13 in between
    want = []
    for i in range(32):
        f = 10000.0 ** (-2 * i / 64)
        ramp = min(max((i - 10) / 13, 0.0), 1.0)
        want.append(f / 40 * ramp + f * (1 - ramp))
    assert inv.shape == (32,)
    assert torch.allclose(torch.from_numpy(inv).double(), torch.tensor(want, dtype=torch.float64),
                          rtol=1e-6, atol=0)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert cfg.softmax_scale == pytest.approx(192 ** -0.5 * m * m, rel=1e-12)
    assert cfg.softmax_scale == pytest.approx(0.114721, abs=1e-6)
    assert torch.allclose(ref.yarn_inv_freq(CATALOG), torch.from_numpy(inv))


def test_from_hf_config_reads_the_catalog_config():
    cfg = ModelConfig.from_hf_config(CATALOG, name="dsv2")
    assert isinstance(cfg, DeepSeekV2Config) and cfg.kind == "deepseek_v2"
    assert (cfg.num_layers, cfg.hidden_size, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.intermediate_size, cfg.vocab_size) == (27, 2048, 16, 1, 192, 10944, 102400)
    assert (cfg.mla.kv_lora_rank, cfg.mla.qk_nope_head_dim, cfg.mla.qk_rope_head_dim,
            cfg.mla.v_head_dim) == (512, 128, 64, 128)
    assert (cfg.moe.n_routed_experts, cfg.moe.num_experts_per_tok, cfg.moe.moe_intermediate_size,
            cfg.moe.n_shared_experts, cfg.moe.first_k_dense_replace) == (64, 6, 1408, 2, 1)
    assert ds.cache_dims(cfg) == (512, 64) and cfg.rope_dim == 64
    assert cfg == DeepSeekV2Config.lite(name="dsv2", dtype=cfg.dtype)
    assert dataclasses.asdict(ModelConfig.tiny()).keys() == {
        f.name for f in dataclasses.fields(ModelConfig)}
    # the Mistral and Llama families as before
    nemo = {"model_type": "mistral", "vocab_size": 131072, "hidden_size": 5120,
            "intermediate_size": 14336, "num_hidden_layers": 40, "num_attention_heads": 32,
            "num_key_value_heads": 8, "head_dim": 128, "rope_theta": 1000000.0,
            "rms_norm_eps": 1e-5, "sliding_window": None, "max_position_embeddings": 1024000}
    got = ModelConfig.from_hf_config(nemo, name="mistral-nemo-12b")
    assert type(got) is ModelConfig and got.kind == "llama" and got.rope_dim == 128
    assert got == ModelConfig.mistral_nemo_12b(max_position_embeddings=1024000, rms_norm_eps=1e-5)
    llama8b = {"model_type": "llama", "vocab_size": 128256, "hidden_size": 4096,
               "intermediate_size": 14336, "num_hidden_layers": 32, "num_attention_heads": 32,
               "num_key_value_heads": 8, "rope_theta": 500000.0, "rms_norm_eps": 1e-5,
               "max_position_embeddings": 131072,
               "rope_scaling": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                                "high_freq_factor": 4.0,
                                "original_max_position_embeddings": 8192}}
    got = ModelConfig.from_hf_config(llama8b, name="llama-3.1-8b")
    assert got == ModelConfig.llama_3_1_8b() and got.rope_scaling == RopeScaling(factor=8.0)
    assert family.of(got) is llama and family.of(cfg) is ds


UNPORTED = [("q_lora_rank", 1536), ("attention_bias", True),
            ("topk_method", "group_limited_greedy"), ("scoring_func", "sigmoid"),
            ("moe_layer_freq", 2), ("n_group", 8), ("norm_topk_prob", True),
            ("routed_scaling_factor", 16.0)]


@pytest.mark.parametrize("key,value", UNPORTED, ids=[u[0] for u in UNPORTED])
def test_from_hf_config_refuses_what_is_not_ported(key, value):
    with pytest.raises(NotImplementedError, match=f"deepseek_v2: {key}="):
        ModelConfig.from_hf_config({**CATALOG, key: value})


@pytest.mark.parametrize("method", [Method.FASTKV, Method.FULLKV])
def test_scheduler_tokens_match_generate(params, method):
    mcfg = _mcfg(method)
    prompts = [_prompt(300, 5), _prompt(190, 6), _prompt(450, 7)]
    eng = Engine(params, CFG, mcfg, EngineConfig(prefill_buckets=(512,), capacity_align=8),
                 device="cpu")
    want = [eng.generate([p], max_new_tokens=n)[0] for p, n in zip(prompts, (6, 9, 4))]
    ecfg = EngineConfig(prefill_buckets=(512,), capacity_align=8, prefill_chunk=64)
    assert not chunked.supported(mcfg, CFG) and chunked.supported(mcfg, ModelConfig.tiny())
    sched = Scheduler(params, CFG, mcfg, ecfg, max_batch=2, bucket=512, max_new_tokens=12,
                      device="cpu")
    for p, n in zip(prompts, (6, 9, 4)):
        sched.submit(p, max_new_tokens=n)
    done = sorted(sched.run(), key=lambda r: r.req_id)
    assert [r.tokens for r in done] == want
    kinds = {e[0] for e in sched.events}
    assert "chunk" not in kinds and "prefill" in kinds


REFUSALS = [(f"method_{m.value}", dict(method=m), {}) for m in (
    Method.SNAPKV, Method.H2O, Method.STREAMINGLLM, Method.GEMFILTER, Method.PYRAMIDINFER)] + [
    ("kv_int8", {}, dict(kv_int8=True)),
    ("int8_weights", {}, {}),
    ("mesh", {}, {}),
    ("fuse_window_scores", {}, dict(fuse_window_scores=True))]


@pytest.mark.parametrize("entry", ["engine", "scheduler"])
@pytest.mark.parametrize("name,mkw,ekw", REFUSALS, ids=[r[0] for r in REFUSALS])
def test_what_the_path_does_not_run_raises(params, entry, name, mkw, ekw):
    mcfg = MethodConfig(**{"method": Method.FASTKV, "tsp_idx": 1, **mkw})
    ecfg = EngineConfig(prefill_buckets=(512,), capacity_align=8, **ekw)
    p, kw = params, {"device": "cpu"}
    if name == "int8_weights":
        p = {**params, "layers": {**params["layers"]}}
        p["layers"]["wq"], p["layers"]["wq_scale"] = quant.absmax_quantize(
            params["layers"]["wq"], axis=1)
    if name == "mesh":
        kw = {"mesh": types.SimpleNamespace(pcfg=ParallelConfig(model=2), data=1,
                                            device=torch.device("cpu"))}
    with pytest.raises(NotImplementedError, match="deepseek_v2"):
        if entry == "engine":
            Engine(p, CFG, mcfg, ecfg, **kw)
        else:
            Scheduler(p, CFG, mcfg, ecfg, max_batch=2, bucket=512, max_new_tokens=8, **kw)


def test_checkpoint_read_raises():
    with pytest.raises(NotImplementedError, match="deepseek_v2"):
        weights.params_from_hf(CFG, lambda *a: None, device="cpu")
