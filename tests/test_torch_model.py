"""Port parity: configuration, shape plans, budgets, RoPE and the Llama blocks.

The same inputs, made with numpy from a seed, go through the JAX package and
the PyTorch port (``fastkv_tpu_torch``) on the CPU. Shape plans and budgets are
integers and must be equal; the float32 blocks agree to 1e-5 (only the order
of summation differs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastkv_tpu.core import config as jcfg
from fastkv_tpu.engine import prefill as jpm
from fastkv_tpu.models import llama as jllama
from fastkv_tpu.models import rope as jrope
from fastkv_tpu.policies import budgets as jbud
from fastkv_tpu_torch.core import config as tcfg
from fastkv_tpu_torch.engine import prefill as tpm
from fastkv_tpu_torch.models import llama as tllama
from fastkv_tpu_torch.models import rope as trope
from fastkv_tpu_torch.policies import budgets as tbud

ATOL = 1e-5


def _method_pair(method: str, mode: str):
    kw = dict(eviction_mode=mode, retain_rate=0.1, tsp_rate=0.2, tsp_idx=1,
              max_capacity_prompt=512, tsp_len=2048)
    return (jcfg.MethodConfig(method=jcfg.Method(method), **kw),
            tcfg.MethodConfig(method=tcfg.Method(method), **kw))


@pytest.mark.parametrize("mode", ["proportional", "constant"])
@pytest.mark.parametrize("method", ["fullkv", "fastkv", "snapkv", "streamingllm"])
def test_plan_shapes_and_budgets_match_jax(method, mode):
    mj, mt = _method_pair(method, mode)
    lengths = np.array([1, 7, 8, 9, 100, 511, 512, 1000, 4095, 8192], np.int32)
    for bucket in (512, 1024, 2048, 8192, 32768):
        for align in (8, 128):
            ej = jcfg.EngineConfig(max_new_tokens=32, capacity_align=align, use_pallas=False)
            et = tcfg.EngineConfig(max_new_tokens=32, capacity_align=align)
            sj = jpm.plan_shapes(jcfg.ModelConfig.tiny(), mj, ej, bucket)
            st = tpm.plan_shapes(tcfg.ModelConfig.tiny(), mt, et, bucket)
            assert dataclasses.asdict(sj) == dataclasses.asdict(st)
            for post in (False, True):
                assert (dataclasses.asdict(jbud.static_prefill_budget(mj, bucket, post, align))
                        == dataclasses.asdict(tbud.static_prefill_budget(mt, bucket, post, align)))
    n = lengths[lengths <= 8192]
    for post in (False, True):
        kj = np.asarray(jbud.dynamic_keep_budget(mj, jnp.asarray(n), post))
        kt = tbud.dynamic_keep_budget(mt, torch.from_numpy(n), post).numpy()
        np.testing.assert_array_equal(kj, kt)
    tj = np.asarray(jbud.dynamic_tsp_budget(mj, jnp.asarray(n)))
    tt = tbud.dynamic_tsp_budget(mt, torch.from_numpy(n)).numpy()
    np.testing.assert_array_equal(tj, tt)


@pytest.mark.parametrize(
    "preset", ["tiny", "llama_3_2_1b", "llama_3_1_8b", "ministral_8b", "mistral_nemo_12b"])
def test_config_presets_and_param_shapes_match_jax(preset):
    cj = getattr(jcfg.ModelConfig, preset)()
    ct = getattr(tcfg.ModelConfig, preset)()
    dj, dt = dataclasses.asdict(cj), dataclasses.asdict(ct)
    assert dj == dt
    assert jllama.param_shapes(cj) == tllama.param_shapes(ct)
    buckets = tcfg.EngineConfig().prefill_buckets
    assert buckets == jcfg.EngineConfig().prefill_buckets
    assert tcfg.pick_bucket(3000, buckets) == jcfg.pick_bucket(3000, buckets) == 4096
    assert tcfg.round_up(1000, 128) == jcfg.round_up(1000, 128) == 1024


@pytest.mark.parametrize("scaled", [False, True])
def test_rope_matches_jax(scaled):
    kw = dict(head_dim=64, rope_theta=500000.0)
    if scaled:
        cj = jcfg.ModelConfig.tiny(rope_scaling=jcfg.RopeScaling(factor=8.0), **kw)
        ct = tcfg.ModelConfig.tiny(rope_scaling=tcfg.RopeScaling(factor=8.0), **kw)
    else:
        cj, ct = jcfg.ModelConfig.tiny(**kw), tcfg.ModelConfig.tiny(**kw)
    fj, ft = jrope.compute_inv_freq(cj), trope.compute_inv_freq(ct)
    np.testing.assert_array_equal(fj, ft)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 10, 64)).astype(np.float32)
    pos = rng.integers(0, 100000, (2, 10)).astype(np.int32)
    cj_, sj_ = jrope.rope_cos_sin(jnp.asarray(pos), jnp.asarray(fj))
    out_j = np.asarray(jrope.apply_rope(jnp.asarray(x), cj_, sj_))
    ct_, st_ = trope.rope_cos_sin(torch.from_numpy(pos), torch.from_numpy(ft))
    out_t = trope.apply_rope(torch.from_numpy(x), ct_, st_).numpy()
    np.testing.assert_allclose(out_t, out_j, atol=ATOL, rtol=1e-5)


@pytest.fixture(scope="module")
def tiny_params():
    cj, ct = jcfg.ModelConfig.tiny(), tcfg.ModelConfig.tiny()
    pj = jllama.init_params(cj, seed=3)
    pt = tllama.params_from_numpy(ct, jax.tree_util.tree_map(np.asarray, pj), device="cpu")
    return cj, ct, pj, pt


def _lp(params, l, kind):
    if kind == "jax":
        return jax.tree_util.tree_map(lambda x: x[l], params["layers"])
    return tllama.layer_params(params, l)


@pytest.mark.parametrize(
    "block", ["rms_norm", "qkv_proj", "rope_qk", "mlp", "attn_out_proj", "embed", "unembed"])
def test_llama_blocks_match_jax(tiny_params, block):
    cj, ct, pj, pt = tiny_params
    rng = np.random.default_rng(11)
    b, s = 2, 12
    x = rng.standard_normal((b, s, cj.hidden_size)).astype(np.float32)
    lj, lt = _lp(pj, 1, "jax"), _lp(pt, 1, "torch")
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    if block == "rms_norm":
        outs = [(jllama.rms_norm(xj, lj["ln_attn"], cj.rms_norm_eps),
                 tllama.rms_norm(xt, lt["ln_attn"], ct.rms_norm_eps))]
    elif block == "qkv_proj":
        outs = list(zip(jllama.qkv_proj(lj, cj, xj), tllama.qkv_proj(lt, ct, xt)))
    elif block == "rope_qk":
        qj, kj, _ = jllama.qkv_proj(lj, cj, xj)
        qt, kt, _ = tllama.qkv_proj(lt, ct, xt)
        pos = rng.integers(0, 4000, (b, s)).astype(np.int32)
        fj = jnp.asarray(jrope.compute_inv_freq(cj))
        ft = torch.from_numpy(trope.compute_inv_freq(ct))
        outs = list(zip(jllama.rope_qk(qj, kj, jnp.asarray(pos), fj),
                        tllama.rope_qk(qt, kt, torch.from_numpy(pos), ft)))
    elif block == "mlp":
        outs = [(jllama.mlp(lj, xj), tllama.mlp(lt, xt))]
    elif block == "attn_out_proj":
        a = rng.standard_normal((b, cj.num_heads, s, cj.head_dim)).astype(np.float32)
        outs = [(jllama.attn_out_proj(lj, jnp.asarray(a)),
                 tllama.attn_out_proj(lt, torch.from_numpy(a)))]
    elif block == "embed":
        tok = rng.integers(0, cj.vocab_size, (b, s)).astype(np.int32)
        outs = [(jllama.embed(pj, cj, jnp.asarray(tok)),
                 tllama.embed(pt, ct, torch.from_numpy(tok)))]
    else:
        outs = [(jllama.unembed(pj, cj, xj), tllama.unembed(pt, ct, xt))]
    for oj, ot in outs:
        assert tuple(oj.shape) == tuple(ot.shape)
        np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=ATOL, rtol=1e-5)


def test_init_params_on_cpu_when_asked():
    cfg = tcfg.ModelConfig.tiny()
    p = tllama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                           dtype=torch.bfloat16)
    for name, shp in tllama.param_shapes(cfg).items():
        t = p["layers"][name[7:]] if name.startswith("layers.") else p[name]
        assert tuple(t.shape) == shp
        norm = name.endswith("norm") or "ln_" in name
        assert t.dtype == (torch.float32 if norm else torch.bfloat16)
    assert abs(float(p["layers"]["wq"].float().std()) - 0.02) < 2e-3
    again = tllama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                               dtype=torch.bfloat16)
    assert torch.equal(p["embed"], again["embed"])
