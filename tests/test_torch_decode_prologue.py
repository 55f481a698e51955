"""A decode layer's attention prologue (``ops.decode_prologue``) on the CPU.

On a CPU tensor each form runs its plain version; the card's kernel is held
to that plain version in tests/test_torch_cuda.py. Here the plain versions
are held, bit for bit, to the composition the decode step ran before the
prologue had a form of its own (written out below as ``_parent_*``):

  * ``rope_append``: ``rope_cos_sin`` at the position, ``apply_rope`` on q
    and k, each kv head repeated into CH / KH cache heads, the two
    ``_write_slot`` index-puts;
  * ``latent_prologue``: DeepSeek-V2's ``cos_sin`` (YaRN's mscale ratio in
    it), the latent's RMSNorm, the pair-layout RoPE of the shared key and
    of q's rope part, the two writes;

in float32 and bf16, with one int slot and with a slot per row, at g 1 and
4 and b 1 and 3. And ``decode_step`` over both tiny families (Llama's
FastKV, SnapKV and int8 caches, DeepSeek-V2's latent cache) gives the
parent's logits and cache, exactly, over 4 greedy steps.
"""

import dataclasses

import pytest
import torch

from fastkv_tpu_torch.core import quant
from fastkv_tpu_torch.core.config import (DeepSeekV2Config, EngineConfig, Method, MethodConfig,
                                          ModelConfig, yarn_mscale)
from fastkv_tpu_torch.engine import decode as dm
from fastkv_tpu_torch.engine import prefill as pm
from fastkv_tpu_torch.models import deepseek_v2 as ds
from fastkv_tpu_torch.models import family, llama
from fastkv_tpu_torch.models.rope import apply_rope, compute_inv_freq, rope_cos_sin
from fastkv_tpu_torch.ops import decode_prologue as dp
from fastkv_tpu_torch.utils.testing import one_thread_per_module

_one_torch_thread = one_thread_per_module()

C = 40  # cache slots


def _parent_write_slot(dst, src, slot):
    """The parent's ``engine.decode._write_slot``."""
    if isinstance(slot, int):
        dst[:, :, slot] = src
    else:
        dst.transpose(1, 2)[torch.arange(dst.shape[0]), slot] = src


def _parent_append(k_cache, v_cache, k_new, v_new, slot):
    g = k_cache.shape[1] // k_new.shape[1]
    if g > 1:
        k_new = k_new.repeat_interleave(g, dim=1)
        v_new = v_new.repeat_interleave(g, dim=1)
    _parent_write_slot(k_cache, k_new[:, :, 0], slot)
    _parent_write_slot(v_cache, v_new[:, :, 0], slot)


def _parent_rope_append(q, k, v, pos, inv_freq, k_cache, v_cache, slot):
    cos, sin = rope_cos_sin(pos[:, None], inv_freq)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    _parent_append(k_cache, v_cache, k, v, slot)
    return q


def _pair_rope(x, cos, sin):
    b, h, s, r = x.shape
    return apply_rope(x.reshape(b, h, s, r // 2, 2).transpose(-1, -2).reshape(b, h, s, r),
                      cos, sin)


def _parent_latent_prologue(cfg, q, kv_a, kv_norm, pos, inv_freq, k_cache, v_cache, slot):
    rs = cfg.rope_scaling
    cos, sin = rope_cos_sin(pos[:, None], inv_freq)
    m = yarn_mscale(rs.factor, rs.mscale) / yarn_mscale(rs.factor, rs.mscale_all_dim)
    if m != 1.0:
        cos, sin = cos * m, sin * m
    n, R = cfg.mla.qk_nope_head_dim, cfg.mla.kv_lora_rank
    latent = llama.rms_norm(kv_a[..., :R], kv_norm, cfg.rms_norm_eps)
    k_pe = _pair_rope(kv_a[..., None, R:].transpose(1, 2), cos, sin)
    q = torch.cat([q[..., :n], _pair_rope(q[..., n:], cos, sin)], dim=-1)
    _parent_append(k_cache, v_cache, latent[:, None], k_pe, slot)
    return q


def _slots(per_row: bool, b: int, gen):
    if not per_row:
        return 17
    return torch.randperm(C, generator=gen)[:b].to(torch.long)


def _randn(gen, dtype, *shape):
    return torch.randn(shape, generator=gen).to(dtype)


def _equal(got, want):
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_append_plain_is_the_parent_composition(dtype, per_row, g, b):
    gen = torch.Generator().manual_seed(b * 10 + g)
    H, KH, d = 8, 2, 16
    cfg = ModelConfig.tiny(num_heads=H, num_kv_heads=KH, head_dim=d, rope_theta=5e5)
    inv_freq = torch.from_numpy(compute_inv_freq(cfg))
    # projections' outputs as the step has them: [b, 1, heads x d] viewed [b, heads, 1, d]
    q = _randn(gen, dtype, b, 1, H * d).view(b, 1, H, d).transpose(1, 2)
    k = _randn(gen, dtype, b, 1, KH * d).view(b, 1, KH, d).transpose(1, 2)
    v = _randn(gen, dtype, b, 1, KH * d).view(b, 1, KH, d).transpose(1, 2)
    pos = torch.randint(0, 30000, (b,), generator=gen, dtype=torch.int32)
    slot = _slots(per_row, b, gen)
    caches = [_randn(gen, dtype, b, KH * g, C, d) for _ in range(2)]
    want = [c.clone() for c in caches]
    before = dp.launches
    q_got = dp.rope_append(q, k, v, pos, inv_freq, *caches, slot)
    q_want = _parent_rope_append(q, k, v, pos, inv_freq, *want, slot)
    _equal(q_got, q_want)
    for got, ref in zip(caches, want):
        _equal(got, ref)
    assert dp.launches == before


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mscale_all_dim", [0.707, 1.0])
def test_latent_prologue_plain_is_the_parent_composition(mscale_all_dim, dtype, per_row, b):
    """The tiny DeepSeek-V2 with YaRN (its mscale ratio 1, or not: 0.707
    against 1.0)."""
    gen = torch.Generator().manual_seed(b + 100)
    cfg = DeepSeekV2Config.tiny()
    cfg = dataclasses.replace(
        cfg, rope_scaling=dataclasses.replace(cfg.rope_scaling, mscale_all_dim=mscale_all_dim))
    assert (ds.rope_mscale(cfg) == 1.0) == (mscale_all_dim == 0.707)
    mla = cfg.mla
    n, r, R, H = mla.qk_nope_head_dim, mla.qk_rope_head_dim, mla.kv_lora_rank, cfg.num_heads
    inv_freq = torch.from_numpy(compute_inv_freq(cfg))
    q = _randn(gen, dtype, b, 1, H * (n + r)).view(b, 1, H, n + r).transpose(1, 2)
    kv_a = _randn(gen, dtype, b, 1, R + r)
    kv_norm = torch.rand(R, generator=gen) + 0.5
    pos = torch.randint(0, 300, (b,), generator=gen, dtype=torch.int32)
    slot = _slots(per_row, b, gen)
    caches = [_randn(gen, dtype, b, 1, C, R), _randn(gen, dtype, b, 1, C, r)]
    want = [c.clone() for c in caches]
    before = dp.launches
    q_got = dp.latent_prologue(q, kv_a, kv_norm, pos, inv_freq, *caches, slot,
                               eps=cfg.rms_norm_eps, mscale=ds.rope_mscale(cfg))
    q_want = _parent_latent_prologue(cfg, q, kv_a, kv_norm, pos, inv_freq, *want, slot)
    _equal(q_got, q_want)
    for got, ref in zip(caches, want):
        _equal(got, ref)
    assert dp.launches == before


def _parent_llama_decode_qkv(lp, cfg, hn, pos, inv_freq, cache, i, slot, rows=None):
    """The parent's Llama ``decode_qkv`` and the cache writes its
    ``decode_step`` made after it (int8 included)."""
    q, k, v = llama.qkv_proj(lp, cfg, hn)
    cos, sin = rope_cos_sin(pos[:, None], inv_freq)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    g = cache.k.shape[2] // cfg.num_kv_heads
    if g > 1:
        k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    if cache.k_scale is not None:
        k, k_sc = quant.quantize_kv(k)
        v, v_sc = quant.quantize_kv(v)
        _parent_write_slot(cache.k_scale[i], k_sc[:, :, 0], slot)
        _parent_write_slot(cache.v_scale[i], v_sc[:, :, 0], slot)
    _parent_write_slot(cache.k[i], k[:, :, 0], slot)
    _parent_write_slot(cache.v[i], v[:, :, 0], slot)
    return q


def _parent_latent_decode_qkv(lp, cfg, hn, pos, inv_freq, cache, i, slot, rows=None):
    b = hn.shape[0]
    q = llama.linear(lp, "wq", hn).view(b, 1, cfg.num_heads, -1).transpose(1, 2)
    kv_a = llama.linear(lp, "w_kv_a", hn)
    return _parent_latent_prologue(cfg, q, kv_a, lp["kv_norm"], pos, inv_freq, cache.k[i],
                                   cache.v[i], slot)


# name: (config, method, engine kw)
STEP_CASES = {
    "llama_fastkv": (ModelConfig.tiny(), Method.FASTKV, {}),
    "llama_snapkv": (ModelConfig.tiny(), Method.SNAPKV, {}),
    "llama_fastkv_kv_int8": (ModelConfig.tiny(), Method.FASTKV, {"kv_int8": True}),
    "deepseek_v2_fastkv": (DeepSeekV2Config.tiny(), Method.FASTKV, {}),
}


def _steps(name: str, per_row: bool, parent: bool, monkeypatch):
    """Prefill two tiny prompts, then 4 greedy ``decode_step``s -> (each
    step's logits, the cache after)."""
    cfg, method, ekw = STEP_CASES[name]
    fam = family.of(cfg)
    if cfg.kind == "deepseek_v2":
        params = ds.init_params(cfg, torch.Generator().manual_seed(0), device="cpu", std=0.3)
    else:
        params = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    mcfg = MethodConfig(method=method, tsp_idx=1)
    ecfg = EngineConfig(prefill_buckets=(128,), capacity_align=8, max_new_tokens=8, **ekw)
    shapes = pm.plan_shapes(cfg, mcfg, ecfg, 128)
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen, dtype=torch.int32)
    n_true = torch.tensor([128, 97], dtype=torch.int32)
    inv_freq = torch.from_numpy(compute_inv_freq(cfg))
    if parent:
        old = (_parent_latent_decode_qkv if cfg.kind == "deepseek_v2"
               else _parent_llama_decode_qkv)
        monkeypatch.setattr(fam, "decode_qkv", old)
    logits, cache = pm.prefill(params, cfg, mcfg, shapes, tokens, n_true, ecfg)
    out = []
    for t in range(4):
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        slot = shapes.prefill_capacity + t
        if per_row:  # each row a slot of its own, as the Scheduler's are
            slot = torch.tensor([slot, slot + 2])
        logits, cache = dm.decode_step(params, cfg, mcfg, cache, tok, n_true + t, slot,
                                       inv_freq)
        out.append(logits)
    monkeypatch.undo()
    return out, cache


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("name", list(STEP_CASES))
def test_decode_step_is_the_parent_step(name, per_row, monkeypatch):
    got, got_cache = _steps(name, per_row, False, monkeypatch)
    want, want_cache = _steps(name, per_row, True, monkeypatch)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert [n for n, _ in got_cache.fields()] == [n for n, _ in want_cache.fields()]
    for (field, a), (_, b) in zip(got_cache.fields(), want_cache.fields()):
        assert torch.equal(a, b), field


def test_latent_prologue_refuses_a_cache_of_more_than_one_head():
    """The MLA cache holds one latent head; the latent form writes that one."""
    cfg = DeepSeekV2Config.tiny()
    mla = cfg.mla
    n, r, R, H = mla.qk_nope_head_dim, mla.qk_rope_head_dim, mla.kv_lora_rank, cfg.num_heads
    q = torch.zeros(1, H, 1, n + r)
    inv_freq = torch.from_numpy(compute_inv_freq(cfg))
    with pytest.raises(ValueError, match="one head"):
        dp.latent_prologue(q, torch.zeros(1, 1, R + r), torch.ones(R),
                           torch.zeros(1, dtype=torch.int32), inv_freq,
                           torch.zeros(1, 2, C, R), torch.zeros(1, 2, C, r), 3,
                           eps=cfg.rms_norm_eps, mscale=1.0)


def test_the_prologue_imports_no_model_family():
    """``ops.decode_prologue`` is below the models layer: it takes RoPE from
    ``models.rope`` and the slot write from ``cache.kv_cache``, and the
    families call it, not it them."""
    import ast
    import inspect

    imported = set()
    for node in ast.walk(ast.parse(inspect.getsource(dp))):
        if isinstance(node, ast.ImportFrom):
            imported |= {f"{node.module}.{a.name}" for a in node.names} | {node.module}
        elif isinstance(node, ast.Import):
            imported |= {a.name for a in node.names}
    families = {"fastkv_tpu_torch.models.llama", "fastkv_tpu_torch.models.deepseek_v2",
                "fastkv_tpu_torch.models.family"}
    assert not imported & families, imported & families
