"""A decode step's residual add and RMSNorm (``ops.add_rms_norm``) on the CPU.

On a CPU tensor each form runs its plain version; the card's kernel is held
to that plain version in tests/test_torch_cuda.py. Here the plain versions
are held, bit for bit, to the composition the decode layer ran before the
norm sites had a kernel (written out below as ``_parent_*``): ``h + delta``
and the float32 RMSNorm, in float32 and bf16, at b 1 and 8, a tiny width and
2048. And ``decode_step`` over both tiny families, whose layers now run
``models.family.decode_layer`` with the two forms, gives the parent layer's
logits and cache exactly over 4 greedy steps.
"""

import pytest
import torch

from fastkv_tpu_torch.core.config import (DeepSeekV2Config, EngineConfig, Method, MethodConfig,
                                          ModelConfig)
from fastkv_tpu_torch.engine import decode as dm
from fastkv_tpu_torch.engine import prefill as pm
from fastkv_tpu_torch.models import deepseek_v2 as ds
from fastkv_tpu_torch.models import family, llama
from fastkv_tpu_torch.models.rope import compute_inv_freq
from fastkv_tpu_torch.ops import add_rms_norm as arn
from fastkv_tpu_torch.utils import guards
from fastkv_tpu_torch.utils.testing import one_thread_per_module

_one_torch_thread = one_thread_per_module()


def _parent_rms_norm(x, w, eps):
    """The parent's ``models.llama.rms_norm``."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * w.to(torch.float32)).to(x.dtype)


def _equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want)


@pytest.mark.parametrize("D", [64, 2048])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["rms_norm", "add_rms_norm"])
def test_plain_forms_are_the_parent_composition(form, dtype, b, D):
    """Both forms on CPU tensors: the residual is ``h + delta`` and the norm
    the parent's RMSNorm, bit for bit; ``llama.rms_norm`` (prefill's and the
    head's) is the same function; nothing is launched."""
    gen = torch.Generator().manual_seed(b * 1000 + D)
    h = (torch.randn((b, 1, D), generator=gen) * 3).to(dtype)
    delta = torch.randn((b, 1, D), generator=gen).to(dtype)
    w = torch.rand((D,), generator=gen) + 0.5
    eps = 1e-5
    before = arn.launches
    if form == "rms_norm":
        _equal(arn.rms_norm(h, w, eps), _parent_rms_norm(h, w, eps))
    else:
        got_h, got_hn = arn.add_rms_norm(h, delta, w, eps)
        want_h = h + delta
        _equal(got_h, want_h)
        _equal(got_hn, _parent_rms_norm(want_h, w, eps))
    _equal(llama.rms_norm(h, w, eps), _parent_rms_norm(h, w, eps))
    assert arn.launches == before


def _parent_decode_layer(lp, cfg, h, pos, inv_freq, cache, i, slot, rows=None, *, mask=None,
                         attend=None, tp=None):
    """The parent's ``models.family.decode_layer``: the residual adds and the
    norms as separate PyTorch operations."""
    fam = family.of(cfg)
    hn = _parent_rms_norm(h, lp["ln_attn"], cfg.rms_norm_eps)
    q = fam.decode_qkv(lp, cfg, hn, pos, inv_freq, cache, i, slot, rows)
    if attend is None:
        attn, aux = fam.decode_attention(lp, cfg, q, cache, i, mask), None
    else:
        attn, aux = attend(q)
    h = h + llama.attn_out_proj(lp, attn, tp)
    h = h + fam.decode_ffn(lp, cfg, _parent_rms_norm(h, lp["ln_mlp"], cfg.rms_norm_eps), tp)
    guards.finite("hidden states", h)
    return h, aux


# name: (config, engine kw)
STEP_CASES = {
    "llama_float32": (ModelConfig.tiny(), {}),
    "llama_bfloat16": (ModelConfig.tiny(dtype="bfloat16"), {}),
    "llama_kv_int8": (ModelConfig.tiny(), {"kv_int8": True}),
    "deepseek_v2_float32": (DeepSeekV2Config.tiny(), {}),
}


def _steps(name: str, per_row: bool, parent: bool, monkeypatch):
    """Prefill two tiny prompts (FastKV), then 4 greedy ``decode_step``s ->
    (each step's logits, the cache after)."""
    cfg, ekw = STEP_CASES[name]
    gen = torch.Generator().manual_seed(0)
    if cfg.kind == "deepseek_v2":
        params = ds.init_params(cfg, gen, device="cpu", std=0.3)
    else:
        params = llama.init_params(cfg, gen, device="cpu")
    mcfg = MethodConfig(method=Method.FASTKV, tsp_idx=1)
    ecfg = EngineConfig(prefill_buckets=(128,), capacity_align=8, max_new_tokens=8, **ekw)
    shapes = pm.plan_shapes(cfg, mcfg, ecfg, 128)
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), generator=torch.Generator().manual_seed(3),
                           dtype=torch.int32)
    n_true = torch.tensor([128, 97], dtype=torch.int32)
    inv_freq = torch.from_numpy(compute_inv_freq(cfg))
    with monkeypatch.context() as mp:
        if parent:
            mp.setattr(family, "decode_layer", _parent_decode_layer)
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
    return out, cache


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("name", list(STEP_CASES))
def test_decode_layer_is_the_parent_layer(name, per_row, monkeypatch):
    """``decode_step`` through ``family.decode_layer`` (the two forms) and
    through the parent's layer: every step's logits and every cache field
    equal, bit for bit."""
    got, got_cache = _steps(name, per_row, False, monkeypatch)
    want, want_cache = _steps(name, per_row, True, monkeypatch)
    for a, b in zip(got, want):
        _equal(a, b)
    for (field, a), (_, b) in zip(got_cache.fields(), want_cache.fields()):
        assert torch.equal(a, b), field


def test_the_norm_kernel_imports_no_model_family():
    """``ops.add_rms_norm`` is below the models layer: ``models.llama`` takes
    its RMSNorm from it, not it from the families."""
    import ast
    import inspect

    imported = set()
    for node in ast.walk(ast.parse(inspect.getsource(arn))):
        if isinstance(node, ast.ImportFrom):
            imported |= {f"{node.module}.{a.name}" for a in node.names} | {node.module}
        elif isinstance(node, ast.Import):
            imported |= {a.name for a in node.names}
    assert not {m for m in imported if m.startswith("fastkv_tpu_torch.models")}
    assert llama.rms_norm is arn.rms_norm_plain
