"""Port parity for the chunked prefill MLP (``EngineConfig.mlp_chunk``).

  * ``EngineConfig.mlp_chunk_for`` equals the JAX package's over a table of
    prefill lengths and ``mlp_chunk`` values (auto, never, 32768, a
    non-divisor, tiny chunks; lengths below, at and above 131072);
  * ``models.llama.mlp(chunk=c)`` equals JAX's ``mlp(chunk=c)`` and the
    port's unchunked call within 1e-5 in float32, on the tiny width with s a
    multiple of c (and s not a multiple: no chunking);
  * a tiny prefill with an explicit ``mlp_chunk`` equals the unchunked one
    (logits within 1e-5, cache positions and validity exact) for FastKV, for
    GemFilter (pass 1 and pass 2) and for PyramidInfer, whose call sites pass
    the chunk; FastKV's also equals the JAX prefill with the same chunk.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastkv_tpu.core import config as jcfg
from fastkv_tpu.engine import prefill as jprefill
from fastkv_tpu.models import llama as jllama
from fastkv_tpu_torch.core import config as tcfg
from fastkv_tpu_torch.engine import gemfilter as tgem
from fastkv_tpu_torch.engine import prefill as tprefill
from fastkv_tpu_torch.models import llama as tllama
from fastkv_tpu_torch.utils.testing import one_thread_per_module

_one_torch_thread = one_thread_per_module()

ATOL = 1e-5
ROOT = Path(__file__).resolve().parents[1]
BUCKET = 256
LENGTHS = (230, 201, 140)


@pytest.mark.parametrize("mlp_chunk", [None, 0, 32768, 3000, 1, 2, 64])
def test_mlp_chunk_for_matches_jax(mlp_chunk):
    for s in (1, 2, 64, 100, 256, 4096, 32768, 65536, 98304, 131071, 131072, 196608, 262144):
        want = jcfg.EngineConfig(mlp_chunk=mlp_chunk).mlp_chunk_for(s)
        assert tcfg.EngineConfig(mlp_chunk=mlp_chunk).mlp_chunk_for(s) == want, (mlp_chunk, s)


def test_mlp_chunk_for_defaults():
    ecfg = tcfg.EngineConfig()
    assert ecfg.mlp_chunk is None
    assert ecfg.mlp_chunk_for(65536) == 0
    assert ecfg.mlp_chunk_for(131072) == 32768
    assert ecfg.mlp_chunk_for(196608) == 32768
    assert tcfg.EngineConfig(mlp_chunk=0).mlp_chunk_for(131072) == 0


@pytest.fixture(scope="module")
def tiny():
    cj, ct = jcfg.ModelConfig.tiny(), tcfg.ModelConfig.tiny()
    pj = jllama.init_params(cj, seed=0)
    pt = tllama.params_from_numpy(ct, jax.tree_util.tree_map(np.asarray, pj), device="cpu")
    return cj, ct, pj, pt


@pytest.mark.parametrize("s,chunk", [(256, 64), (192, 32), (96, 96), (100, 64)])
def test_mlp_chunk_matches_jax_and_unchunked(tiny, s, chunk):
    cj, ct, pj, pt = tiny
    x = np.random.default_rng(s).standard_normal((2, s, cj.hidden_size)).astype(np.float32)
    lpj = jax.tree_util.tree_map(lambda a: a[1], pj["layers"])
    lpt = tllama.layer_params(pt, 1)
    with torch.inference_mode():
        got = tllama.mlp(lpt, torch.from_numpy(x), chunk=chunk)
        whole = tllama.mlp(lpt, torch.from_numpy(x))
    want = np.asarray(jllama.mlp(lpj, jnp.asarray(x), chunk=chunk))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=ATOL, rtol=ATOL)


def test_mlp_chunk_writes_one_output(tiny, monkeypatch):
    """The chunks go into one preallocated output: no concatenation."""
    _, ct, _, pt = tiny
    calls = []
    monkeypatch.setattr(torch, "cat", lambda *a, **k: calls.append(1))
    x = torch.randn(1, 128, ct.hidden_size)
    with torch.inference_mode():
        out = tllama.mlp(tllama.layer_params(pt, 0), x, chunk=32)
    assert out.shape == x.shape and not calls


def _tokens(vocab):
    rng = np.random.default_rng(11)
    tokens = np.zeros((len(LENGTHS), BUCKET), np.int32)
    for i, n in enumerate(LENGTHS):
        tokens[i, :n] = rng.integers(0, vocab, n)
    return tokens, np.asarray(LENGTHS, np.int32)


METHODS = {
    "fastkv": dict(method="fastkv", eviction_mode="proportional", retain_rate=0.3,
                   tsp_rate=0.5, tsp_idx=1),
    "gemfilter": dict(method="gemfilter", eviction_mode="proportional", retain_rate=0.3,
                      filter_idx=2),
    "pyramidinfer": None,  # the shipped llama_35 config
}


def _method(name):
    if name == "pyramidinfer":
        path = ROOT / "fastkv_tpu_torch" / "configs" / "pyramidinfer" / "llama_35.json"
        return dataclasses.replace(tcfg.MethodConfig().with_pyramidinfer_json(str(path)),
                                   pyramid_exceed_length_to_compress=4)
    kw = dict(METHODS[name])
    return tcfg.MethodConfig(method=tcfg.Method(kw.pop("method")), **kw)


def _prefill(pt, ct, mcfg, ecfg, tokens, n):
    """The method's prefill as Engine.generate runs it -> (logits, cache)."""
    tok, cnt = torch.from_numpy(tokens), torch.from_numpy(n)
    if mcfg.method == tcfg.Method.GEMFILTER:
        shapes = tgem.pass2_shapes(ct, mcfg, ecfg, BUCKET)
        tok, cnt, _ = tgem.select_tokens(pt, ct, mcfg, ecfg, tok, cnt, shapes.bucket)
        mcfg = tgem.pass2_config(mcfg)
    else:
        shapes = tprefill.plan_shapes(ct, mcfg, ecfg, BUCKET)
    return tprefill.prefill(pt, ct, mcfg, shapes, tok, cnt, ecfg)


@pytest.mark.parametrize("name", sorted(METHODS))
def test_prefill_with_mlp_chunk_matches_unchunked(tiny, name, monkeypatch):
    _, ct, _, pt = tiny
    tokens, n = _tokens(ct.vocab_size)
    mcfg = _method(name)
    chunks = []
    mlp = tllama.mlp
    monkeypatch.setattr(tllama, "mlp", lambda lp, x, chunk=0: (chunks.append(chunk),
                                                               mlp(lp, x, chunk))[1])
    with torch.inference_mode():
        outs = {c: _prefill(pt, ct, mcfg, tcfg.EngineConfig(
            prefill_buckets=(BUCKET,), max_new_tokens=8, capacity_align=8, mlp_chunk=c),
            tokens, n) for c in (0, 32)}
    assert any(c > 1 for c in chunks), f"no layer of the prefill chunked its MLP: {chunks}"
    (l0, c0), (l1, c1) = outs[0], outs[32]
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), atol=ATOL, rtol=ATOL)
    assert torch.equal(c1.pos, c0.pos) and torch.equal(c1.valid, c0.valid)


def test_fastkv_prefill_with_mlp_chunk_matches_jax(tiny):
    cj, ct, pj, pt = tiny
    tokens, n = _tokens(ct.vocab_size)
    kw = {k: v for k, v in METHODS["fastkv"].items() if k != "method"}
    mj = jcfg.MethodConfig(method=jcfg.Method.FASTKV, **kw)
    ej = jcfg.EngineConfig(prefill_buckets=(BUCKET,), max_new_tokens=8, capacity_align=8,
                           use_pallas=False, mlp_chunk=32)
    et = tcfg.EngineConfig(prefill_buckets=(BUCKET,), max_new_tokens=8, capacity_align=8,
                           mlp_chunk=32)
    jl, jc = jprefill.prefill(pj, cj, mj, ej, jprefill.plan_shapes(cj, mj, ej, BUCKET),
                              jnp.asarray(tokens), jnp.asarray(n))
    with torch.inference_mode():
        tl, tc = _prefill(pt, ct, _method("fastkv"), et, tokens, n)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=ATOL)
    np.testing.assert_array_equal(tc.pos.numpy(), np.asarray(jc.pos))
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
