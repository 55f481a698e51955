"""Port parity for the pieces of chunked admission, against the JAX package.

The same inputs, made with numpy from a seed, go through the JAX package and
the PyTorch port on the CPU, in float32, on the tiny config (4 layers) at the
settings of tests/test_chunked.py (proportional, retain 0.3, tsp 0.5, tsp_idx
1, window 8, maxpool, bucket 256, capacity_align 8):

  * the flash kernel's rectangular form (a chunk of queries against a longer
    key scratch, ``k_positions``/``k_count``/``k_hi``): the port's plain
    version against the JAX Pallas kernel in interpret mode and against its
    XLA reference, with and without a sliding window, 2e-5 (only the order of
    summation differs); with ``k_hi`` below the key count, against the XLA
    reference over keys below ``k_hi`` (the port's stated semantics);
  * ``decode_step`` with one cache slot per example (a [b] slot tensor)
    against the JAX one: logits 1e-4, K 1e-5, positions and validity equal;
  * the chunk pipeline (``chunked.advance`` to its finish) against JAX
    ``chunked.advance`` with ``use_pallas=False``, for FullKV, FastKV, SnapKV
    and StreamingLLM, and FastKV under a sliding window: logits 1e-4, cache
    K/V 1e-5, positions and validity equal; and against the port's own
    monolithic prefill.

Each JAX result is computed once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fastkv_tpu.core import config as jcfg
from fastkv_tpu.engine import chunked as jchunked
from fastkv_tpu.engine import decode as jdec
from fastkv_tpu.engine import prefill as jpm
from fastkv_tpu.models.llama import init_params as j_init_params
from fastkv_tpu.ops import attention as jatt
from fastkv_tpu.ops.flash_prefill import flash_attention as j_pallas_flash
from fastkv_tpu_torch.core import config as tcfg
from fastkv_tpu_torch.engine import chunked as tchunked
from fastkv_tpu_torch.engine import decode as tdec
from fastkv_tpu_torch.engine import prefill as tpm
from fastkv_tpu_torch.models.llama import params_from_numpy
from fastkv_tpu_torch.ops import flash_prefill as tfp
from fastkv_tpu_torch.utils.testing import one_thread_per_module

_one_torch_thread = one_thread_per_module()

ATOL_FLASH = 2e-5
BUCKET, CHUNK, N_PROMPT = 256, 64, 201  # 201: a partial last chunk


# ---------------------------------------------------------------------------
# the flash kernel's rectangular form
# ---------------------------------------------------------------------------

RECT_CASES = {
    # name: (b, H, KH, d, S, c, starts, prompt lengths, window)
    "chunk_256_of_470": (1, 4, 2, 64, 512, 128, [256], [470], None),
    "chunk_256_of_470_w100": (1, 4, 2, 64, 512, 128, [256], [470], 100),
    "ragged_b2_d128": (2, 4, 2, 128, 384, 128, [128, 256], [200, 384], None),
    "ragged_b2_w40": (2, 4, 2, 64, 384, 128, [0, 256], [100, 300], 40),
}


def _rect_inputs(b, h, kh, d, S, c, starts, lens, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, c, d)).astype(np.float32)
    k = rng.standard_normal((b, kh, S, d)).astype(np.float32)
    v = rng.standard_normal((b, kh, S, d)).astype(np.float32)
    qpos = (np.asarray(starts, np.int32)[:, None] + np.arange(c, dtype=np.int32)).astype(np.int32)
    kpos = np.broadcast_to(np.arange(S, dtype=np.int32), (b, S)).copy()
    kv_count = np.minimum(np.asarray(starts) + c, lens).astype(np.int32)
    return q, k, v, qpos, kpos, kv_count


@pytest.mark.parametrize("case", sorted(RECT_CASES))
def test_rect_flash_plain_matches_jax(case):
    b, h, kh, d, S, c, starts, lens, window = RECT_CASES[case]
    q, k, v, qpos, kpos, cnt = _rect_inputs(b, h, kh, d, S, c, starts, lens, seed=len(case))
    t = [torch.from_numpy(x) for x in (q, k, v, qpos, kpos, cnt)]
    out = tfp.flash_attention(t[0], t[1], t[2], t[3], t[5], sliding_window=window,
                              k_positions=t[4], k_count=t[5], k_hi=t[5]).numpy()
    jq, jk, jv, jqp, jkp, jc = (jnp.asarray(x) for x in (q, k, v, qpos, kpos, cnt))
    ref = np.asarray(jatt.chunked_causal_attention(
        jq, jk, jv, jqp, jkp, jkp < jc[:, None], sliding_window=window, q_block=64))
    np.testing.assert_allclose(out, ref, atol=ATOL_FLASH, rtol=ATOL_FLASH)
    with pltpu.force_tpu_interpret_mode():
        pal = np.asarray(j_pallas_flash(jq, jk, jv, jqp, jc, sliding_window=window,
                                        block_q=128, block_k=128, k_positions=jkp,
                                        k_count=jc, k_hi=jc))
    np.testing.assert_allclose(out, pal, atol=ATOL_FLASH, rtol=ATOL_FLASH)


def test_rect_flash_keys_from_k_hi_on_are_invalid():
    """Below the key count, k_hi cuts the keys by index, whatever the tiling:
    the plain version equals the XLA reference over keys below min(count,
    k_hi), and a k_hi at or above the count changes nothing."""
    q, k, v, qpos, kpos, cnt = _rect_inputs(2, 4, 2, 64, 384, 128, [128, 256], [250, 384], 5)
    t = [torch.from_numpy(x) for x in (q, k, v, qpos, kpos, cnt)]
    k_hi = torch.tensor([200, 300], dtype=torch.int32)
    out = tfp.flash_attention(t[0], t[1], t[2], t[3], t[5], k_positions=t[4], k_count=t[5],
                              k_hi=k_hi).numpy()
    jkp = jnp.asarray(kpos)
    ref = np.asarray(jatt.chunked_causal_attention(
        *(jnp.asarray(x) for x in (q, k, v, qpos)), jkp,
        jkp < jnp.asarray([200, 300])[:, None], q_block=64))
    np.testing.assert_allclose(out, ref, atol=ATOL_FLASH, rtol=ATOL_FLASH)
    above = tfp.flash_attention(t[0], t[1], t[2], t[3], t[5], k_positions=t[4], k_count=t[5],
                                k_hi=t[5] + 1000)
    ungated = tfp.flash_attention(t[0], t[1], t[2], t[3], t[5], k_positions=t[4], k_count=t[5])
    torch.testing.assert_close(above, ungated, atol=0, rtol=0)


def test_rect_flash_wrapper_checks_shapes():
    q = torch.randn(1, 4, 8, 64)
    k = torch.randn(1, 2, 32, 64)
    pos = torch.arange(8, dtype=torch.int32)[None]
    cnt = torch.tensor([8], dtype=torch.int32)
    with pytest.raises(ValueError, match="k_positions"):
        tfp.flash_attention(q, k, k, pos, cnt)
    kpos = torch.arange(32, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="k_positions"):
        tfp.flash_attention(q, k, k, pos, cnt, k_positions=kpos[:, :16])
    with pytest.raises(ValueError, match="k_hi"):
        tfp.flash_attention(q, k, k, pos, cnt, k_positions=kpos, k_hi=cnt[None])


# ---------------------------------------------------------------------------
# the tiny model in both packages
# ---------------------------------------------------------------------------

def _mcfgs(method, **kw):
    kw = dict(eviction_mode="proportional", retain_rate=0.3, tsp_rate=0.5, tsp_idx=1,
              window_size=8, **kw)
    return (jcfg.MethodConfig(method=jcfg.Method(method), **kw),
            tcfg.MethodConfig(method=tcfg.Method(method), **kw))


def _ecfgs(**kw):
    return (jcfg.EngineConfig(prefill_buckets=(BUCKET,), use_pallas=False, capacity_align=8, **kw),
            tcfg.EngineConfig(prefill_buckets=(BUCKET,), capacity_align=8, **kw))


def _models(**cfg_kw):
    cj, ct = jcfg.ModelConfig.tiny(**cfg_kw), tcfg.ModelConfig.tiny(**cfg_kw)
    pj = j_init_params(cj, seed=0)
    pt = params_from_numpy(ct, jax.tree_util.tree_map(np.asarray, pj), device="cpu")
    return cj, ct, pj, pt


@pytest.fixture(scope="module")
def tiny():
    return _models()


@pytest.fixture(scope="module")
def tiny_window():
    return _models(sliding_window=64)


def _assert_cache_close(cache_t, cache_j, atol=1e-5):
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(cache_t, name).numpy(),
                                   np.asarray(getattr(cache_j, name)), atol=atol, rtol=atol)
    np.testing.assert_array_equal(cache_t.pos.numpy(), np.asarray(cache_j.pos))
    np.testing.assert_array_equal(cache_t.valid.numpy(), np.asarray(cache_j.valid))


# ---------------------------------------------------------------------------
# decode_step with one slot per example
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["fastkv", "snapkv"])
def test_decode_step_per_example_slots_match_jax(tiny, method):
    cj, ct, pj, pt = tiny
    mj, mt = _mcfgs(method)
    ej, et = _ecfgs(max_new_tokens=16)
    rng = np.random.default_rng(2)
    lens = np.asarray([201, 90, 256], np.int32)
    tokens = np.zeros((3, BUCKET), np.int32)
    for i, n in enumerate(lens):
        tokens[i, :n] = rng.integers(0, cj.vocab_size, n)
    sj = jpm.plan_shapes(cj, mj, ej, BUCKET)
    st = tpm.plan_shapes(ct, mt, et, BUCKET)
    lj, cache_j = jpm.prefill(pj, cj, mj, ej, sj, jnp.asarray(tokens), jnp.asarray(lens))
    _, cache_t = tpm.prefill(pt, ct, mt, st, torch.from_numpy(tokens), torch.from_numpy(lens))
    tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    steps = np.asarray([3, 0, 5], np.int32)  # each example at its own depth
    slots = sj.prefill_capacity + steps
    dj, cache_j = jdec.decode_step(pj, cj, mj, cache_j, jnp.asarray(tok),
                                   jnp.asarray(lens + steps), jnp.asarray(slots))
    dt, cache_t = tdec.decode_step(pt, ct, mt, cache_t, torch.from_numpy(tok),
                                   torch.from_numpy(lens + steps), torch.from_numpy(slots))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-4, rtol=1e-4)
    _assert_cache_close(cache_t, cache_j)
    # each example's new entry sits at its own slot, in every layer and cache head
    for i in range(3):
        assert bool(cache_t.valid[:, i, :, slots[i]].all())
        assert bool((cache_t.pos[:, i, :, slots[i]] == lens[i] + steps[i]).all())


# ---------------------------------------------------------------------------
# the chunk pipeline
# ---------------------------------------------------------------------------

PIPELINE_CASES = {
    "fullkv": ("fullkv", False),
    "fastkv": ("fastkv", False),
    "snapkv": ("snapkv", False),
    "streamingllm": ("streamingllm", False),
    "fastkv_window": ("fastkv", True),
}


def _prompt(cfg):
    return np.random.default_rng(3).integers(0, cfg.vocab_size, N_PROMPT).tolist()


def _jax_pipeline(cj, pj, method):
    mj, _ = _mcfgs(method)
    ej, _ = _ecfgs()
    progs = jchunked.make_programs(cj, mj, ej, jpm.plan_shapes(cj, mj, ej, BUCKET), chunk=CHUNK)
    adm = jchunked.start_admission(progs, slot=0, req=None, prompt=_prompt(cj))
    out, steps = None, 0
    while out is None:
        out = jchunked.advance(progs, pj, adm)
        steps += 1
    return out, steps


def _port_pipeline(ct, pt, method):
    _, mt = _mcfgs(method)
    _, et = _ecfgs()
    progs = tchunked.make_programs(ct, mt, tpm.plan_shapes(ct, mt, et, BUCKET), chunk=CHUNK)
    adm = tchunked.start_admission(progs, pt, slot=0, req=None, prompt=_prompt(ct))
    out, steps = None, 0
    while out is None:
        out = tchunked.advance(pt, adm)
        steps += 1
    return out, steps


@pytest.fixture(scope="module")
def jax_pipelines(tiny, tiny_window):
    """The JAX chunk pipeline's (logits, cache) per case, computed once."""
    res = {}
    for name, (method, window) in PIPELINE_CASES.items():
        cj, _, pj, _ = tiny_window if window else tiny
        res[name] = _jax_pipeline(cj, pj, method)
    return res


@pytest.mark.parametrize("case", sorted(PIPELINE_CASES))
def test_chunk_pipeline_matches_jax(tiny, tiny_window, jax_pipelines, case):
    method, window = PIPELINE_CASES[case]
    _, ct, _, pt = tiny_window if window else tiny
    (lt, cache_t), steps = _port_pipeline(ct, pt, method)
    (lj, cache_j), steps_j = jax_pipelines[case]
    assert steps == steps_j == -(-N_PROMPT // CHUNK)  # pad chunks past n are skipped
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, rtol=1e-4)
    _assert_cache_close(cache_t, cache_j)


@pytest.mark.parametrize("case", sorted(PIPELINE_CASES))
def test_chunk_pipeline_matches_monolithic_prefill(tiny, tiny_window, case):
    """The port's chunk pipeline against the port's own monolithic prefill:
    the same keep-sets (positions, validity) and values within float32 order."""
    method, window = PIPELINE_CASES[case]
    _, ct, _, pt = tiny_window if window else tiny
    _, mt = _mcfgs(method)
    _, et = _ecfgs()
    tokens = np.zeros((1, BUCKET), np.int32)
    tokens[0, :N_PROMPT] = _prompt(ct)
    lm, cache_m = tpm.prefill(pt, ct, mt, tpm.plan_shapes(ct, mt, et, BUCKET),
                              torch.from_numpy(tokens), torch.tensor([N_PROMPT], dtype=torch.int32))
    (lc, cache_c), _ = _port_pipeline(ct, pt, method)
    torch.testing.assert_close(lc, lm, atol=1e-4, rtol=1e-4)
    assert torch.equal(cache_c.pos, cache_m.pos) and torch.equal(cache_c.valid, cache_m.valid)
    torch.testing.assert_close(cache_c.k, cache_m.k, atol=1e-5, rtol=1e-5)


def test_make_programs_refuses_what_it_cannot_chunk(tiny):
    _, ct, _, _ = tiny
    _, et = _ecfgs()
    _, mt = _mcfgs("fastkv")
    shapes = tpm.plan_shapes(ct, mt, et, BUCKET)
    with pytest.raises(ValueError, match="divide"):
        tchunked.make_programs(ct, mt, shapes, chunk=100)
    _, mh = _mcfgs("h2o")
    with pytest.raises(ValueError, match="h2o"):
        tchunked.make_programs(ct, mh, shapes, chunk=CHUNK)
