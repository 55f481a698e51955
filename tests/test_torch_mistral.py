"""Port parity on the Mistral family: a sliding window, and a query width that
differs from the hidden size.

The same inputs, made with numpy from a seed, go through the JAX package and
the PyTorch port on the CPU, in float32:

  * the flash kernel's plain version under a window against the JAX Pallas
    kernel in interpret mode and its XLA reference, on layout indices and on
    scattered ascending positions with counts below s (1e-5: only the order of
    summation differs; under a window the Pallas kernel writes 0 in rows that
    see no key, as the port does, so every row is compared);
  * prefill on ``tiny(sliding_window=48)`` (bucket 256, prompts of 150 and 40
    tokens) and on a Nemo-shaped tiny config (4 heads x head_dim 32 = 128
    query width over a hidden size of 64), FullKV and FastKV: last-token
    logits within 1e-4, cache k/v within 1e-5, positions and validity equal;
  * Engine.generate tokens exactly equal, decoding past the window;
  * decode's rank cut: a compressed cache shorter than the window keeps
    far-past entries visible, and a longer one is cut by entry rank;
  * a tiny HF ``MistralForCausalLM``, where ``transformers`` imports.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fastkv_tpu.core import config as jcfg
from fastkv_tpu.engine import decode as jdec
from fastkv_tpu.engine import prefill as jpm
from fastkv_tpu.engine.generate import Engine as JEngine
from fastkv_tpu.models import llama as jllama
from fastkv_tpu.ops import attention as jatt
from fastkv_tpu.ops.flash_prefill import flash_attention as j_pallas_flash
from fastkv_tpu_torch.cache.kv_cache import KVCache
from fastkv_tpu_torch.core import config as tcfg
from fastkv_tpu_torch.engine import decode as tdec
from fastkv_tpu_torch.engine import prefill as tpm
from fastkv_tpu_torch.engine.generate import Engine as TEngine
from fastkv_tpu_torch.models import llama as tllama
from fastkv_tpu_torch.ops import attention as tatt
from fastkv_tpu_torch.ops import flash_prefill as tfp
from fastkv_tpu_torch.policies import selection as tsel

WINDOW = 48  # far below the prompts, so the window bites in prefill and decode
BUCKET, MAX_NEW = 256, 16
LENGTHS = (150, 40)  # as tests/test_mistral_parity.py decodes them
MIN_REL_GAP = 1e-6  # top-k boundary margin, as in tests/test_torch_engine.py
ATOL = 1e-5

CONFIGS = {
    "window": dict(sliding_window=WINDOW),
    "nemo_shape": dict(head_dim=32),  # query width 4 x 32 = 128, hidden 64
}


# ---------------------------------------------------------------------------
# the flash kernel's plain version under a window
# ---------------------------------------------------------------------------

FLASH_CASES = {
    # name: (b, H, KH, s, d, counts, scattered positions, window)
    "layout_counts_200_150": (2, 4, 2, 200, 64, [200, 150], False, WINDOW),
    "scattered_counts_180_97": (2, 4, 2, 200, 64, [180, 97], True, WINDOW),
    "scattered_d128_window_17": (1, 4, 2, 128, 128, [111], True, 17),
    "layout_window_above_s": (1, 4, 2, 128, 64, [100], False, 300),
}


def _flash_inputs(b, h, kh, s, d, counts, scattered, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, kh, s, d)).astype(np.float32)
    v = rng.standard_normal((b, kh, s, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    if scattered:  # post-TSP layout: ascending kept positions, zero tail
        for i, n in enumerate(counts):
            pos[i, :n] = np.sort(rng.choice(4 * s, n, replace=False))
            pos[i, n:] = 0
    return q, k, v, pos, np.asarray(counts, np.int32)


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_window_matches_jax(case):
    b, h, kh, s, d, counts, scattered, window = FLASH_CASES[case]
    q, k, v, pos, cnt = _flash_inputs(b, h, kh, s, d, counts, scattered, seed=len(case))
    out = tfp.flash_attention(*map(torch.from_numpy, (q, k, v, pos, cnt)),
                              sliding_window=window).numpy()
    valid = np.arange(s)[None, :] < cnt[:, None]
    jargs = [jnp.asarray(x) for x in (q, k, v, pos)]
    ref = np.asarray(jatt.chunked_causal_attention(
        *jargs, jargs[3], jnp.asarray(valid), sliding_window=window, q_block=64))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=ATOL)
    with pltpu.force_tpu_interpret_mode():
        pal = np.asarray(j_pallas_flash(*jargs, jnp.asarray(cnt), sliding_window=window,
                                        block_q=128, block_k=128))
    np.testing.assert_allclose(out, pal, atol=ATOL, rtol=ATOL)
    if window < s:  # the band really cut keys that causality alone would show
        causal = tfp.flash_attention(*map(torch.from_numpy, (q, k, v, pos, cnt))).numpy()
        assert np.abs(causal - out).max() > 1e-2


def test_flash_work_counts_the_band_pairs():
    """chip_smoke.py's bound counts the (query, key) pairs of this call's mask,
    and the bytes of q, k, v and positions over each example's ``count``
    rows (the rows past it see no key and are written as 0), the output's
    over all s; with every row valid that is each whole tensor."""
    import chip_smoke

    q, k, v, pos, cnt = map(torch.from_numpy, _flash_inputs(
        2, 4, 2, 200, 64, [180, 97], True, seed=3))
    rows = 180 + 97
    for window in (None, 1, 17, 1000):
        mask = tatt.causal_mask_from_positions(
            pos, pos, torch.arange(200)[None] < cnt[:, None], window)
        flops, nbytes = chip_smoke.flash_work(q, k, v, pos, cnt, window)
        assert flops == 4 * 64 * 4 * int(mask.sum())
        assert nbytes == 4 * 64 * (rows * (4 + 2 * 2) + q.numel() // 64) + 8 * rows
    full = torch.full((2,), 200, dtype=torch.int32)
    _, nbytes = chip_smoke.flash_work(q, k, v, pos, full)
    assert nbytes == 4 * (2 * q.numel() + k.numel() + v.numel()) + 8 * pos.numel()


# ---------------------------------------------------------------------------
# prefill, decode and Engine.generate against the JAX package
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model(name):
    cj = jcfg.ModelConfig.tiny(**CONFIGS[name])
    ct = tcfg.ModelConfig.tiny(**CONFIGS[name])
    pj = jllama.init_params(cj, seed=1)
    pt = tllama.params_from_numpy(ct, jax.tree_util.tree_map(np.asarray, pj), device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cj.vocab_size, n).tolist() for n in LENGTHS]
    tokens = np.zeros((len(prompts), BUCKET), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, : len(p)] = p
    return cj, ct, pj, pt, prompts, tokens, np.asarray(LENGTHS, np.int32)


def _configs(method):
    kw = dict(eviction_mode="proportional", retain_rate=0.3, tsp_rate=0.5, tsp_idx=1,
              pooling="maxpool")
    mj = jcfg.MethodConfig(method=jcfg.Method(method), **kw)
    mt = tcfg.MethodConfig(method=tcfg.Method(method), **kw)
    ej = jcfg.EngineConfig(prefill_buckets=(BUCKET,), max_new_tokens=MAX_NEW,
                           use_pallas=False, capacity_align=8)
    et = tcfg.EngineConfig(prefill_buckets=(BUCKET,), max_new_tokens=MAX_NEW, capacity_align=8)
    return mj, mt, ej, et


@pytest.fixture
def gaps(monkeypatch):
    """Every top-k the port takes, with the margin at its boundary: a near tie
    that float32 rounding could flip would make the parity a matter of luck."""
    from test_torch_engine import boundary_gap

    seen = []
    real = tsel.topk_select

    def recording(scores, selectable, k_budget, capacity):
        seen.append(boundary_gap(scores, selectable, k_budget))
        return real(scores, selectable, k_budget, capacity)

    monkeypatch.setattr(tsel, "topk_select", recording)
    return seen


def test_the_configs_are_the_shapes_asked_for():
    cw, cn = _model("window")[1], _model("nemo_shape")[1]
    assert cw.sliding_window == WINDOW < min(LENGTHS) + MAX_NEW
    assert cn.sliding_window is None
    assert cn.num_heads * cn.head_dim == 128 != cn.hidden_size == 64
    assert tllama.param_shapes(cn)["layers.wq"] == (cn.num_layers, 64, 128)


@pytest.mark.parametrize("method", ["fullkv", "fastkv"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_matches_jax(gaps, name, method):
    cj, ct, pj, pt, _, tokens, n = _model(name)
    mj, mt, ej, et = _configs(method)
    sj = jpm.plan_shapes(cj, mj, ej, BUCKET)
    st = tpm.plan_shapes(ct, mt, et, BUCKET)
    j_prefill = jax.jit(jpm.prefill, static_argnums=(1, 2, 3, 4))
    lj, cache_j = j_prefill(pj, cj, mj, ej, sj, jnp.asarray(tokens), jnp.asarray(n))
    lt, cache_t = tpm.prefill(pt, ct, mt, st, torch.from_numpy(tokens), torch.from_numpy(n))
    if method == "fastkv":
        assert len(gaps) == ct.num_layers + 1  # one per layer, plus TSP
        assert min(gaps) > MIN_REL_GAP
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, rtol=1e-4)
    for field in ("k", "v"):
        np.testing.assert_allclose(getattr(cache_t, field).numpy(),
                                   np.asarray(getattr(cache_j, field)), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(cache_t.pos.numpy(), np.asarray(cache_j.pos))
    np.testing.assert_array_equal(cache_t.valid.numpy(), np.asarray(cache_j.valid))


@pytest.mark.parametrize("method", ["fullkv", "fastkv"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_generate_tokens_equal_jax(gaps, name, method):
    """Both prompts in one batch: the 40-token prompt decodes past the window
    (40 + 16 > 48), the 150-token one starts past it."""
    cj, ct, pj, pt, prompts, _, _ = _model(name)
    mj, mt, ej, et = _configs(method)
    got = TEngine(pt, ct, mt, et, device="cpu").generate(prompts, MAX_NEW)
    want = JEngine(pj, cj, mj, ej).generate(prompts, MAX_NEW)
    assert got == want
    assert [len(t) for t in got] == [MAX_NEW] * len(prompts)
    if method == "fastkv":
        assert min(gaps) > MIN_REL_GAP


def _short_cache(ct, kept, cap, seed):
    """A FullKV-layout cache whose first ``kept`` slots hold entries at
    positions 0..kept-1, as numpy arrays [L, b=1, KH, cap(, d)]."""
    rng = np.random.default_rng(seed)
    shape = (ct.num_layers, 1, ct.num_kv_heads, cap)
    live = np.arange(cap) < kept
    k = np.where(live[:, None], rng.standard_normal(shape + (ct.head_dim,)), 0).astype(np.float32)
    v = np.where(live[:, None], rng.standard_normal(shape + (ct.head_dim,)), 0).astype(np.float32)
    pos = np.broadcast_to(np.where(live, np.arange(cap), 0), shape).astype(np.int32)
    valid = np.broadcast_to(live, shape).copy()
    return k, v, pos, valid


@pytest.mark.parametrize("kept", [10, 60])
def test_decode_rank_cut_matches_jax(kept):
    """tests/test_mistral_parity.py:92-138 on the port. The current token sits
    at position 1000, far past every kept entry. With 10 entries (+1 new) the
    cache is shorter than the window and nothing is masked; with 60 the
    window keeps the last 48 entries by rank."""
    from fastkv_tpu.cache.kv_cache import KVCache as JKVCache

    cj, ct, pj, pt, _, _, _ = _model("window")
    arrays = _short_cache(ct, kept, 64, seed=5)
    tok, cur = np.array([7], np.int32), np.array([1000], np.int32)
    mt = tcfg.MethodConfig(method=tcfg.Method.FULLKV)
    mj = jcfg.MethodConfig(method=jcfg.Method.FULLKV)

    def port(cfg):
        cache = KVCache(*(torch.from_numpy(a.copy()) for a in arrays))
        return tdec.decode_step(pt, cfg, mt, cache, torch.from_numpy(tok),
                                torch.from_numpy(cur), kept)[0].numpy()

    windowed = port(ct)
    free = port(dataclasses.replace(ct, sliding_window=None))
    jcache = JKVCache(*(jnp.asarray(a) for a in arrays))
    j_step = jax.jit(jdec.decode_step, static_argnums=(1, 2))
    ref, _ = j_step(pj, cj, mj, jcache, jnp.asarray(tok), jnp.asarray(cur), jnp.int32(kept))
    np.testing.assert_allclose(windowed, np.asarray(ref), atol=1e-5, rtol=1e-5)
    if kept + 1 <= WINDOW:
        np.testing.assert_allclose(windowed, free, atol=1e-5, rtol=1e-5)
    else:
        assert np.abs(windowed - free).max() > 1e-3


def test_window_mask_cuts_by_rank_per_head():
    valid = torch.tensor([[[1, 0, 1, 1, 0, 1, 1], [0, 0, 1, 0, 0, 0, 1]]], dtype=torch.bool)
    got = tdec.window_mask(valid, 3)
    want = [[[0, 0, 0, 1, 0, 1, 1], [0, 0, 1, 0, 0, 0, 1]]]
    assert got.int().tolist() == want
    assert tdec.window_mask(valid, None) is valid


# ---------------------------------------------------------------------------
# a tiny HF MistralForCausalLM
# ---------------------------------------------------------------------------

def test_generate_matches_hf_mistral():
    """Prefill logits (2e-3, as tests/test_mistral_parity.py holds the JAX
    package) and greedy tokens exactly equal HF's sliding-window Mistral."""
    transformers = pytest.importorskip("transformers")
    ct = tcfg.ModelConfig.tiny(sliding_window=WINDOW)
    hf_cfg = transformers.MistralConfig(
        vocab_size=ct.vocab_size, hidden_size=ct.hidden_size,
        intermediate_size=ct.intermediate_size, num_hidden_layers=ct.num_layers,
        num_attention_heads=ct.num_heads, num_key_value_heads=ct.num_kv_heads,
        head_dim=ct.head_dim, max_position_embeddings=ct.max_position_embeddings,
        rms_norm_eps=ct.rms_norm_eps, rope_theta=ct.rope_theta, sliding_window=WINDOW,
        tie_word_embeddings=False, use_cache=True, attn_implementation="eager")
    torch.manual_seed(0)
    hf = transformers.MistralForCausalLM(hf_cfg).eval()
    cj = jcfg.ModelConfig.tiny(sliding_window=WINDOW)
    tree = jllama.params_from_hf_state_dict(cj, hf.state_dict(), dtype="float32")
    pt = tllama.params_from_numpy(ct, jax.tree_util.tree_map(np.asarray, tree), device="cpu")
    mt = tcfg.MethodConfig(method=tcfg.Method.FULLKV)
    et = tcfg.EngineConfig(prefill_buckets=(BUCKET,), max_new_tokens=MAX_NEW, capacity_align=8)
    # the prompts of tests/test_mistral_parity.py, which holds the JAX package
    ids = np.random.default_rng(1).integers(0, ct.vocab_size, size=(1, 150))
    with torch.no_grad():
        hf_logits = hf(torch.tensor(ids)).logits[0, -1].float().numpy()
    tokens = np.zeros((1, BUCKET), np.int32)
    tokens[0, :150] = ids[0]
    st = tpm.plan_shapes(ct, mt, et, BUCKET)
    logits, _ = tpm.prefill(pt, ct, mt, st, torch.from_numpy(tokens),
                            torch.tensor([150], dtype=torch.int32))
    np.testing.assert_allclose(logits[0].numpy(), hf_logits, atol=2e-3, rtol=1e-3)
    eng = TEngine(pt, ct, mt, et, device="cpu")
    rng = np.random.default_rng(2)
    for n, new in [(150, 16), (40, 12)]:
        ids = rng.integers(0, ct.vocab_size, size=(1, n))
        with torch.no_grad():
            out = hf.generate(torch.tensor(ids), max_new_tokens=new, do_sample=False,
                              num_beams=1, pad_token_id=0)
        assert eng.generate([ids[0].tolist()], new)[0] == out[0, n:].tolist(), n
