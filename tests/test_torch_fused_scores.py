"""Port parity for the fused observation-window scores, against the JAX package.

The same inputs, made with numpy from a seed, go through the JAX package and
the PyTorch port on the CPU, in float32:

  * the flash kernel's fused form (``window_q``/``window_q_pos``): the port's
    plain version against the JAX Pallas kernel in interpret mode, at the
    cases of tests/test_flash_kernel.py (W = 8 and 12, a ragged batch, a
    prompt shorter than the window), plus scattered post-TSP positions and a
    sliding window; 2e-5 (only the order of summation differs). The Pallas
    pure-causal path leaves finite garbage in rows that see no key, so its
    output is compared on valid rows only;
  * FastKV and SnapKV prefill and generate with
    ``EngineConfig(fuse_window_scores=True)`` against the JAX Engine with
    ``use_pallas=True, fuse_window_scores=True`` (its prefill in interpret
    mode), on the tiny config with and without a sliding window (48): tokens,
    cache positions and validity exactly equal, logits 2e-4;
  * the port's fused and unfused prefill against each other (equal
    keep-sets and cache): the fused scores are exact;
  * chunked admission's finish with the flag (FastKV's segment B fuses)
    against the JAX chunk pipeline with the same flag, its Pallas calls in
    interpret mode.

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
from fastkv_tpu.engine import prefill as jpm
from fastkv_tpu.engine.generate import Engine as JEngine
from fastkv_tpu.models.llama import init_params as j_init_params
from fastkv_tpu.ops.flash_prefill import flash_attention as j_pallas_flash
from fastkv_tpu_torch.core import config as tcfg
from fastkv_tpu_torch.engine import chunked as tchunked
from fastkv_tpu_torch.engine import prefill as tpm
from fastkv_tpu_torch.engine.generate import Engine
from fastkv_tpu_torch.models.llama import params_from_numpy
from fastkv_tpu_torch.ops import flash_prefill as tfp
from fastkv_tpu_torch.policies import selection as tsel
from fastkv_tpu_torch.utils.testing import one_thread_per_module

_one_torch_thread = one_thread_per_module()

ATOL = 2e-5
BUCKET, NEW = 256, 8

# ---------------------------------------------------------------------------
# the flash kernel's fused form
# ---------------------------------------------------------------------------

FLASH_CASES = {
    # name: (s, counts, W, scattered, sliding_window)
    "s256_full_w8": (256, [256], 8, False, None),
    "s384_ragged_w8": (384, [300, 130], 8, False, None),
    "s256_w12": (256, [256], 12, False, None),
    "s256_short_prompt": (256, [5], 8, False, None),
    "s256_scattered_w8": (256, [230, 256], 8, True, None),
    "s256_sliding_window_40": (256, [256, 200], 8, False, 40),
}


def _flash_inputs(s, counts, W, scattered, seed):
    b, h, kh, d = len(counts), 4, 2, 64
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, kh, s, d)).astype(np.float32)
    v = rng.standard_normal((b, kh, s, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    count = np.asarray(counts, np.int32)
    if scattered:  # post-TSP: ascending original positions, zero tail
        for i, n in enumerate(counts):
            pos[i, :n] = np.sort(rng.choice(3 * s, n, replace=False))
            pos[i, n:] = 0
    win_idx, win_valid = (x.numpy() for x in tsel.window_indices(
        torch.from_numpy(count - W), W, torch.from_numpy(count)))
    q_win = np.take_along_axis(q, win_idx[:, None, :, None], axis=2)
    qw_pos = np.where(win_valid, np.take_along_axis(pos, win_idx, axis=1), -1).astype(np.int32)
    return q, k, v, pos, count, q_win, qw_pos


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_fused_flash_plain_matches_pallas(case):
    s, counts, W, scattered, window = FLASH_CASES[case]
    q, k, v, pos, count, q_win, qw_pos = _flash_inputs(s, counts, W, scattered, len(case))
    out, scores = tfp.flash_attention(
        *(torch.from_numpy(x) for x in (q, k, v, pos, count)), sliding_window=window,
        window_q=torch.from_numpy(q_win), window_q_pos=torch.from_numpy(qw_pos))
    assert scores.shape == (len(counts), 4, s) and scores.dtype == torch.float32
    with pltpu.force_tpu_interpret_mode():
        j_out, j_scores = j_pallas_flash(
            *(jnp.asarray(x) for x in (q, k, v, pos, count)), sliding_window=window,
            block_q=128, block_k=128, window_q=jnp.asarray(q_win),
            window_q_pos=jnp.asarray(qw_pos))
    np.testing.assert_allclose(scores.numpy(), np.asarray(j_scores), atol=ATOL, rtol=ATOL)
    for i, n in enumerate(counts):
        np.testing.assert_allclose(out.numpy()[i, :, :n], np.asarray(j_out)[i, :, :n],
                                   atol=ATOL, rtol=ATOL)
    # the attention output is the unfused call's
    plain = tfp.flash_attention(*(torch.from_numpy(x) for x in (q, k, v, pos, count)),
                                sliding_window=window)
    torch.testing.assert_close(out, plain, atol=0, rtol=0)


def test_fused_flash_checks_its_arguments():
    q, k, v, pos, count, q_win, qw_pos = _flash_inputs(64, [64], 8, False, 0)
    t = [torch.from_numpy(x) for x in (q, k, v, pos, count, q_win, qw_pos)]
    with pytest.raises(ValueError, match="together"):
        tfp.flash_attention(*t[:5], window_q=t[5])
    with pytest.raises(ValueError, match="square"):
        tfp.flash_attention(*t[:5], k_positions=t[3], window_q=t[5], window_q_pos=t[6])
    with pytest.raises(ValueError, match="window_q"):
        tfp.flash_attention(*t[:5], window_q=t[5][:, :2], window_q_pos=t[6])


# ---------------------------------------------------------------------------
# the tiny model: prefill and generate
# ---------------------------------------------------------------------------

def _mcfgs(method):
    kw = dict(eviction_mode="proportional", retain_rate=0.3, tsp_rate=0.5, tsp_idx=1,
              window_size=8, pooling="maxpool")
    return (jcfg.MethodConfig(method=jcfg.Method(method), **kw),
            tcfg.MethodConfig(method=tcfg.Method(method), **kw))


def _ecfgs(fused=True, **kw):
    kw = dict(prefill_buckets=(BUCKET,), max_new_tokens=NEW, capacity_align=8,
              fuse_window_scores=fused, **kw)
    return jcfg.EngineConfig(use_pallas=True, **kw), tcfg.EngineConfig(**kw)


@pytest.fixture(scope="module")
def models():
    out = {}
    for window in (None, 48):
        cj, ct = jcfg.ModelConfig.tiny(sliding_window=window), tcfg.ModelConfig.tiny(
            sliding_window=window)
        pj = j_init_params(cj, seed=0)
        pt = params_from_numpy(ct, jax.tree_util.tree_map(np.asarray, pj), device="cpu")
        out[window] = (cj, ct, pj, pt)
    return out


PROMPT_LENS = (200, 131)  # both longer than the window, so it bites pre-TSP
RUNS = [(m, w) for m in ("fastkv", "snapkv") for w in (None, 48)]


def _prompts(vocab):
    rng = np.random.default_rng(11)
    return [rng.integers(0, vocab, n).tolist() for n in PROMPT_LENS]


def _batch(prompts):
    tokens = np.zeros((len(prompts), BUCKET), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    return tokens, np.asarray([len(p) for p in prompts], np.int32)


@pytest.fixture(scope="module")
def jax_runs(models):
    """The JAX Engine's fused prefill (logits, cache) and tokens per run: its
    ``prefill_fn`` and ``generate_fn``, as ``Engine.generate`` runs them,
    with the Pallas calls in interpret mode."""
    res = {}
    for method, window in RUNS:
        cj, _, pj, _ = models[window]
        mj, _ = _mcfgs(method)
        ej, _ = _ecfgs()
        prompts = _prompts(cj.vocab_size)
        tokens, n = _batch(prompts)
        eng = JEngine(pj, cj, mj, ej)
        with pltpu.force_tpu_interpret_mode():
            logits, cache = eng.prefill_fn(BUCKET, NEW)(pj, jnp.asarray(tokens), jnp.asarray(n))
            # read before generate_fn, which donates the cache
            got = (np.asarray(logits), np.asarray(cache.pos), np.asarray(cache.valid))
            result, _ = eng.generate_fn(BUCKET, NEW, 0, 1)(
                pj, logits, cache, jnp.asarray(n), jnp.asarray([0], jnp.int32))
        toks, nums = np.asarray(result.tokens), np.asarray(result.num_generated)
        res[(method, window)] = (*got, [toks[i, :nums[i]].tolist() for i in range(len(n))])
    return res


@pytest.mark.parametrize("method,window", RUNS)
def test_fused_prefill_and_generate_match_jax(models, jax_runs, method, window):
    _, ct, _, pt = models[window]
    _, mt = _mcfgs(method)
    _, et = _ecfgs()
    prompts = _prompts(ct.vocab_size)
    tokens, n = _batch(prompts)
    shapes = tpm.plan_shapes(ct, mt, et, BUCKET)
    logits, cache = tpm.prefill(pt, ct, mt, shapes, torch.from_numpy(tokens),
                                torch.from_numpy(n), et)
    j_logits, j_pos, j_valid, j_tokens = jax_runs[(method, window)]
    np.testing.assert_array_equal(cache.pos.numpy(), j_pos)
    np.testing.assert_array_equal(cache.valid.numpy(), j_valid)
    np.testing.assert_allclose(logits.numpy(), j_logits, atol=2e-4, rtol=2e-4)
    assert Engine(pt, ct, mt, et, device="cpu").generate(prompts, NEW) == j_tokens


@pytest.mark.parametrize("method,window", RUNS)
def test_fused_equals_unfused_in_the_port(models, method, window):
    """The fused scores are exact: the same keep-sets and cache as the
    separate scoring pass (decode does not read the flag)."""
    _, ct, _, pt = models[window]
    _, mt = _mcfgs(method)
    tokens, n = (torch.from_numpy(x) for x in _batch(_prompts(ct.vocab_size)))
    runs = []
    for fused in (False, True):
        _, et = _ecfgs(fused)
        runs.append(tpm.prefill(pt, ct, mt, tpm.plan_shapes(ct, mt, et, BUCKET), tokens, n, et))
    (lu, cu), (lf, cf) = runs
    assert torch.equal(cu.pos, cf.pos) and torch.equal(cu.valid, cf.valid)
    torch.testing.assert_close(cf.k, cu.k, atol=0, rtol=0)
    torch.testing.assert_close(lf, lu, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# chunked admission's finish
# ---------------------------------------------------------------------------

CHUNK, N_CHUNKED = 64, 201


@pytest.fixture(scope="module")
def jax_chunked(models):
    cj, _, pj, _ = models[None]
    mj, _ = _mcfgs("fastkv")
    ej, _ = _ecfgs()
    progs = jchunked.make_programs(cj, mj, ej, jpm.plan_shapes(cj, mj, ej, BUCKET), chunk=CHUNK)
    prompt = np.random.default_rng(3).integers(0, cj.vocab_size, N_CHUNKED).tolist()
    adm = jchunked.start_admission(progs, slot=0, req=None, prompt=prompt)
    out = None
    with pltpu.force_tpu_interpret_mode():
        while out is None:
            out = jchunked.advance(progs, pj, adm)
    return prompt, np.asarray(out[0]), out[1]


def test_chunked_finish_with_fused_segment_b_matches_jax(models, jax_chunked):
    _, ct, _, pt = models[None]
    _, mt = _mcfgs("fastkv")
    _, et = _ecfgs()
    prompt, j_logits, j_cache = jax_chunked
    progs = tchunked.make_programs(ct, mt, tpm.plan_shapes(ct, mt, et, BUCKET), CHUNK, et)
    adm = tchunked.start_admission(progs, pt, slot=0, req=None, prompt=prompt)
    before = tfp.scores_launches
    out = None
    while out is None:
        out = tchunked.advance(pt, adm)
    assert tfp.scores_launches == before  # the CPU takes the plain version
    logits, cache = out
    np.testing.assert_array_equal(cache.pos.numpy(), np.asarray(j_cache.pos))
    np.testing.assert_array_equal(cache.valid.numpy(), np.asarray(j_cache.valid))
    np.testing.assert_allclose(logits.numpy(), j_logits, atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(j_cache.k), atol=2e-4, rtol=2e-4)
