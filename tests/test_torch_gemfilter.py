"""Port parity for GemFilter, against the JAX package (``use_pallas=False``).

Tiny config in float32, weights from the JAX package's seed 1:

  * pass 1, ``select_tokens``: the reduced prompt, its count and the kept
    indices equal the JAX package's, in proportional and constant mode, on a
    ragged batch with a prompt shorter than the constant budget;
  * ``Engine.generate``: tokens equal, with and without EOS, on ``tiny()``
    and ``tiny(sliding_window=48)``;
  * a ``filter_idx`` that is not a layer of the model raises;
  * the Scheduler over a bucket ladder: each admission's pass 2 runs at its
    own bucket's filter capacity and is installed into the shared cache
    planned at the largest one's; tokens equal ``Engine.generate``'s.

Every top-k the port takes is held to the margin of tests/test_torch_engine.py
(``MIN_REL_GAP``): the filter scores are summed over all heads, then
avg-pooled, in another order than the JAX package's, so a near-tie at the
boundary must fail loudly rather than flip a token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastkv_tpu.core import config as jcfg
from fastkv_tpu.engine import gemfilter as jgem
from fastkv_tpu.engine.generate import Engine as JEngine
from fastkv_tpu.models.llama import init_params as j_init_params
from fastkv_tpu_torch.core import config as tcfg
from fastkv_tpu_torch.engine import gemfilter as tgem
from fastkv_tpu_torch.engine.generate import Engine as TEngine
from fastkv_tpu_torch.engine.scheduler import Scheduler
from fastkv_tpu_torch.models.llama import params_from_numpy
from test_torch_engine import MIN_REL_GAP, gap_recorder  # noqa: F401

BUCKET, MAX_NEW = 512, 16
LENGTHS = (300, 181, 457, 40)


@pytest.fixture(scope="module")
def models():
    out = {}
    for window in (None, 48):
        cj = jcfg.ModelConfig.tiny(sliding_window=window)
        ct = tcfg.ModelConfig.tiny(sliding_window=window)
        pj = j_init_params(cj, seed=1)
        pt = params_from_numpy(ct, jax.tree_util.tree_map(np.asarray, pj), device="cpu")
        out[window] = (cj, ct, pj, pt)
    return out


def _configs(mode, filter_idx=2, buckets=(BUCKET,)):
    kw = dict(eviction_mode=mode, retain_rate=0.3, max_capacity_prompt=64,
              filter_idx=filter_idx)
    ekw = dict(prefill_buckets=buckets, max_new_tokens=MAX_NEW, capacity_align=8)
    return (jcfg.MethodConfig(method=jcfg.Method.GEMFILTER, **kw),
            tcfg.MethodConfig(method=tcfg.Method.GEMFILTER, **kw),
            jcfg.EngineConfig(use_pallas=False, **ekw), tcfg.EngineConfig(**ekw))


def _prompts(vocab, lengths=LENGTHS, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lengths]


@pytest.mark.parametrize("mode", ["proportional", "constant"])
def test_select_tokens_matches_jax(models, gap_recorder, mode):  # noqa: F811
    cj, ct, pj, pt = models[None]
    mj, mt, ej, et = _configs(mode)
    prompts = _prompts(cj.vocab_size)
    tokens = np.zeros((len(prompts), BUCKET), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    n = np.asarray(LENGTHS, np.int32)
    cap = tgem.filter_capacity(mt, BUCKET, et.capacity_align)
    assert cap == jgem.filter_capacity(mj, BUCKET, ej.capacity_align)
    got = tgem.select_tokens(pt, ct, mt, et, torch.from_numpy(tokens), torch.from_numpy(n), cap)
    want = jgem.select_tokens(pj, cj, mj, ej, jnp.asarray(tokens), jnp.asarray(n), cap)
    for g, w in zip(got, want):  # new tokens, new count, kept indices
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    count = got[1].numpy()
    if mode == "constant":  # the 40-token prompt is shorter than the budget: kept whole
        assert count.tolist() == [64, 64, 64, 40]
        assert got[0][3, :40].tolist() == prompts[3]
    else:
        assert count.tolist() == [int(x * 0.3) for x in LENGTHS]
    assert len(gap_recorder) == 1 and min(gap_recorder) > MIN_REL_GAP


@pytest.mark.parametrize("with_eos", [False, True])
@pytest.mark.parametrize("window", [None, 48])
def test_generate_tokens_equal_jax(models, gap_recorder, window, with_eos):  # noqa: F811
    cj, ct, pj, pt = models[window]
    mj, mt, ej, et = _configs("proportional")
    prompts = _prompts(cj.vocab_size, LENGTHS[:3])
    t_eng = TEngine(pt, ct, mt, et, device="cpu")
    eos = ()
    if with_eos:
        # an id the first example emits mid-stream, so the EOS path is taken
        eos = (t_eng.generate(prompts[:1], MAX_NEW)[0][5],)
    got = t_eng.generate(prompts, MAX_NEW, eos_ids=eos, min_new_tokens=2)
    want = JEngine(pj, cj, mj, ej).generate(prompts, MAX_NEW, eos_ids=eos, min_new_tokens=2)
    assert got == want
    assert [len(t) for t in got] != [MAX_NEW] * len(prompts) or not with_eos
    assert min(gap_recorder) > MIN_REL_GAP
    timing = t_eng.last_timing
    assert timing["prefill_s"] == pytest.approx(timing["pass1_s"] + timing["pass2_s"])


@pytest.mark.parametrize("filter_idx", [-1, 4])
def test_filter_layer_out_of_range_raises(models, filter_idx):
    _, ct, _, pt = models[None]
    _, mt, _, et = _configs("proportional", filter_idx=filter_idx)
    with pytest.raises(ValueError, match="filter_idx"):
        TEngine(pt, ct, mt, et, device="cpu").generate([[1, 2, 3] * 10], 3)


def test_scheduler_bucket_ladder_matches_engine(models, gap_recorder):  # noqa: F811
    """Admissions pick the smallest ladder bucket that holds them, as
    Engine.generate does; each runs pass 2 at that bucket's filter capacity
    and its cache is installed into the shared one, planned at the largest
    bucket's: tokens equal Engine.generate's one prompt at a time, and those
    equal the JAX package's."""
    cj, ct, pj, pt = models[None]
    mj, mt, ej, et = _configs("proportional", filter_idx=1, buckets=(64, 128, 256))
    prompts = _prompts(cj.vocab_size, (50, 200, 100, 30), seed=9)
    t_eng, j_eng = TEngine(pt, ct, mt, et, device="cpu"), JEngine(pj, cj, mj, ej)
    expected = [t_eng.generate([p], 6)[0] for p in prompts]
    assert expected == [j_eng.generate([p], 6)[0] for p in prompts]
    sched = Scheduler(pt, ct, mt, et, max_batch=2, bucket=256, max_new_tokens=6, device="cpu")
    assert sched.buckets == (64, 128, 256)
    assert sched.shapes.prefill_capacity == tgem.filter_capacity(mt, 256, 8)
    assert sched.cache.k.shape[2] == ct.num_kv_heads  # FullKV's cache heads
    ids = [sched.submit(p, max_new_tokens=6) for p in prompts]
    done = {r.req_id: r.tokens for r in sched.run()}
    assert [done[i] for i in ids] == expected
    assert set(sched._prefill_shapes) >= {64, 256}
    assert min(gap_recorder) > MIN_REL_GAP
