"""Port parity: token selection and the FastKV, SnapKV, StreamingLLM and
FullKV keep-sets.

Selections are integer sets and must equal the JAX package's exactly. Ties at
the top-k boundary are common under maxpool (plateaus); the port settles them
with a stable descending sort, lower index first, as ``lax.top_k`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastkv_tpu.core import config as jcfg
from fastkv_tpu.policies import methods as jmeth
from fastkv_tpu.policies import selection as jsel
from fastkv_tpu_torch.core import config as tcfg
from fastkv_tpu_torch.policies import methods as tmeth
from fastkv_tpu_torch.policies import selection as tsel
from fastkv_tpu_torch.utils.testing import one_thread_per_module

_one_torch_thread = one_thread_per_module()


def test_topk_select_tie_order_is_lax_top_k():
    row = np.array([[[1, 3, 3, 2, 3, 0, 3]]], np.float32)
    sel = np.ones((1, 7), bool)
    idx, valid = tsel.topk_select(
        torch.from_numpy(row), torch.from_numpy(sel), torch.tensor([3]), 3)
    assert idx[0, 0].tolist() == [1, 2, 4]
    assert bool(valid.all())
    _, jidx = jax.lax.top_k(jnp.asarray(row), 3)
    assert np.asarray(jidx)[0, 0].tolist() == [1, 2, 4]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_select_matches_jax_on_ties(seed):
    rng = np.random.default_rng(seed)
    b, ch, s, cap = 3, 2, 64, 24
    scores = rng.integers(0, 5, (b, ch, s)).astype(np.float32)  # many ties
    selectable = rng.random((b, s)) < 0.7
    budget = np.array([24, 10, 0], np.int32)
    ti, tv = tsel.topk_select(*map(torch.from_numpy, (scores, selectable, budget)), cap)
    ji, jv = jsel.topk_select(*map(jnp.asarray, (scores, selectable, budget)), cap)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_selection_helpers_match_jax():
    rng = np.random.default_rng(3)
    mask = rng.random((2, 50)) < 0.3
    for cap in (5, 20, 50):
        ti, tv = tsel.sorted_union_indices(torch.from_numpy(mask), cap)
        ji, jv = jsel.sorted_union_indices(jnp.asarray(mask), cap)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    sc = rng.random((2, 8, 30)).astype(np.float32)
    np.testing.assert_allclose(tsel.group_sum(torch.from_numpy(sc), 4).numpy(),
                               np.asarray(jsel.group_sum(jnp.asarray(sc), 4)), atol=1e-6)
    start = np.array([-3, 20], np.int32)
    n = np.array([4, 25], np.int32)
    ti, tv = tsel.window_indices(torch.from_numpy(start), 8, torch.from_numpy(n))
    ji, jv = jsel.window_indices(jnp.asarray(start), 8, jnp.asarray(n))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    x4 = rng.random((2, 3, 30, 5)).astype(np.float32)
    idx3 = rng.integers(0, 30, (2, 3, 7))
    x3 = rng.random((2, 30, 6)).astype(np.float32)
    idx2 = rng.integers(0, 30, (2, 9))
    for x, idx in ((x4, idx3), (x3, idx2), (x3[..., 0], idx2)):
        np.testing.assert_array_equal(
            tsel.gather_tokens(torch.from_numpy(x), torch.from_numpy(idx)).numpy(),
            np.asarray(jsel.gather_tokens(jnp.asarray(x), jnp.asarray(idx))))


def _score_inputs(seed, b=2, H=4, s=80, W=8):
    rng = np.random.default_rng(seed)
    raw = rng.random((b, H, s)).astype(np.float32)
    n = np.array([80, 53], np.int32)[:b]
    valid = np.arange(s)[None, :] < n[:, None]
    selectable = valid & (np.arange(s)[None, :] < (n - W)[:, None])
    raw = np.where(selectable[:, None, :], raw, 0).astype(np.float32)
    start = n - W
    win_idx = start[:, None] + np.arange(W)[None, :]
    win_valid = np.ones((b, W), bool)
    return raw, selectable, win_idx.astype(np.int32), win_valid, n


@pytest.mark.parametrize("pooling", ["maxpool", "avgpool"])
@pytest.mark.parametrize("method", ["fastkv", "snapkv"])
def test_score_based_keep_matches_jax(method, pooling):
    raw, selectable, win_idx, win_valid, n = _score_inputs(7)
    kw = dict(method=None, window_size=8, kernel_size=7, pooling=pooling)
    mj = jcfg.MethodConfig(**{**kw, "method": jcfg.Method(method)})
    mt = tcfg.MethodConfig(**{**kw, "method": tcfg.Method(method)})
    budget = np.array([20, 9], np.int32)
    ks_t = tmeth.score_based_keep(
        tcfg.Method(method), mt, tcfg.ModelConfig.tiny(),
        *map(torch.from_numpy, (raw, selectable, win_idx, win_valid, budget)), 24)
    ks_j = jmeth.score_based_keep(
        jcfg.Method(method), mj, jcfg.ModelConfig.tiny(),
        *map(jnp.asarray, (raw, selectable, win_idx, win_valid, budget)), 24)
    np.testing.assert_array_equal(ks_t.idx.numpy(), np.asarray(ks_j.idx))
    np.testing.assert_array_equal(ks_t.valid.numpy(), np.asarray(ks_j.valid))


@pytest.mark.parametrize("seed", [0, 1])
def test_fastkv_tsp_set_matches_jax(seed):
    raw, selectable, win_idx, win_valid, n = _score_inputs(seed)
    mj, mt = jcfg.MethodConfig(pooling="maxpool"), tcfg.MethodConfig(pooling="maxpool")
    budget = np.array([30, 12], np.int32)
    ts = tmeth.fastkv_tsp_set(mt, tcfg.ModelConfig.tiny(),
                              *map(torch.from_numpy, (raw, selectable, win_idx, win_valid,
                                                      budget)), 40)
    js = jmeth.fastkv_tsp_set(mj, jcfg.ModelConfig.tiny(),
                              *map(jnp.asarray, (raw, selectable, win_idx, win_valid, budget)),
                              40)
    np.testing.assert_array_equal(ts.idx.numpy(), np.asarray(js.idx))
    np.testing.assert_array_equal(ts.valid.numpy(), np.asarray(js.valid))


def test_fullkv_keep_and_cache_heads_match_jax():
    n = np.array([5, 9], np.int32)
    kt = tmeth.fullkv_keep(2, 2, 12, torch.from_numpy(n))
    kj = jmeth.fullkv_keep(2, 2, 12, jnp.asarray(n))
    np.testing.assert_array_equal(kt.idx.numpy(), np.asarray(kj.idx))
    np.testing.assert_array_equal(kt.valid.numpy(), np.asarray(kj.valid))
    for m in ("fullkv", "fastkv", "snapkv", "h2o"):
        assert (tmeth.cache_heads(tcfg.Method(m), tcfg.ModelConfig.tiny())
                == jmeth.cache_heads(jcfg.Method(m), jcfg.ModelConfig.tiny()))


@pytest.mark.parametrize("mode", ["proportional", "constant"])
def test_streamingllm_keep_matches_jax(mode):
    """Sinks plus the recent window; prompts at, below and above the cap."""
    kw = dict(eviction_mode=mode, retain_rate=0.3, max_capacity_prompt=24, window_size=8)
    mj = jcfg.MethodConfig(method=jcfg.Method.STREAMINGLLM, **kw)
    mt = tcfg.MethodConfig(method=tcfg.Method.STREAMINGLLM, **kw)
    n = np.array([3, 24, 57, 80], np.int32)
    kt = tmeth.streamingllm_keep(mt, 2, 4, torch.from_numpy(n), 32)
    kj = jmeth.streamingllm_keep(mj, 2, 4, jnp.asarray(n), 32)
    np.testing.assert_array_equal(kt.idx.numpy(), np.asarray(kj.idx))
    np.testing.assert_array_equal(kt.valid.numpy(), np.asarray(kj.valid))
