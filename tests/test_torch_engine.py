"""Port parity: prefill, decode and Engine.generate against the JAX package.

Tiny config in float32, FullKV, FastKV, SnapKV (a per-query-head cache), H2O
(the same cache layout, scored by the accumulated attention mass of every
row) and StreamingLLM at the tiny settings of the verify recipe (retain 0.3, tsp 0.5,
tsp_idx 1, capacity_align 8) with maxpool, the canonical pooling. Exact ties at the top-k boundary (maxpool plateaus) are settled the
same way by both packages (stable sort, lower index first). A *near* tie that
float32 rounding could flip is another matter, so every top-k the port takes
is recorded and the test asserts a margin at its boundary, as
``TorchFastKV.min_boundary_gap`` does in tests/test_fastkv_e2e_golden.py.

Tolerances: last-token logits 1e-4 and cache K/V 1e-5 (float32, another
order of summation through four layers); positions, validity and greedy
tokens exactly equal. H2O's cache holds its kept tokens in the order of
their scores, and two kept tokens whose accumulated masses are equal to
float32 rounding (unpooled, they often are) may sit in swapped slots in the
two packages, which no attention output can see; so its cache rows are
compared in position order (``_by_position``). Its top-k boundary is held to
the margin like the others'.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastkv_tpu.core import config as jcfg
from fastkv_tpu.engine import decode as jdec
from fastkv_tpu.engine import prefill as jpm
from fastkv_tpu.engine.generate import Engine as JEngine
from fastkv_tpu.models.llama import init_params as j_init_params
from fastkv_tpu_torch.core import config as tcfg
from fastkv_tpu_torch.engine import decode as tdec
from fastkv_tpu_torch.engine import prefill as tpm
from fastkv_tpu_torch.engine.generate import Engine as TEngine
from fastkv_tpu_torch.models.llama import params_from_numpy
from fastkv_tpu_torch.policies import selection as tsel
from fastkv_tpu_torch.utils.testing import one_thread_per_module

_one_torch_thread = one_thread_per_module()

# the two packages' float32 scores differ by a few ulps (relative ~1e-7), so a
# boundary margin of 1e-6 relative to the boundary value cannot flip
MIN_REL_GAP = 1e-6
BUCKET, MAX_NEW = 512, 16
LENGTHS = (300, 181, 457)


def boundary_gap(scores, selectable, k_budget):
    """Smallest margin, relative to the boundary value, between the values kept
    and dropped by one top-k.

    Equal values on both sides of the boundary (an exact tie) are settled by
    index in both packages; what must have a margin is the distance from the
    boundary value to the nearest *different* value on either side."""
    masked = torch.where(selectable[:, None, :], scores, float("-inf"))
    vals = torch.sort(masked, dim=-1, descending=True).values
    n_sel = selectable.sum(-1)
    gap = float("inf")
    for b in range(vals.shape[0]):
        k = int(min(int(k_budget[b]), int(n_sel[b])))
        if k == 0 or k >= int(n_sel[b]):
            continue  # all or nothing selectable is kept: no boundary
        for row in vals[b]:
            row = row[: int(n_sel[b])]
            x, y = float(row[k - 1]), float(row[k])
            if x != y:
                gaps = [x - y]
            else:
                above, below = row[row > x], row[row < x]
                gaps = [float(above.min()) - x] if len(above) else []
                gaps += [x - float(below.max())] if len(below) else []
            gap = min([gap] + [g / max(abs(x), 1e-30) for g in gaps])
    return gap


@pytest.fixture
def gap_recorder(monkeypatch):
    gaps = []
    real = tsel.topk_select

    def recording(scores, selectable, k_budget, capacity):
        gaps.append(boundary_gap(scores, selectable, k_budget))
        return real(scores, selectable, k_budget, capacity)

    monkeypatch.setattr(tsel, "topk_select", recording)
    return gaps


def _configs(method):
    kw = dict(eviction_mode="proportional", retain_rate=0.3, tsp_rate=0.5, tsp_idx=1,
              pooling="maxpool")
    mj = jcfg.MethodConfig(method=jcfg.Method(method), **kw)
    mt = tcfg.MethodConfig(method=tcfg.Method(method), **kw)
    ej = jcfg.EngineConfig(prefill_buckets=(BUCKET,), max_new_tokens=MAX_NEW,
                           use_pallas=False, capacity_align=8)
    et = tcfg.EngineConfig(prefill_buckets=(BUCKET,), max_new_tokens=MAX_NEW, capacity_align=8)
    return mj, mt, ej, et


@pytest.fixture(scope="module")
def model():
    cj, ct = jcfg.ModelConfig.tiny(), tcfg.ModelConfig.tiny()
    pj = j_init_params(cj, seed=1)
    pt = params_from_numpy(ct, jax.tree_util.tree_map(np.asarray, pj), device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cj.vocab_size, n).tolist() for n in LENGTHS]
    tokens = np.zeros((len(prompts), BUCKET), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, : len(p)] = p
    return cj, ct, pj, pt, prompts, tokens, np.asarray(LENGTHS, np.int32)


METHODS = ["fullkv", "fastkv", "snapkv", "h2o", "streamingllm"]
# the methods that take a top-k of scores
SCORED = ("fastkv", "snapkv", "h2o")


def _by_position(cache, method):
    """(k, v, pos, valid) as numpy; for H2O each row's slots sorted by
    position, invalid slots last (a stable sort: their order is kept)."""
    k, v, pos, valid = (np.asarray(x) for x in (cache.k, cache.v, cache.pos, cache.valid))
    if method != "h2o":
        return k, v, pos, valid
    order = np.argsort(np.where(valid, pos, np.iinfo(np.int32).max), axis=-1, kind="stable")
    rows = lambda x: np.take_along_axis(x, order[..., None], -2)  # noqa: E731
    return (rows(k), rows(v), np.take_along_axis(pos, order, -1),
            np.take_along_axis(valid, order, -1))


@pytest.mark.parametrize("method", METHODS)
def test_prefill_matches_jax(model, gap_recorder, method):
    cj, ct, pj, pt, _, tokens, n = model
    mj, mt, ej, et = _configs(method)
    sj = jpm.plan_shapes(cj, mj, ej, BUCKET)
    st = tpm.plan_shapes(ct, mt, et, BUCKET)
    lj, cache_j = jpm.prefill(pj, cj, mj, ej, sj, jnp.asarray(tokens), jnp.asarray(n))
    lt, cache_t = tpm.prefill(pt, ct, mt, st, torch.from_numpy(tokens), torch.from_numpy(n))
    if method == "fastkv":
        assert len(gap_recorder) == ct.num_layers + 1  # one per layer, plus TSP
    if method in SCORED:
        assert min(gap_recorder) > MIN_REL_GAP
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, rtol=1e-4)
    got, want = _by_position(cache_t, method), _by_position(cache_j, method)
    for g, w in zip(got[:2], want[:2]):  # K, V
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)
    for g, w in zip(got[2:], want[2:]):  # pos, valid
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("method", METHODS)
def test_decode_step_matches_jax(model, method):
    cj, ct, pj, pt, _, tokens, n = model
    mj, mt, ej, et = _configs(method)
    sj = jpm.plan_shapes(cj, mj, ej, BUCKET)
    st = tpm.plan_shapes(ct, mt, et, BUCKET)
    lj, cache_j = jpm.prefill(pj, cj, mj, ej, sj, jnp.asarray(tokens), jnp.asarray(n))
    lt, cache_t = tpm.prefill(pt, ct, mt, st, torch.from_numpy(tokens), torch.from_numpy(n))
    tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    slot = sj.prefill_capacity + 3
    dj, cache_j = jdec.decode_step(pj, cj, mj, cache_j, jnp.asarray(tok), jnp.asarray(n + 3),
                                   jnp.int32(slot))
    dt, cache_t = tdec.decode_step(pt, ct, mt, cache_t, torch.from_numpy(tok),
                                   torch.from_numpy(n + 3), slot)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-4, rtol=1e-4)
    (kt, _, pos_t, valid_t), (kj, _, pos_j, valid_j) = (
        _by_position(cache_t, method), _by_position(cache_j, method))
    np.testing.assert_array_equal(pos_t, pos_j)
    np.testing.assert_array_equal(valid_t, valid_j)
    np.testing.assert_allclose(kt, kj, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("with_eos", [False, True])
@pytest.mark.parametrize("method", METHODS)
def test_generate_tokens_equal_jax(model, gap_recorder, method, with_eos):
    cj, ct, pj, pt, prompts, _, _ = model
    mj, mt, ej, et = _configs(method)
    t_eng = TEngine(pt, ct, mt, et, device="cpu")
    j_eng = JEngine(pj, cj, mj, ej)
    eos = ()
    if with_eos:
        # an id the first example emits mid-stream, so the EOS path is taken
        eos = (t_eng.generate(prompts[:1], MAX_NEW)[0][5],)
    got = t_eng.generate(prompts, MAX_NEW, eos_ids=eos, min_new_tokens=2)
    want = j_eng.generate(prompts, MAX_NEW, eos_ids=eos, min_new_tokens=2)
    assert got == want
    assert [len(t) for t in got] != [MAX_NEW] * len(prompts) or not with_eos
    if method in SCORED:
        assert min(gap_recorder) > MIN_REL_GAP


def _kept_positions(cache, upto):
    """Each (layer, example, head) row's valid positions below slot ``upto``,
    sorted: the keep set, whatever its order in the cache."""
    pos, valid = np.asarray(cache.pos)[..., :upto], np.asarray(cache.valid)[..., :upto]
    return [sorted(p[v].tolist()) for p, v in zip(pos.reshape(-1, upto), valid.reshape(-1, upto))]


def test_decode_over_clamped_window_slots_matches_jax(model):
    """Where keep_capacity + window_size exceeds the bucket, ``plan_shapes``
    clamps prefill_capacity to the bucket and decode writes over the last
    window slots: a fault of the JAX reference that the port mirrors. Both
    packages must agree there, so a change to either shows: FastKV, constant
    mode, max_capacity_prompt 512, the default capacity alignment, a
    500-token prompt in bucket 512, fifteen decode steps. After every step
    the tokens, the validity and the positions of the slots from
    prefill_capacity on (the window slots decode overwrites, then the decode
    slots) are equal, and so is each row's set of kept positions below it.
    Their order there follows the top-k's rank, and with every token kept a
    maxpool plateau against another plateau of nearly the same score may
    order differently in float32, which no attention output can see."""
    cj, ct, pj, pt, _, _, _ = model
    kw = dict(eviction_mode="constant", max_capacity_prompt=512, tsp_idx=1, pooling="maxpool")
    mj = jcfg.MethodConfig(method=jcfg.Method.FASTKV, **kw)
    mt = tcfg.MethodConfig(method=tcfg.Method.FASTKV, **kw)
    ej = jcfg.EngineConfig(prefill_buckets=(BUCKET,), max_new_tokens=MAX_NEW, use_pallas=False)
    et = tcfg.EngineConfig(prefill_buckets=(BUCKET,), max_new_tokens=MAX_NEW)
    sj = jpm.plan_shapes(cj, mj, ej, BUCKET)
    st = tpm.plan_shapes(ct, mt, et, BUCKET)
    fields = ("bucket", "prefill_capacity", "keep_capacity", "tsp_capacity", "decode_capacity")
    assert [getattr(st, f) for f in fields] == [getattr(sj, f) for f in fields]
    cap = st.prefill_capacity
    assert cap == BUCKET < st.keep_capacity + mt.window_size
    n = np.asarray([500], np.int32)
    tokens = np.zeros((1, BUCKET), np.int32)
    tokens[0, :500] = np.random.default_rng(11).integers(0, cj.vocab_size, 500)
    lj, cache_j = jpm.prefill(pj, cj, mj, ej, sj, jnp.asarray(tokens), jnp.asarray(n))
    lt, cache_t = tpm.prefill(pt, ct, mt, st, torch.from_numpy(tokens), torch.from_numpy(n))
    # prefill left window slots from prefill_capacity on: decode's first write lands there
    np.testing.assert_array_equal(cache_t.pos.numpy()[..., cap:],
                                  np.asarray(cache_j.pos)[..., cap:])
    assert np.asarray(cache_j.valid)[..., cap].all()
    tok_j = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    tok_t = lt.argmax(-1).to(torch.int32)
    for t in range(MAX_NEW - 1):
        assert tok_t.tolist() == tok_j.tolist(), t
        lj, cache_j = jdec.decode_step(pj, cj, mj, cache_j, jnp.asarray(tok_j),
                                       jnp.asarray(n + t), jnp.int32(cap + t))
        lt, cache_t = tdec.decode_step(pt, ct, mt, cache_t, tok_t, torch.from_numpy(n + t),
                                       cap + t)
        np.testing.assert_array_equal(cache_t.valid.numpy(), np.asarray(cache_j.valid))
        np.testing.assert_array_equal(cache_t.pos.numpy()[..., cap:],
                                      np.asarray(cache_j.pos)[..., cap:])
        assert _kept_positions(cache_t, cap) == _kept_positions(cache_j, cap)
        tok_j = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
        tok_t = lt.argmax(-1).to(torch.int32)
    assert tok_t.tolist() == tok_j.tolist()


def test_greedy_generate_eos_and_padding_rules(monkeypatch):
    """EOS is suppressed while step < min_new_tokens; after it every token is 0
    and the decode slots advance one per step."""
    ct = tcfg.ModelConfig.tiny()
    mt = tcfg.MethodConfig(method=tcfg.Method.FULLKV)
    st = tpm.PrefillShapes(8, 8, 8, 8, 8)
    logits = torch.full((2, ct.vocab_size), -1.0)
    logits[:, 5] = 2.0  # the EOS wins whenever it is allowed
    logits[:, 3] = 1.0
    slots = []

    def fake_step(params, cfg, mcfg, cache, tok, pos, slot, inv_freq=None):
        slots.append(slot)
        return logits.clone(), cache

    monkeypatch.setattr(tdec, "decode_step", fake_step)
    res, _ = tdec.greedy_generate(None, ct, mt, st, logits.clone(), None,
                                  torch.tensor([4, 6], dtype=torch.int32), 5,
                                  eos_ids=[5], min_new_tokens=2)
    assert res.tokens.tolist() == [[3, 3, 5, 0, 0]] * 2
    assert res.num_generated.tolist() == [3, 3]
    assert slots == [8, 9, 10, 11]
