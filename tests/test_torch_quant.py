"""Port parity for int8: weight-only int8 and the int8 KV cache, against the
JAX package.

The same inputs, made with numpy from a seed, go through the JAX package and
the PyTorch port on the CPU, in float32, on the tiny config (4 layers):

  * ``absmax_quantize``, ``quantize_kv`` and the ``quantize_params_int8``
    tree: int8 values equal bit for bit (both round half to even in float32),
    scales within 1 ulp; ``init_params_int8`` gives the same tree's shapes
    and dtypes; ``params_from_numpy`` carries int8 weights and their scales;
  * prefill logits with int8 weights within 1e-4 of the JAX package's;
  * the plain decode attention over an int8 cache with its scales against
    JAX ``ops.attention.decode_attention`` within 1e-5, and its window term
    against the JAX Pallas decode kernel in interpret mode (2e-5);
  * ``Engine.generate`` (FastKV, FullKV, SnapKV) and the ``Scheduler``
    (chunked and monolithic) with ``kv_int8``, with and without int8
    weights: tokens and event kinds exactly equal to the JAX package's
    (``use_pallas=False``: its int8 decode is the XLA path);
  * the Scheduler's cache takes ``cfg.dtype`` (not the weights' int8), and
    int8 only under ``kv_int8``.

Each JAX run is made once per module.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fastkv_tpu.core import config as jcfg
from fastkv_tpu.core import quant as jquant
from fastkv_tpu.engine import prefill as jpm
from fastkv_tpu.engine.generate import Engine as JEngine
from fastkv_tpu.engine.scheduler import Scheduler as JScheduler
from fastkv_tpu.models.llama import init_params as j_init_params
from fastkv_tpu.ops import attention as jatt
from fastkv_tpu.ops.experimental.decode_attn import decode_attention as j_pallas_decode
from fastkv_tpu_torch.core import config as tcfg
from fastkv_tpu_torch.core import quant
from fastkv_tpu_torch.engine import prefill as tpm
from fastkv_tpu_torch.engine.generate import Engine
from fastkv_tpu_torch.engine.scheduler import Scheduler
from fastkv_tpu_torch.models import llama
from fastkv_tpu_torch.ops import decode_attn as tda

BUCKET = 256


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---------------------------------------------------------------------------
# quantizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,axis", [((4, 64, 32), 1), ((50, 24), 0), ((50, 24), 1)])
def test_absmax_quantize_matches_jax(shape, axis):
    w = np.random.default_rng(len(shape) + axis).standard_normal(shape).astype(np.float32)
    wi, s = quant.absmax_quantize(torch.from_numpy(w), axis)
    ji, js = jquant.absmax_quantize(jnp.asarray(w), axis)
    assert wi.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(wi.numpy(), np.asarray(ji))
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(js), maxulp=1)


def test_rounding_is_half_to_even():
    """Scale 1 exactly (absmax 127): 0.5, 1.5, 2.5 and -0.5 round to even."""
    w = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -127.0]])
    wi, s = quant.absmax_quantize(w, axis=1)
    assert s.item() == 1.0
    assert wi.tolist() == [[127, 0, 2, 2, 0, -127]]
    ji, _ = jquant.absmax_quantize(jnp.asarray(w.numpy()), axis=1)
    assert np.asarray(ji).tolist() == wi.tolist()


def test_quantize_kv_matches_jax():
    x = np.random.default_rng(5).standard_normal((2, 3, 40, 16)).astype(np.float32)
    x[0, 1, 7] = 0.0  # an empty slot: scale 1e-12 / 127, values 0
    xi, s = quant.quantize_kv(torch.from_numpy(x))
    ji, js = jquant.quantize_kv(jnp.asarray(x))
    assert xi.shape == x.shape and s.shape == x.shape[:-1]
    np.testing.assert_array_equal(xi.numpy(), np.asarray(ji))
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(js), maxulp=1)


@pytest.fixture(scope="module")
def models():
    """tiny (untied head) and tiny with a tied head: the float32 JAX params,
    their JAX int8 tree, and both carried over to the port."""
    out = {}
    for tied in (False, True):
        cj = jcfg.ModelConfig.tiny(tie_word_embeddings=tied)
        ct = tcfg.ModelConfig.tiny(tie_word_embeddings=tied)
        pj = j_init_params(cj, seed=0)
        qj = jquant.quantize_params_int8(pj)
        out[tied] = (cj, ct, pj, qj, llama.params_from_numpy(ct, _np_tree(pj), device="cpu"),
                     llama.params_from_numpy(ct, _np_tree(qj), device="cpu"))
    return out


def _flat(tree):
    flat = {k: v for k, v in tree.items() if k != "layers"}
    flat.update({f"layers.{k}": v for k, v in tree["layers"].items()})
    return flat


@pytest.mark.parametrize("tied", [False, True])
def test_quantize_params_tree_matches_jax(models, tied):
    _, ct, _, qj, pt, qt_carried = models[tied]
    mine, want = _flat(quant.quantize_params_int8(pt)), _flat(_np_tree(qj))
    assert sorted(mine) == sorted(want)
    for name, w in want.items():
        got = mine[name].numpy()
        assert got.dtype == w.dtype and got.shape == w.shape, name
        if name.endswith("_scale"):
            np.testing.assert_array_max_ulp(got, w, maxulp=1)
        else:
            np.testing.assert_array_equal(got, w, err_msg=name)
    # params_from_numpy carries the JAX int8 tree as it is
    carried = _flat(qt_carried)
    assert sorted(carried) == sorted(want)
    for name, w in want.items():
        assert carried[name].dtype == {np.dtype(np.int8): torch.int8,
                                       np.dtype(np.float32): torch.float32}[w.dtype], name
        np.testing.assert_array_equal(carried[name].numpy(), w, err_msg=name)
    # and a random init straight into the int8 format has the same tree
    rand = _flat(llama.init_params_int8(ct, torch.Generator().manual_seed(0), device="cpu"))
    assert {k: (tuple(v.shape), v.dtype) for k, v in rand.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in carried.items()}


@pytest.mark.parametrize("tied,method", [(False, "fastkv"), (True, "fullkv")])
def test_int8_weight_prefill_logits_match_jax(models, tied, method):
    cj, ct, _, qj, _, qt = models[tied]
    kw = dict(method=method, eviction_mode="proportional", retain_rate=0.3, tsp_rate=0.5,
              tsp_idx=1, window_size=8)
    mj, mt = jcfg.MethodConfig(**{**kw, "method": jcfg.Method(method)}), tcfg.MethodConfig(
        **{**kw, "method": tcfg.Method(method)})
    ekw = dict(prefill_buckets=(BUCKET,), max_new_tokens=8, capacity_align=8)
    ej, et = jcfg.EngineConfig(use_pallas=False, **ekw), tcfg.EngineConfig(**ekw)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cj.vocab_size, (2, BUCKET)).astype(np.int32)
    n = np.asarray([200, 256], np.int32)
    lj, cache_j = jpm.prefill(qj, cj, mj, ej, jpm.plan_shapes(cj, mj, ej, BUCKET),
                              jnp.asarray(tokens), jnp.asarray(n))
    lt, cache_t = tpm.prefill(qt, ct, mt, tpm.plan_shapes(ct, mt, et, BUCKET),
                              torch.from_numpy(tokens), torch.from_numpy(n))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(cache_t.pos.numpy(), np.asarray(cache_j.pos))
    assert cache_t.k.dtype == torch.float32  # the activations' dtype, not int8


# ---------------------------------------------------------------------------
# decode attention over an int8 cache, and its window term
# ---------------------------------------------------------------------------

def _decode_inputs(b, h, ch, C, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    k = rng.standard_normal((b, ch, C, d)).astype(np.float32)
    v = rng.standard_normal((b, ch, C, d)).astype(np.float32)
    valid = rng.random((b, ch, C)) < 0.6
    valid[:, :, 0] = True
    return q, k, v, valid


@pytest.mark.parametrize("per_head_mask", [False, True])
def test_plain_int8_decode_matches_jax(per_head_mask):
    q, k, v, valid = _decode_inputs(2, 8, 2, 300, 64, 3)
    if not per_head_mask:
        valid = valid[:, 0]
    ki, ks = quant.quantize_kv(torch.from_numpy(k))
    vi, vs = quant.quantize_kv(torch.from_numpy(v))
    out = tda.decode_attention(torch.from_numpy(q), ki, vi, torch.from_numpy(valid),
                               k_scale=ks, v_scale=vs)
    ref = jatt.decode_attention(jnp.asarray(q), jnp.asarray(ki.numpy()), jnp.asarray(vi.numpy()),
                                jnp.asarray(valid), k_scale=jnp.asarray(ks.numpy()),
                                v_scale=jnp.asarray(vs.numpy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_int8_decode_needs_its_scales():
    q, k, v, valid = _decode_inputs(1, 4, 2, 32, 16, 0)
    ki, ks = quant.quantize_kv(torch.from_numpy(k))
    q, valid = torch.from_numpy(q), torch.from_numpy(valid)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        tda.decode_attention(q, ki, ki, valid)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        tda.decode_attention(q, ki, ki, valid, k_scale=ks)
    with pytest.raises(ValueError, match="int8 cache"):
        tda.decode_attention(q, torch.from_numpy(k), torch.from_numpy(k), valid, k_scale=ks,
                             v_scale=ks)
    with pytest.raises(ValueError, match="q_pos and k_pos"):
        tda.decode_attention(q, ki, ki, valid, k_scale=ks, v_scale=ks, sliding_window=8)


@pytest.mark.parametrize("int8", [False, True])
def test_plain_decode_window_term_matches_jax(int8):
    """The Pallas decode kernel's own window (kpos > qpos - W), as
    tests/test_decode_kernel.py runs it, against the port's plain version;
    over an int8 cache, against the JAX XLA path with the same window."""
    b, h, ch, C, d, W = 2, 4, 2, 256, 64, 96
    q, k, v, _ = _decode_inputs(b, h, ch, C, d, 9)
    n = np.array([220, 140])
    valid = np.broadcast_to((np.arange(C)[None, :] < n[:, None])[:, None], (b, ch, C)).copy()
    k_pos = np.broadcast_to(np.arange(C, dtype=np.int32)[None, None], (b, ch, C)).copy()
    q_pos = n.astype(np.int32)
    args = dict(q_pos=torch.from_numpy(q_pos), k_pos=torch.from_numpy(k_pos), sliding_window=W)
    jargs = dict(q_pos=jnp.asarray(q_pos), k_pos=jnp.asarray(k_pos), sliding_window=W)
    if not int8:
        out = tda.decode_attention(*(torch.from_numpy(x) for x in (q, k, v, valid)), **args)
        with pltpu.force_tpu_interpret_mode():
            ref = j_pallas_decode(*(jnp.asarray(x) for x in (q, k, v, valid)), block_c=128,
                                  **jargs)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
        return
    ki, ks = quant.quantize_kv(torch.from_numpy(k))
    vi, vs = quant.quantize_kv(torch.from_numpy(v))
    out = tda.decode_attention(torch.from_numpy(q), ki, vi, torch.from_numpy(valid),
                               k_scale=ks, v_scale=vs, **args)
    ref = jatt.decode_attention(jnp.asarray(q), jnp.asarray(ki.numpy()), jnp.asarray(vi.numpy()),
                                jnp.asarray(valid), k_scale=jnp.asarray(ks.numpy()),
                                v_scale=jnp.asarray(vs.numpy()), **jargs)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# Engine.generate and the Scheduler with kv_int8
# ---------------------------------------------------------------------------

def _configs(method, **ekw):
    kw = dict(eviction_mode="proportional", retain_rate=0.3, tsp_rate=0.5, tsp_idx=1,
              window_size=8, pooling="maxpool")
    ekw = dict(prefill_buckets=(BUCKET,), capacity_align=8, kv_int8=True, **ekw)
    return (jcfg.MethodConfig(method=jcfg.Method(method), **kw),
            tcfg.MethodConfig(method=tcfg.Method(method), **kw),
            jcfg.EngineConfig(use_pallas=False, **ekw), tcfg.EngineConfig(**ekw))


GEN_RUNS = [("fastkv", False), ("fullkv", False), ("snapkv", False), ("fastkv", True)]
STAGGERED = ((230, 24), (201, 6), (140, 12))  # (prompt length, budget)
SERVE_RUNS = [("fastkv", 64, False), ("snapkv", 64, False), ("fullkv", None, False),
              ("fastkv", 64, True)]


def _params(models, int8_weights):
    _, _, pj, qj, pt, qt = models[False]
    return (qj, qt) if int8_weights else (pj, pt)


def _gen_prompts(vocab):
    rng = np.random.default_rng(4)
    return [rng.integers(0, vocab, n).tolist() for n in (200, 131)]


def _serve(sched, vocab):
    rng = np.random.default_rng(6)
    for n, budget in STAGGERED:
        sched.submit(rng.integers(0, vocab, n).tolist(), max_new_tokens=budget)
    done = sched.run()
    return ({r.req_id: r.tokens for r in done},
            [e if e[0] != "decode" else ("decode",) for e in sched.events])


@pytest.fixture(scope="module")
def jax_runs(models):
    cj = models[False][0]
    gen, serve = {}, {}
    for method, w8 in GEN_RUNS:
        mj, _, ej, _ = _configs(method, max_new_tokens=8)
        pj = _params(models, w8)[0]
        gen[(method, w8)] = JEngine(pj, cj, mj, ej).generate(_gen_prompts(cj.vocab_size), 8)
    for method, chunk, w8 in SERVE_RUNS:
        mj, _, ej, _ = _configs(method, prefill_chunk=chunk)
        pj = _params(models, w8)[0]
        serve[(method, chunk, w8)] = _serve(
            JScheduler(pj, cj, mj, ej, max_batch=2, bucket=BUCKET, max_new_tokens=24),
            cj.vocab_size)
    return gen, serve


@pytest.mark.parametrize("method,int8_weights", GEN_RUNS)
def test_kv_int8_generate_matches_jax(models, jax_runs, method, int8_weights):
    ct = models[False][1]
    _, mt, _, et = _configs(method, max_new_tokens=8)
    pt = _params(models, int8_weights)[1]
    toks = Engine(pt, ct, mt, et, device="cpu").generate(_gen_prompts(ct.vocab_size), 8)
    assert toks == jax_runs[0][(method, int8_weights)]


@pytest.mark.parametrize("method,chunk,int8_weights", SERVE_RUNS)
def test_kv_int8_scheduler_matches_jax(models, jax_runs, method, chunk, int8_weights):
    ct = models[False][1]
    _, mt, _, et = _configs(method, prefill_chunk=chunk)
    pt = _params(models, int8_weights)[1]
    sched = Scheduler(pt, ct, mt, et, max_batch=2, bucket=BUCKET, max_new_tokens=24,
                      device="cpu")
    assert sched.cache.k.dtype == torch.int8 and sched.cache.k_scale.dtype == torch.float32
    tokens, events = _serve(sched, ct.vocab_size)
    want_tokens, want_events = jax_runs[1][(method, chunk, int8_weights)]
    assert tokens == want_tokens
    assert events == want_events
    if chunk:
        assert ("chunk", 2) in events and ("finish", 2) in events


@pytest.mark.parametrize("kv_int8", [False, True])
def test_scheduler_cache_takes_the_model_dtype(models, kv_int8):
    """Over int8 weights the Scheduler's cache and chunk scratch are
    cfg.dtype (float32 here), int8 only under kv_int8."""
    _, ct, _, _, _, qt = models[False]
    _, mt, _, et = _configs("fastkv", prefill_chunk=64)
    et = tcfg.EngineConfig(**{**et.__dict__, "kv_int8": kv_int8})
    sched = Scheduler(qt, ct, mt, et, max_batch=2, bucket=BUCKET, max_new_tokens=8,
                      device="cpu")
    assert qt["layers"]["wq"].dtype == torch.int8
    assert sched.cache.k.dtype == (torch.int8 if kv_int8 else torch.float32)
    assert (sched.cache.k_scale is not None) == kv_int8
    progs = sched._chunk_progs_for(BUCKET)
    assert all(x.dtype == torch.float32 for x in progs.scratch(torch.device("cpu")))
