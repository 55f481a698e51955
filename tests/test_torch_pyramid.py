"""Port parity for PyramidInfer, against the JAX package (``use_pallas=False``).

Tiny config in float32, weights from the JAX package's seed 1 carried across
by ``params_from_numpy``:

  * the schedule (``decay_ratio``, ``gen_decay_ratio``,
    ``plan_layer_lengths``, ``decode_buffer_rows``) over the six shipped
    configs x the Llama-3.1-8B, Ministral-8B and Mistral-Nemo-12B presets x
    buckets 512-16384; the JSON overlay from a path, a dict and a file; the
    preset picker, its files and its refusals;
  * ``prefill`` with the decode state on a ragged batch: logits <= 1e-4, each
    layer's kept positions and validity equal, K/V on the valid slots <=
    1e-5, ``past``, ``live`` and ``row_stamp`` equal, ``probs`` <= 1e-5;
  * ``decode_step``, uniform (the Engine's) and per-example (the
    Scheduler's) slots and stamps, with ``exceed_length_to_compress`` 4 so
    that eviction events fire within the steps: validity per layer, ``past``
    and ``live`` equal after every step, logits <= 1e-4;
  * ``Engine.generate`` and the Scheduler (a queue longer than
    ``max_batch``; with ``prefill_chunk`` set it admits whole): tokens and
    event kinds equal, on ``tiny()`` and ``tiny(sliding_window=48)``;
  * the two roundings of the frozen recent length, the ``kv_int8``
    refusal, and the calibration CLI (analytic rates and ``main``'s lines,
    ``--empirical`` on the CPU).

Every top-k the port takes is held to ``MIN_REL_GAP``: the head mean and the
distance-weighted row sum are taken in another order than the JAX package's
(and the port reuses a layer's seed probabilities for its scores), so a
near tie at a boundary must fail loudly rather than flip a kept set.
"""

import dataclasses
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastkv_tpu.bench import calibrate as jcal
from fastkv_tpu.core import config as jcfg
from fastkv_tpu.engine import prefill as jpm
from fastkv_tpu.engine import pyramid as jpyr
from fastkv_tpu.engine.generate import Engine as JEngine
from fastkv_tpu.engine.scheduler import Scheduler as JScheduler
from fastkv_tpu.models.llama import init_params as j_init_params
from fastkv_tpu_torch.bench import calibrate as tcal
from fastkv_tpu_torch.core import config as tcfg
from fastkv_tpu_torch.engine import prefill as tpm
from fastkv_tpu_torch.engine import pyramid as tpyr
from fastkv_tpu_torch.engine.generate import Engine as TEngine
from fastkv_tpu_torch.engine.scheduler import Scheduler as TScheduler
from fastkv_tpu_torch.models.llama import params_from_numpy
from test_torch_engine import MIN_REL_GAP, gap_recorder  # noqa: F401
from fastkv_tpu_torch.utils.testing import one_thread_per_module

_one_torch_thread = one_thread_per_module()

ROOT = Path(__file__).resolve().parents[1]
JSONS = ("llama_35", "llama_50", "llama_60", "ministral_35", "ministral_60", "nemo_60")
PRESETS = ("llama_3_1_8b", "ministral_8b", "mistral_nemo_12b")
BUCKET, MAX_NEW = 512, 12
LENGTHS = (300, 181, 457)


def _json(name, pkg="fastkv_tpu_torch"):
    return str(ROOT / pkg / "configs" / "pyramidinfer" / f"{name}.json")


def _method_configs(name="llama_60", **kw):
    mj = dataclasses.replace(jcfg.MethodConfig().with_pyramidinfer_json(_json(name, "fastkv_tpu")),
                             **kw)
    mt = dataclasses.replace(tcfg.MethodConfig().with_pyramidinfer_json(_json(name)), **kw)
    return mj, mt


def _engine_configs(buckets=(BUCKET,), max_new=MAX_NEW, **kw):
    return (jcfg.EngineConfig(prefill_buckets=buckets, max_new_tokens=max_new, use_pallas=False,
                              capacity_align=8, **kw),
            tcfg.EngineConfig(prefill_buckets=buckets, max_new_tokens=max_new, capacity_align=8,
                              **kw))


def _fields(mcfg):
    d = dataclasses.asdict(mcfg)
    d["method"] = d["method"].value
    return d


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


def _batch(vocab, lengths=LENGTHS, bucket=BUCKET, seed=7):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, n).tolist() for n in lengths]
    tokens = np.zeros((len(prompts), bucket), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    return prompts, tokens, np.asarray(lengths, np.int32)


# ---------------------------------------------------------------------------
# configuration and schedule (pure Python)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", JSONS)
def test_schedule_matches_jax(name):
    mj, mt = _method_configs(name)
    for preset in PRESETS:
        cj, ct = getattr(jcfg.ModelConfig, preset)(), getattr(tcfg.ModelConfig, preset)()
        L = ct.num_layers
        for l in range(L):
            assert tpyr.decay_ratio(mt, l, L) == jpyr.decay_ratio(mj, l, L)
            assert tpyr.gen_decay_ratio(mt, l, L) == jpyr.gen_decay_ratio(mj, l, L)
        for bucket in (512, 1024, 2048, 4096, 8192, 16384):
            for align in (8, 128):
                assert (tpyr.plan_layer_lengths(ct, mt, bucket, align)
                        == jpyr.plan_layer_lengths(cj, mj, bucket, align))
            assert tpyr.decode_buffer_rows(mt, bucket) == jpyr.decode_buffer_rows(mj, bucket)
    for strategy in ("linear", "constant"):  # the other branches of both schedules
        kw = dict(pyramid_decay_strategy=strategy, pyramid_gen_decay_strategy=strategy,
                  pyramid_gen_decay_ratio=0.5)
        mj2, mt2 = dataclasses.replace(mj, **kw), dataclasses.replace(mt, **kw)
        for l in range(32):
            assert tpyr.decay_ratio(mt2, l, 32) == jpyr.decay_ratio(mj2, l, 32)
            assert tpyr.gen_decay_ratio(mt2, l, 32) == jpyr.gen_decay_ratio(mj2, l, 32)


@pytest.mark.parametrize("name", JSONS)
def test_pyramidinfer_json_matches_jax(name):
    """The port's copy of each shipped file equals the JAX package's byte for
    byte, and the overlay gives the same fields from a path, a dict and a
    file object."""
    assert Path(_json(name)).read_bytes() == Path(_json(name, "fastkv_tpu")).read_bytes()
    want = _fields(jcfg.MethodConfig().with_pyramidinfer_json(_json(name, "fastkv_tpu")))
    data = json.loads(Path(_json(name)).read_text())
    for source in (_json(name), data, io.StringIO(json.dumps(data))):
        assert _fields(tcfg.MethodConfig().with_pyramidinfer_json(source)) == want
    partial = {"prefill_stage": {"recent_ratio": 0.3}}
    assert (_fields(tcfg.MethodConfig(window_size=5).with_pyramidinfer_json(partial))
            == _fields(jcfg.MethodConfig(window_size=5).with_pyramidinfer_json(partial)))


@pytest.mark.parametrize("model,rate", [
    ("llama-3.1-8b", 0.6), ("llama-3.1-8b", 0.35), ("Meta-Llama-3.1-8B-Instruct", 0.5),
    ("ministral-8b", 0.6), ("Ministral-8B-Instruct-2410", 0.35), ("mistral-nemo-12b", 0.6),
    ("llama-3.1-8b", 0.1), ("mistral-nemo-12b", 0.35)])
def test_pyramidinfer_preset_matches_jax(model, rate):
    try:
        want = _fields(jcfg.MethodConfig().with_pyramidinfer_preset(model, rate))
    except NotImplementedError:
        with pytest.raises(NotImplementedError, match="No pyramidinfer config"):
            tcfg.MethodConfig().with_pyramidinfer_preset(model, rate)
        return
    assert _fields(tcfg.MethodConfig().with_pyramidinfer_preset(model, rate)) == want


def test_model_presets_match_jax():
    assert sorted(tcfg.MODEL_PRESETS) == sorted(jcfg.MODEL_PRESETS)
    for name, make in tcfg.MODEL_PRESETS.items():
        got = dataclasses.asdict(make())
        want = dataclasses.asdict(jcfg.MODEL_PRESETS[name]())
        assert got == {k: want[k] for k in got}


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------

def _jax_prefill(cj, mj, ej, sj, pj, tokens, n):
    run = jax.jit(lambda p, t, c: jpyr.prefill(p, cj, mj, ej, sj, t, c, want_decode_state=True))
    return run(pj, jnp.asarray(tokens), jnp.asarray(n))


def _kept(cache):
    """Each (layer, example, head) row's positions on its valid slots, -1 elsewhere."""
    return np.where(np.asarray(cache.valid), np.asarray(cache.pos), -1)


@pytest.mark.parametrize("name,window", [("llama_60", None), ("llama_35", None),
                                         ("llama_60", 48)])
def test_prefill_matches_jax(models, gap_recorder, name, window):  # noqa: F811
    cj, ct, pj, pt = models[window]
    mj, mt = _method_configs(name)
    ej, et = _engine_configs()
    _, tokens, n = _batch(cj.vocab_size)
    sj, st = jpm.plan_shapes(cj, mj, ej, BUCKET), tpm.plan_shapes(ct, mt, et, BUCKET)
    assert sj.total_capacity == st.total_capacity
    lj, cache_j, ps_j = _jax_prefill(cj, mj, ej, sj, pj, tokens, n)
    lt, cache_t, ps_t = tpyr.prefill(pt, ct, mt, et, st, torch.from_numpy(tokens),
                                     torch.from_numpy(n), want_decode_state=True)
    lengths = tpyr.plan_layer_lengths(ct, mt, BUCKET, et.capacity_align)
    assert len(gap_recorder) == sum(a > b for a, b in zip(lengths, lengths[1:])) > 0
    assert min(gap_recorder) > MIN_REL_GAP
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(_kept(cache_t), _kept(cache_j))
    valid = np.asarray(cache_j.valid)[..., None]
    for got, want in ((cache_t.k, cache_j.k), (cache_t.v, cache_j.v)):
        np.testing.assert_allclose(np.where(valid, got.numpy(), 0), np.where(valid, want, 0),
                                   atol=1e-5, rtol=1e-5)
    # the pyramid shrinks: deeper layers keep fewer tokens
    counts = cache_t.valid[:, :, 0].sum(-1)
    assert bool((counts[-1] < counts[0]).all())
    for f in ("past", "live", "row_stamp"):
        np.testing.assert_array_equal(getattr(ps_t, f).numpy(), np.asarray(getattr(ps_j, f)))
    np.testing.assert_allclose(ps_t.probs.numpy(), np.asarray(ps_j.probs), atol=1e-5, rtol=0)
    assert float(ps_t.probs.sum()) > 0
    # without the decode state (the path prefill.prefill hands PyramidInfer
    # to): the same logits and cache
    lt2, cache_t2 = tpm.prefill(pt, ct, mt, st, torch.from_numpy(tokens), torch.from_numpy(n),
                                et)
    torch.testing.assert_close(lt2, lt, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(_kept(cache_t2), _kept(cache_t))


@pytest.mark.parametrize("per_example", [False, True])
def test_decode_steps_match_jax(models, gap_recorder, per_example):  # noqa: F811
    """Six decode steps after a ragged prefill, llama_35 (recent ratio 0.01)
    with exceed 4, so the deeper layers evict on the first steps: per layer
    validity, past and live equal after every step."""
    cj, ct, pj, pt = models[None]
    mj, mt = _method_configs("llama_35", pyramid_exceed_length_to_compress=4)
    ej, et = _engine_configs()
    _, tokens, n = _batch(cj.vocab_size)
    sj, st = jpm.plan_shapes(cj, mj, ej, BUCKET), tpm.plan_shapes(ct, mt, et, BUCKET)
    lj, cache_j, ps_j = _jax_prefill(cj, mj, ej, sj, pj, tokens, n)
    lt, cache_t, ps_t = tpyr.prefill(pt, ct, mt, et, st, torch.from_numpy(tokens),
                                     torch.from_numpy(n), want_decode_state=True)
    n_j = jnp.asarray(n)
    r_j = jnp.floor(n_j.astype(jnp.float32) * mj.pyramid_recent_ratio).astype(jnp.int32)
    n_t = torch.from_numpy(n)
    r_t = tpyr.recent_length(n_t, mt)
    np.testing.assert_array_equal(r_t.numpy(), np.asarray(r_j))
    step_j = jax.jit(lambda c, ps, tok, pos, slot, stamp: jpyr.decode_step(
        pj, cj, mj, c, ps, tok, pos, slot, stamp, n_j, r_j))
    tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
    b = len(n)
    evictions = 0
    for t in range(6):
        slot, stamp = st.prefill_capacity + t, t + 1
        if per_example:
            slot_j, stamp_j = jnp.full((b,), slot, jnp.int32), jnp.full((b,), stamp, jnp.int32)
            slot_t, stamp_t = torch.full((b,), slot), torch.full((b,), stamp, dtype=torch.int32)
        else:
            slot_j, stamp_j, slot_t, stamp_t = jnp.int32(slot), jnp.int32(stamp), slot, stamp
        before = cache_t.valid[:, :, 0].sum(-1)
        lj, cache_j, ps_j = step_j(cache_j, ps_j, jnp.asarray(tok), jnp.asarray(n + t), slot_j,
                                   stamp_j)
        lt, cache_t, ps_t = tpyr.decode_step(
            pt, ct, mt, cache_t, ps_t, torch.from_numpy(tok), torch.from_numpy(n + t), slot_t,
            stamp_t, n_t, r_t)
        evictions += int((cache_t.valid[:, :, 0].sum(-1) < before + 1).sum())
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4, rtol=1e-4)
        np.testing.assert_array_equal(cache_t.valid.numpy(), np.asarray(cache_j.valid))
        for f in ("past", "live", "row_stamp"):
            np.testing.assert_array_equal(getattr(ps_t, f).numpy(), np.asarray(getattr(ps_j, f)))
        np.testing.assert_allclose(ps_t.probs.numpy(), np.asarray(ps_j.probs), atol=1e-5, rtol=0)
        tok = np.asarray(jnp.argmax(lj, axis=-1)).astype(np.int32)
    assert evictions > 0
    assert min(gap_recorder) > MIN_REL_GAP


# ---------------------------------------------------------------------------
# Engine.generate and the Scheduler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_eos", [False, True])
@pytest.mark.parametrize("window", [None, 48])
def test_generate_tokens_equal_jax(models, gap_recorder, window, with_eos):  # noqa: F811
    cj, ct, pj, pt = models[window]
    mj, mt = _method_configs("llama_35", pyramid_exceed_length_to_compress=4)
    ej, et = _engine_configs()
    prompts, _, _ = _batch(cj.vocab_size)
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
    assert set(timing) == {"prefill_s", "decode_s", "decode_steps"}
    assert timing["decode_steps"] == MAX_NEW - 1


REQUESTS = ((230, 10), (201, 4), (140, 8), (96, 6))


def _serve(sched, prompts):
    ids = [sched.submit(p, max_new_tokens=budget) for p, (_, budget) in zip(prompts, REQUESTS)]
    done = {r.req_id: r.tokens for r in sched.run()}
    return [done[i] for i in ids], [e[0] for e in sched.events]


@pytest.mark.parametrize("window", [None, 48])
def test_scheduler_matches_jax(models, gap_recorder, window):  # noqa: F811
    """Four requests through two slots at the one bucket 256, prefill_chunk
    64 set (PyramidInfer admits whole): tokens and event kinds equal the JAX
    Scheduler's; a freed slot is reused by a shorter prompt."""
    cj, ct, pj, pt = models[window]
    mj, mt = _method_configs("llama_35", pyramid_exceed_length_to_compress=4)
    ej, et = _engine_configs(buckets=(128, 256), prefill_chunk=64)
    prompts, _, _ = _batch(cj.vocab_size, [n for n, _ in REQUESTS], bucket=256, seed=9)
    t_sched = TScheduler(pt, ct, mt, et, max_batch=2, bucket=256, max_new_tokens=10,
                         device="cpu")
    assert t_sched.buckets == (256,)
    assert tuple(t_sched.pstate.probs.shape) == (ct.num_layers, 2, 3, 256 + 16)
    got = _serve(t_sched, prompts)
    want = _serve(JScheduler(pj, cj, mj, ej, max_batch=2, bucket=256, max_new_tokens=10),
                  prompts)
    assert got == want
    assert "chunk" not in got[1] and "finish" not in got[1]
    assert [len(t) for t in got[0]] == [b for _, b in REQUESTS]
    assert min(gap_recorder) > MIN_REL_GAP


def test_recent_length_rounds_as_jax_at_both_sites(models):
    """At recent ratio 0.35 a 180-token prompt has floor(float32(180) *
    0.35f) = 63 (Engine.generate, the prefill) and int(180 * 0.35) = 62 (the
    Scheduler): each site rounds as its JAX counterpart, and tokens equal."""
    cj, ct, pj, pt = models[None]
    mj, mt = _method_configs("llama_60", pyramid_recent_ratio=0.35,
                             pyramid_exceed_length_to_compress=4)
    n = torch.tensor([180], dtype=torch.int32)
    assert int(tpyr.recent_length(n, mt)[0]) == 63
    ej, et = _engine_configs(buckets=(256,), max_new=8)
    prompts, _, _ = _batch(cj.vocab_size, [180], bucket=256)
    got = TEngine(pt, ct, mt, et, device="cpu").generate(prompts, 8)
    assert got == JEngine(pj, cj, mj, ej).generate(prompts, 8)
    t_sched = TScheduler(pt, ct, mt, et, max_batch=1, bucket=256, max_new_tokens=8,
                         device="cpu")
    j_sched = JScheduler(pj, cj, mj, ej, max_batch=1, bucket=256, max_new_tokens=8)
    for s in (t_sched, j_sched):
        s.submit(prompts[0], max_new_tokens=8)
    t_done, j_done = t_sched.run(), j_sched.run()
    assert t_sched.r_dyn.tolist() == j_sched.r_dyn.tolist() == [62]
    assert t_done[0].tokens == j_done[0].tokens


def test_kv_int8_is_refused(models):
    _, ct, _, pt = models[None]
    _, mt = _method_configs()
    et = tcfg.EngineConfig(prefill_buckets=(256,), kv_int8=True)
    with pytest.raises(ValueError, match="kv_int8"):
        TEngine(pt, ct, mt, et, device="cpu")
    with pytest.raises(ValueError, match="kv_int8"):
        TScheduler(pt, ct, mt, et, bucket=256, device="cpu")
    # fuse_window_scores is ignored, as in the JAX package
    et = tcfg.EngineConfig(prefill_buckets=(256,), capacity_align=8, fuse_window_scores=True)
    prompts, _, _ = _batch(ct.vocab_size, [100], bucket=256)
    plain = dataclasses.replace(et, fuse_window_scores=False)
    assert (TEngine(pt, ct, mt, et, device="cpu").generate(prompts, 4)
            == TEngine(pt, ct, mt, plain, device="cpu").generate(prompts, 4))


# ---------------------------------------------------------------------------
# the calibration CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", JSONS)
def test_calibrate_analytic_matches_jax(name):
    mj, mt = _method_configs(name)
    for preset in ("llama-3.1-8b", "llama-3.2-1b", "ministral-8b", "mistral-nemo-12b",
                   "llama-3.1-70b"):
        cj, ct = jcfg.MODEL_PRESETS[preset](), tcfg.MODEL_PRESETS[preset]()
        for seq_len in (1000, 4000, 8192):
            for align in (1, 128):
                assert (tcal.analytic_retain_rate(ct, mt, seq_len, align)
                        == jcal.analytic_retain_rate(cj, mj, seq_len, align))


def test_calibrate_main_prints_the_jax_lines(capsys):
    argv = ["--model", "llama-3.2-3b", "--seqlens", "1000", "2000", "--decay_ratios", "0.01",
            "0.3", "0.7", "--config", _json("ministral_60")]
    jcal.main(argv)
    want = capsys.readouterr().out
    tcal.main(argv)
    assert capsys.readouterr().out == want and len(want.splitlines()) == 6
    # --empirical on the tiny config: the port on the CPU counts the same
    # valid entries (they depend on the lengths only, not on the weights)
    argv = ["--model", "tiny", "--seqlens", "200", "--decay_ratios", "0.3", "--empirical"]
    jcal.main(argv)
    want = capsys.readouterr().out
    tcal.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want and "measured=" in got


def test_kernels_in_spans_counts_what_starts_inside_once():
    """chip_smoke.py reads ``_rows_probs``' device time from the kernels that
    start inside its range's spans: summed, and merged so that an overlap
    counts once; none without spans."""
    import chip_smoke

    spans = [(0.0, 10.0), (20.0, 30.0)]
    kernels = [(1.0, 5.0), (4.0, 8.0), (9.0, 12.0), (15.0, 18.0), (21.0, 25.0), (30.0, 31.0)]
    summed, merged = chip_smoke.kernels_in_spans(spans, kernels)
    assert summed == pytest.approx((4 + 4 + 3 + 4) / 1e3)
    assert merged == pytest.approx((7 + 3 + 4) / 1e3)
    assert chip_smoke.kernels_in_spans([], kernels) == [None, None]
