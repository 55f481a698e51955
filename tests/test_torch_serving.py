"""Port parity for the continuous-batching Scheduler, against the JAX package.

The port's ``Scheduler`` and the JAX ``Scheduler`` (``use_pallas=False``) run
the same requests on the tiny config (4 layers, float32, weights from seed 0)
on the CPU; the generated tokens and the order of admission events
(prefill, chunk, finish, and decode steps) must be exactly equal:

  * FullKV, FastKV, SnapKV and StreamingLLM, chunked (``prefill_chunk`` 64)
    and monolithic, on the staggered budgets of tests/test_chunked.py: slot 1
    frees while slot 0 still decodes, so the third request admits chunk-wise;
  * H2O and GemFilter with ``prefill_chunk`` 64: both admit monolithically,
    as in the JAX package (no chunk or finish event);
  * ``chunk_decode_steps`` 2;
  * a slot reused after a longer-bucket request (bucket ladder 128, 256): the
    shorter cache is installed into a slot that held the longer one, whose
    stale entries must be cleared;
  * the over-length policy (middle truncation; rejection);
  * a sliding-window model.

Engine.generate for SnapKV, H2O and StreamingLLM is held to the JAX package
in tests/test_torch_engine.py, GemFilter's in tests/test_torch_gemfilter.py.
Each JAX run is made once per module.
"""

import jax
import numpy as np
import pytest
import torch

from fastkv_tpu.core import config as jcfg
from fastkv_tpu.engine.scheduler import Scheduler as JScheduler
from fastkv_tpu.models.llama import init_params as j_init_params
from fastkv_tpu_torch.core import config as tcfg
from fastkv_tpu_torch.engine.scheduler import Request, Scheduler
from fastkv_tpu_torch.models.llama import params_from_numpy

STAGGERED = ((230, 24), (201, 6), (140, 12))  # (prompt length, budget)

# name: (method, prefill_chunk, chunk_decode_steps, buckets, requests, model kw)
RUNS = {
    **{f"{m}_{'chunk64' if c else 'monolithic'}": (m, c, 1, (256,), STAGGERED, {})
       for m in ("fullkv", "fastkv", "snapkv", "streamingllm") for c in (64, None)},
    "fastkv_chunk64_two_steps": ("fastkv", 64, 2, (256,), STAGGERED, {}),
    # slot 0 holds a 230-token request (bucket 256), retires after 2 tokens and
    # takes a 60-token one (bucket 128) while slot 1 decodes
    "fastkv_slot_reuse": ("fastkv", 64, 1, (128, 256), ((230, 2), (150, 20), (60, 10)), {}),
    "fullkv_slot_reuse_monolithic": ("fullkv", None, 1, (128, 256),
                                     ((230, 2), (150, 20), (60, 10)), {}),
    "snapkv_window_chunk64": ("snapkv", 64, 1, (256,), STAGGERED, {"sliding_window": 64}),
    # 300 and 400 tokens are cut to the first and last 128 of them
    "fastkv_overlength": ("fastkv", 64, 1, (256,), ((300, 8), (120, 4), (400, 6)), {}),
    # chunked admission does not take these: the third request admits whole
    "h2o_chunk64": ("h2o", 64, 1, (256,), STAGGERED, {}),
    "gemfilter_chunk64": ("gemfilter", 64, 1, (256,), STAGGERED, {}),
}
# the methods chunked admission takes (engine.chunked.SUPPORTED)
CHUNKED = ("fullkv", "fastkv", "snapkv", "streamingllm")


def _configs(name):
    method, chunk, k, buckets, _, model_kw = RUNS[name]
    mkw = dict(eviction_mode="proportional", retain_rate=0.3, tsp_rate=0.5, tsp_idx=1,
               window_size=8, filter_idx=1)
    ekw = dict(prefill_buckets=buckets, capacity_align=8, prefill_chunk=chunk,
               chunk_decode_steps=k)
    return (jcfg.MethodConfig(method=jcfg.Method(method), **mkw),
            tcfg.MethodConfig(method=tcfg.Method(method), **mkw),
            jcfg.EngineConfig(use_pallas=False, **ekw), tcfg.EngineConfig(**ekw), model_kw)


@pytest.fixture(scope="module")
def models():
    out = {}
    for kw in ({}, {"sliding_window": 64}):
        cj, ct = jcfg.ModelConfig.tiny(**kw), tcfg.ModelConfig.tiny(**kw)
        pj = j_init_params(cj, seed=0)
        pt = params_from_numpy(ct, jax.tree_util.tree_map(np.asarray, pj), device="cpu")
        out[kw.get("sliding_window")] = (cj, ct, pj, pt)
    return out


def _prompts(name, vocab):
    rng = np.random.default_rng(len(name))
    return [rng.integers(0, vocab, n).tolist() for n, _ in RUNS[name][4]]


def _run(sched, name, vocab):
    for p, (_, budget) in zip(_prompts(name, vocab), RUNS[name][4]):
        sched.submit(p, max_new_tokens=budget)
    done = sched.run()
    kinds = [e if e[0] != "decode" else ("decode",) for e in sched.events]
    return {r.req_id: r.tokens for r in done}, kinds


def _schedulers(name, models):
    mj, mt, ej, et, model_kw = _configs(name)
    cj, ct, pj, pt = models[model_kw.get("sliding_window")]
    kw = dict(max_batch=2, bucket=256, max_new_tokens=24)
    return (JScheduler(pj, cj, mj, ej, **kw), Scheduler(pt, ct, mt, et, device="cpu", **kw),
            cj.vocab_size)


@pytest.fixture(scope="module")
def jax_runs(models):
    """Tokens and events of the JAX Scheduler per run, computed once."""
    res = {}
    for name in RUNS:
        js, _, vocab = _schedulers(name, models)
        res[name] = _run(js, name, vocab)
    return res


@pytest.mark.parametrize("name", sorted(RUNS))
def test_scheduler_matches_jax(models, jax_runs, name):
    _, ts, vocab = _schedulers(name, models)
    tokens, events = _run(ts, name, vocab)
    want_tokens, want_events = jax_runs[name]
    assert tokens == want_tokens
    assert events == want_events
    budgets = [b for _, b in RUNS[name][4]]
    assert [len(tokens[i]) for i in range(len(budgets))] == budgets
    if RUNS[name][1] and RUNS[name][0] in CHUNKED:  # the chunked path was taken
        assert ("chunk", 2) in events and ("finish", 2) in events
    else:
        assert not [e for e in events if e[0] in ("chunk", "finish")]


@pytest.mark.parametrize("method", ["h2o", "gemfilter"])
def test_chunk_gate_admits_monolithically(models, method):
    """With prefill_chunk set, a Scheduler of a method that chunked admission
    does not take admits whole while others decode, and never builds chunk
    programs (which would raise for it)."""
    from fastkv_tpu_torch.engine import chunked

    name = f"{method}_chunk64"
    _, ts, vocab = _schedulers(name, models)
    assert ts.ecfg.prefill_chunk == 64 and not ts._chunk_ok
    with pytest.raises(ValueError, match="chunked admission does not take"):
        chunked.make_programs(ts.cfg, ts.mcfg, ts.shapes, 64)
    tokens, events = _run(ts, name, vocab)
    assert [e for e in events if e[0] == "prefill"] == [("prefill", i) for i in range(3)]
    # the third admission happened while the first request decoded
    assert events.index(("prefill", 2)) > events.index(("decode",))
    assert ts._chunk_progs == {}
    assert [len(tokens[i]) for i in range(3)] == [b for _, b in STAGGERED]


def test_interleaving_bounds_the_stall(models):
    """While a request decodes, at most one chunk runs between two of its
    decode steps, and monolithic prefills happen only in the idle phase."""
    _, ts, vocab = _schedulers("fastkv_chunk64", models)
    _, events = _run(ts, "fastkv_chunk64", vocab)
    assert sum(e[0] == "prefill" for e in events) == 2
    gap = 0
    for e in events:
        gap = 0 if e[0] == "decode" else gap + (e[0] == "chunk")
        assert gap <= 1, events


def test_slot_reuse_clears_the_longer_request(models):
    """After the 60-token request is installed where the 230-token one was,
    nothing of the longer request is left valid in that slot."""
    _, ts, vocab = _schedulers("fastkv_slot_reuse", models)
    seen = []
    real = ts._install

    def install(slot, req, n, logits, cache1):
        real(slot, req, n, logits, cache1)
        if req.req_id == 2:
            c1 = cache1.k.shape[3]
            seen.append(bool(ts.cache.valid[:, slot, :, c1:].any()))
            seen.append(bool(torch.equal(ts.cache.valid[:, slot, :, :c1], cache1.valid[:, 0])))

    ts._install = install
    _run(ts, "fastkv_slot_reuse", vocab)
    assert seen == [False, True]


def test_overlength_policy(models):
    _, ts, _ = _schedulers("fastkv_overlength", models)
    prompt = list(range(300))
    ts.submit(prompt, max_new_tokens=2)
    assert ts.queue[0].prompt == prompt[:128] + prompt[-128:]
    _, mt, _, et, _ = _configs("fastkv_overlength")
    _, ct, _, pt = models[None]
    strict = Scheduler(pt, ct, mt, et, max_batch=2, bucket=256, max_new_tokens=24,
                       overlength="reject", device="cpu")
    with pytest.raises(ValueError, match="reject"):
        strict.submit(prompt)
    with pytest.raises(ValueError, match="max_new_tokens"):
        strict.submit(prompt[:10], max_new_tokens=25)


def test_mesh_replica_needs_its_mesh(models):
    """A replica over more than one device takes its mesh (the replicas over
    a mesh: tests/test_torch_tp_engine.py)."""
    _, mt, _, et, _ = _configs("fastkv_chunk64")
    _, ct, _, pt = models[None]
    with pytest.raises(ValueError, match="needs its mesh"):
        Scheduler(pt, ct, mt, et, bucket=256, pcfg=tcfg.ParallelConfig(model=2), device="cpu")


def test_request_metrics_and_logger(models):
    """Each retired request reaches the logger once, with its metrics."""
    logged = []

    class Logger:
        def request_metrics(self, req):
            logged.append(req.metrics)

    _, mt, _, et, _ = _configs("fastkv_chunk64")
    _, ct, _, pt = models[None]
    ts = Scheduler(pt, ct, mt, et, max_batch=2, bucket=256, max_new_tokens=24,
                   logger=Logger(), device="cpu")
    _, events = _run(ts, "fastkv_chunk64", ct.vocab_size)
    assert sorted(m["req_id"] for m in logged) == [0, 1, 2]
    for m in logged:
        assert m["new_tokens"] == dict(enumerate(b for _, b in STAGGERED))[m["req_id"]]
        assert 0 <= m["ttft_s"] <= m["total_s"] and m["tpot_s"] > 0
    assert Request(0, [1], 4).metrics["new_tokens"] == 0
