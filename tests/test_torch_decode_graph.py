"""The decode loop over static buffers (``engine.decode.DecodeState``), on the
CPU, tiny config, float32.

On a card the default decode step runs as one CUDA graph (``StepGraph``),
which reads its token, position and slot from static buffers and advances
them on the device. Here the same step runs eagerly over those buffers,
once with the call's own buffers and once through a caller's ``states``
(an ``Engine``'s), where the graph is stood in for by a class that runs the
step each call. Either way it must give the tokens and the cache contents
(``k``, ``v``, ``pos``, ``valid``, the int8 scales) of the loop it replaced:
the slot a Python int, EOS masked by a Python branch (``_int_slot_generate``
below). The Engine must hand each call a cache of its own, keep one state a
decode shape, and run eagerly where ``graphable`` says no. The card's side
(capture, replay, the arrival counters) is in tests/test_torch_cuda.py.
"""

import dataclasses
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from fastkv_tpu_torch.core.config import EngineConfig, Method, MethodConfig, ModelConfig
from fastkv_tpu_torch.engine import decode as decode_mod
from fastkv_tpu_torch.engine import prefill as prefill_mod
from fastkv_tpu_torch.engine.generate import Engine
from fastkv_tpu_torch.engine.scheduler import Scheduler
from fastkv_tpu_torch.models.llama import init_params
from fastkv_tpu_torch.models.rope import compute_inv_freq
from fastkv_tpu_torch.utils import guards
from fastkv_tpu_torch.utils.testing import one_thread_per_module

_one_torch_thread = one_thread_per_module()

BUCKET, NEW = 256, 9
LENS = (231, 150)

# name: (method, model kw, engine kw, EOS)
CASES = {
    "fastkv": ("fastkv", {}, {}, False),
    "fullkv": ("fullkv", {}, {}, False),
    "snapkv": ("snapkv", {}, {}, False),
    "fastkv_window": ("fastkv", {"sliding_window": 48}, {}, False),
    "fastkv_kv_int8": ("fastkv", {}, {"kv_int8": True}, False),
    "fullkv_eos_min_new": ("fullkv", {}, {}, True),
}


class EagerGraph:
    """Stands in for ``StepGraph`` on the CPU: runs the step at every call."""

    made = 0

    def __init__(self, device):
        type(self).made += 1
        self.calls = 0

    def __call__(self, step, **counts):
        self.calls += 1
        step()


@pytest.fixture
def as_on_a_card(monkeypatch):
    """``graphable`` judged as for a card (the guards and the mesh still
    count), with the graph stood in for."""
    real = decode_mod.graphable
    monkeypatch.setattr(decode_mod, "graphable",
                        lambda device, mesh=None: real(torch.device("cuda"), mesh))
    monkeypatch.setattr(decode_mod, "StepGraph", EagerGraph)
    EagerGraph.made = 0


def _mcfg(method):
    if method == "pyramidinfer":  # llama_35, with decode evicting
        path = (Path(__file__).resolve().parents[1] / "fastkv_tpu_torch" / "configs"
                / "pyramidinfer" / "llama_35.json")
        return dataclasses.replace(MethodConfig().with_pyramidinfer_json(str(path)),
                                   pyramid_exceed_length_to_compress=4)
    return MethodConfig(method=Method(method), eviction_mode="proportional", retain_rate=0.3,
                        tsp_rate=0.5, tsp_idx=1)


def _model(model_kw):
    cfg = ModelConfig.tiny(dtype="float32", **model_kw)
    return cfg, init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


def _prompts(cfg, lens=LENS):
    return [np.random.default_rng(i).integers(0, cfg.vocab_size, n).tolist()
            for i, n in enumerate(lens)]


def _int_slot_generate(params, cfg, mcfg, shapes, first_logits, cache, n_true, max_new,
                       eos_ids=None, min_new_tokens=1):
    """The loop the static buffers replaced: decode step t at position
    n_true + t and the int slot prefill_capacity + t; EOS masked while
    t < min_new_tokens by a branch on the host."""
    b, vocab = first_logits.shape
    inv_freq = torch.from_numpy(compute_inv_freq(cfg))
    eos = None
    if eos_ids is not None:
        eos = torch.zeros(vocab, dtype=torch.bool)
        eos[torch.as_tensor(list(eos_ids))] = True

    def sample(logits, t):
        if eos is not None and t < min_new_tokens:
            logits = logits.masked_fill(eos[None], float("-inf"))
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def is_eos(tok):
        return torch.zeros_like(tok, dtype=torch.bool) if eos is None else eos[tok.long()]

    tok = sample(first_logits, 0)
    done = is_eos(tok)
    toks, alive = [tok], [torch.ones_like(done)]
    for t in range(max_new - 1):
        logits, cache = decode_mod.decode_step(params, cfg, mcfg, cache, tok, n_true + t,
                                               shapes.prefill_capacity + t, inv_freq)
        tok = torch.where(done, 0, sample(logits, t + 1)).to(torch.int32)
        alive.append(~done)
        done = done | is_eos(tok)
        toks.append(tok)
    alive_t = torch.stack(alive, dim=1)
    return (torch.where(alive_t, torch.stack(toks, dim=1), 0),
            alive_t.sum(dim=1).to(torch.int32), cache)


def _clone(cache):
    return type(cache)(*(None if t is None else t.clone() for t in cache))


@pytest.mark.parametrize("states", [False, True], ids=["own_buffers", "engine_states"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_static_buffers_decode_as_the_int_slot_loop(name, states, as_on_a_card):
    method, model_kw, engine_kw, eos = CASES[name]
    cfg, params = _model(model_kw)
    mcfg = _mcfg(method)
    ecfg = EngineConfig(prefill_buckets=(BUCKET,), max_new_tokens=NEW, capacity_align=8,
                        **engine_kw)
    shapes = prefill_mod.plan_shapes(cfg, mcfg, ecfg, BUCKET)
    tokens = torch.zeros((len(LENS), BUCKET), dtype=torch.int32)
    for i, p in enumerate(_prompts(cfg)):
        tokens[i, :len(p)] = torch.tensor(p)
    n_true = torch.tensor(LENS, dtype=torch.int32)
    logits, cache = prefill_mod.prefill(params, cfg, mcfg, shapes, tokens, n_true, ecfg)
    eos_ids, min_new = None, 1
    if eos:  # a token each row picks early, suppressed at step 1
        first, _, _ = _int_slot_generate(params, cfg, mcfg, shapes, logits, _clone(cache),
                                         n_true, NEW)
        eos_ids, min_new = sorted({int(first[0, 1]), int(first[1, 3])}), 2
    want_toks, want_n, want_cache = _int_slot_generate(
        params, cfg, mcfg, shapes, logits, _clone(cache), n_true, NEW, eos_ids, min_new)
    store = {} if states else None
    mine = _clone(cache)
    for _ in range(2 if states else 1):  # with states: the second call reuses them
        got, out = decode_mod.greedy_generate(params, cfg, mcfg, shapes, logits, mine, n_true,
                                              NEW, eos_ids, min_new, states=store)
        assert out is mine
        assert torch.equal(got.tokens, want_toks) and torch.equal(got.num_generated, want_n)
        for (field, a), (_, b) in zip(out.fields(), want_cache.fields()):
            assert torch.equal(a, b), field
        mine = _clone(cache)
    if eos:
        assert (want_n < NEW).any()  # an EOS ended a row
    if states:
        [st] = store.values()
        assert st.cache is not out and EagerGraph.made == 1 and st.graph.calls == 2 * (NEW - 1)


def _spied_generate(monkeypatch):
    """Wrap ``decode.greedy_generate`` as the benchmark's harness does,
    keeping each call's returned cache."""
    seen = []
    orig = decode_mod.greedy_generate

    def greedy_generate(*a, **kw):
        out, cache = orig(*a, **kw)
        seen.append(cache)
        return out, cache

    monkeypatch.setattr(decode_mod, "greedy_generate", greedy_generate)
    return seen


def test_engine_calls_return_caches_of_their_own(as_on_a_card, monkeypatch):
    cfg, params = _model({})
    eng = Engine(params, cfg, _mcfg("fastkv"),
                 EngineConfig(prefill_buckets=(BUCKET,), capacity_align=8), device="cpu")
    seen = _spied_generate(monkeypatch)
    a, b = _prompts(cfg, (231, 140))
    first = eng.generate([a], NEW)
    kept = _clone(seen[0])
    second = eng.generate([b], NEW)
    assert len(eng._decode_states) == 1 and EagerGraph.made == 1
    for (_, x), (_, y), (_, k) in zip(seen[0].fields(), seen[1].fields(), kept.fields()):
        assert x.data_ptr() != y.data_ptr()
        assert torch.equal(x, k)  # the second call left the first's cache alone
    [st] = eng._decode_states.values()
    assert all(t.data_ptr() != x.data_ptr() for (_, t), (_, x) in zip(st.cache.fields(),
                                                                       seen[1].fields()))
    fresh = Engine(params, cfg, _mcfg("fastkv"),
                   EngineConfig(prefill_buckets=(BUCKET,), capacity_align=8), device="cpu")
    assert fresh.generate([b], NEW) == second and fresh.generate([a], NEW) == first
    # the decoded positions: n_true + t at slots prefill_capacity + t
    shapes = eng.shapes_for(BUCKET, NEW)
    dec = seen[1].pos[:, 0, :, shapes.prefill_capacity:shapes.prefill_capacity + NEW - 1]
    assert (dec == torch.arange(140, 140 + NEW - 1, dtype=torch.int32)).all()


def test_engine_keeps_one_state_a_decode_shape(as_on_a_card):
    cfg, params = _model({})
    eng = Engine(params, cfg, _mcfg("fullkv"),
                 EngineConfig(prefill_buckets=(128, BUCKET), capacity_align=8), device="cpu")
    short, long_ = _prompts(cfg, (100, 231))
    eng.generate([short], NEW)
    eng.generate([long_], NEW)
    eng.generate([short, short], NEW)  # another batch: another shape
    eng.generate([long_], NEW)
    keys = list(eng._decode_states)
    assert len(keys) == 3 and EagerGraph.made == 3
    assert sorted(st.cache.k.shape[3] for st in eng._decode_states.values()) == [
        128 + 16, 128 + 16, BUCKET + 16]


@pytest.mark.parametrize("where", ["cpu", "card", "card_guards", "card_mesh_of_2",
                                   "card_mesh_of_1"])
def test_graphable_only_on_a_card_without_guards_or_a_wider_mesh(where):
    device = torch.device("cpu" if where == "cpu" else "cuda")
    mesh = None
    if where.startswith("card_mesh"):
        mesh = types.SimpleNamespace(pcfg=types.SimpleNamespace(num_devices=int(where[-1])))
    with guards.checking(where == "card_guards"):
        got = decode_mod.graphable(device, mesh)
    assert got == (where in ("card", "card_mesh_of_1"))


@pytest.mark.parametrize("method", ["fastkv", "pyramidinfer"])
def test_engine_runs_eagerly_under_guards_and_for_pyramidinfer(method, as_on_a_card):
    cfg, params = _model({})
    mcfg = _mcfg(method)
    prompt = _prompts(cfg)[0]
    ecfg = EngineConfig(prefill_buckets=(BUCKET,), capacity_align=8)
    want = Engine(params, cfg, mcfg, ecfg, device="cpu").generate([prompt], NEW)
    checked = Engine(params, cfg, mcfg, EngineConfig(prefill_buckets=(BUCKET,), capacity_align=8,
                                                     debug_checks=True), device="cpu")
    assert checked.generate([prompt], NEW) == want
    assert checked._decode_states == {} and EagerGraph.made == (method == "fastkv")


@pytest.mark.parametrize("method", ["fastkv", "pyramidinfer"])
def test_scheduler_step_reads_static_inputs(method, monkeypatch):
    """The Scheduler's step through the graph's path (captured at the first
    step, one call a step) gives the eager path's tokens and events, and
    sends its inputs to the device in one copy a step; PyramidInfer runs
    eagerly."""
    cfg, params = _model({})
    mcfg = _mcfg(method)
    ecfg = EngineConfig(prefill_buckets=(BUCKET,), capacity_align=8)
    reqs = list(zip(_prompts(cfg, (230, 201, 140)), (12, 4, 7)))

    def serve():
        s = Scheduler(params, cfg, mcfg, ecfg, max_batch=2, bucket=BUCKET, max_new_tokens=12,
                      device="cpu")
        for p, n in reqs:
            s.submit(p, n)
        toks = {r.req_id: r.tokens for r in s.run()}
        return toks, [e[0] if e[0] == "decode" else e for e in s.events], s

    eager = serve()
    monkeypatch.setattr(decode_mod, "StepGraph", EagerGraph)
    real = decode_mod.graphable
    monkeypatch.setattr(decode_mod, "graphable",
                        lambda device, mesh=None: real(torch.device("cuda"), mesh))
    EagerGraph.made = 0
    copies = []
    orig_copy = torch.Tensor.copy_

    def copy_(dst, src, non_blocking=False):
        if dst.shape == (3, 2):
            copies.append(non_blocking)
        return orig_copy(dst, src, non_blocking)

    monkeypatch.setattr(torch.Tensor, "copy_", copy_)
    graphed = serve()
    assert graphed[:2] == eager[:2]
    steps = graphed[1].count("decode")
    assert copies == [True] * steps
    if method == "fastkv":
        assert EagerGraph.made == 1 and graphed[2]._graph.calls == steps
    else:
        assert EagerGraph.made == 0 and graphed[2]._graph is None
