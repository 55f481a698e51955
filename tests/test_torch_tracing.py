"""The port's own spans (``utils.profiling.span``) on the CPU, tiny config.

Spans are recorded only while a ``torch.profiler`` session runs: without
one a FastKV ``Engine.generate`` and a chunked ``Scheduler`` run record none
and make no CUDA event. Under one, the Engine records its call, its prefill
with the FastKV segments and one keep-set selection a layer, and its decode
steps, each under the right parent and with its counts; a chunked admission
records one admission step per ``chunk`` event, the last a finish that holds
the install; a span's clock is kineto's (an operator launched inside a span
starts inside it), and ``profiling.trace`` writes the spans into its Chrome
trace beside the operators. Tracing changes no token, kept set or event. ``Request``
stamps ``admitted_at`` when it leaves the queue. The harness's wrappers of
``decode.greedy_generate`` and ``prefill.tsp_gather`` (perfbench's ``Spy``)
still see the Engine's calls. An eager decode step counts ``graph`` 0; a
replayed one (``decode.StepGraph``, its CUDA calls stood in for here) counts
1, and its capture records a ``decode.capture`` span.
"""

import contextlib
import json
import time
from collections import Counter

import numpy as np
import pytest
import torch

from fastkv_tpu_torch.core.config import EngineConfig, Method, MethodConfig, ModelConfig
from fastkv_tpu_torch.engine import decode as decode_mod
from fastkv_tpu_torch.engine import prefill as prefill_mod
from fastkv_tpu_torch.engine.generate import Engine
from fastkv_tpu_torch.engine.scheduler import Scheduler
from fastkv_tpu_torch.models.llama import init_params
from fastkv_tpu_torch.utils import profiling
from fastkv_tpu_torch.utils.testing import one_thread_per_module

_one_torch_thread = one_thread_per_module()

BUCKET, N_PROMPT, NEW, CHUNK = 256, 201, 6, 64
MCFG = MethodConfig(method=Method.FASTKV, eviction_mode="proportional", retain_rate=0.3,
                    tsp_rate=0.5, tsp_idx=1)
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(scope="module")
def model():
    cfg = ModelConfig.tiny(dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompts = [np.random.default_rng(i).integers(0, cfg.vocab_size, n).tolist()
               for i, n in enumerate((N_PROMPT, 150, 90))]
    return cfg, params, prompts


def _engine(model):
    cfg, params, _ = model
    ecfg = EngineConfig(prefill_buckets=(BUCKET,), max_new_tokens=8, capacity_align=8)
    return Engine(params, cfg, MCFG, ecfg, device="cpu")


def _serve(model):
    """A chunked Scheduler: one request admits alone, two more chunk-wise
    while it decodes -> (tokens by request, event kinds, finished)."""
    cfg, params, prompts = model
    ecfg = EngineConfig(prefill_buckets=(BUCKET,), max_new_tokens=24, capacity_align=8,
                        prefill_chunk=CHUNK)
    s = Scheduler(params, cfg, MCFG, ecfg, max_batch=3, bucket=BUCKET, max_new_tokens=24,
                  device="cpu")
    s.submit(prompts[0], 20)
    rounds = [0]

    def intake():
        rounds[0] += 1
        if rounds[0] == 3:
            s.submit(prompts[1], 6)
            s.submit(prompts[2], 4)
        return rounds[0] < 3

    done = s._run_loop(intake=intake)
    return ({r.req_id: r.tokens for r in done}, [k for k, _ in s.events], s, done)


class _CountedEvent:
    """Stands in for ``torch.cuda.Event``: counts constructions, and keeps
    time on the host clock."""

    made = 0

    def __init__(self, enable_timing=False):
        type(self).made += 1
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 1e3 * (end.t - self.t)


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_no_profiler_records_nothing_and_makes_no_event(model, monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _CountedEvent)
    _CountedEvent.made = 0
    lo = time.time_ns()
    _engine(model).generate([model[2][0]], NEW)
    _serve(model)
    assert profiling.records(lo) == [] and _CountedEvent.made == 0
    # the same span site under a profiler makes its pair (the count is live)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with torch.profiler.profile(activities=CPU):
        with profiling.span("probe", device=True) as sp:
            pass
    assert _CountedEvent.made == 2 and sp.device_ms >= 0.0


def test_engine_spans_nest_and_count(model):
    eng = _engine(model)
    cfg, _, prompts = model
    with torch.profiler.profile(activities=CPU) as prof:
        lo = time.time_ns()
        eng.generate([prompts[0]], NEW)
        hi = time.time_ns()
    spans = profiling.records(lo, hi)
    by = _by_name(spans)
    ids = {s.id: s for s in spans}
    [gen] = by["engine.generate"]
    assert gen.parent is None and gen.counts == {"rows": 1, "bucket": BUCKET,
                                                 "lens": [N_PROMPT]}
    [pre] = by["engine.prefill"]
    assert pre.parent == gen.id and pre.device_ms is None  # no card
    shapes = eng.shapes_for(BUCKET, NEW)
    [a], [t], [b] = by["prefill.segment_a"], by["prefill.tsp"], by["prefill.segment_b"]
    assert {a.parent, t.parent, b.parent} == {pre.id}
    assert a.end_ns <= t.start_ns and t.end_ns <= b.start_ns
    assert a.counts == {"rows": BUCKET} and b.counts == {"rows": shapes.tsp_capacity}
    assert t.counts == {"tsp_capacity": shapes.tsp_capacity}
    select = by["prefill.select"]
    assert [s.counts["layer"] for s in select] == list(range(cfg.num_layers))
    segment_of = [a.id] * MCFG.tsp_idx + [t.id] + [b.id] * (cfg.num_layers - MCFG.tsp_idx - 1)
    assert [s.parent for s in select] == segment_of
    [loop] = by["decode.loop"]
    assert loop.parent == gen.id and loop.counts == {"steps": NEW - 1}
    steps = by["decode.step"]
    assert len(steps) == NEW - 1 and all(s.parent == loop.id
                                         and s.counts == {"b": 1, "graph": 0} for s in steps)
    for inner in ("decode.layers", "decode.head"):
        assert [ids[s.parent].name for s in by[inner]] == ["decode.step"] * (NEW - 1)
    assert {s.req for s in spans} == {gen.req}
    # the clock: every LM head of a decode step launched an operator, which
    # kineto stamped inside that span
    ops = [e.start_ns() for e in prof.profiler.kineto_results.events()
           if e.name().startswith("aten::")]
    assert all(any(h.start_ns <= o <= h.end_ns for o in ops) for h in by["decode.head"])


def test_operator_starts_inside_its_span_and_trace_file_holds_it(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.span("probe", req=7, n=3) as sp:
            torch.ones(64).add_(1.0)
    [add] = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::add_"]
    assert sp.start_ns <= add.start_ns() <= sp.end_ns
    doc = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    events = doc["traceEvents"]
    [probe] = [e for e in events if e.get("cat") == "program_span" and e["name"] == "probe"]
    assert probe["args"]["req"] == 7 and probe["args"]["n"] == 3
    row = [e for e in events if e.get("ph") == "M" and e.get("tid") == probe["tid"]]
    assert row and row[0]["args"]["name"].startswith("program spans")
    [op] = [e for e in events if e.get("name") == "aten::add_"]
    assert probe["ts"] <= op["ts"] and op["ts"] + op["dur"] <= probe["ts"] + probe["dur"]


def test_chunked_admission_spans_follow_the_events(model, monkeypatch):
    install = Scheduler._install

    def traced_install(self, slot, req, *a):
        with profiling.span("test.install", req=req.req_id):
            return install(self, slot, req, *a)

    monkeypatch.setattr(Scheduler, "_install", traced_install)
    with torch.profiler.profile(activities=CPU):
        lo = time.time_ns()
        _, _, sched, _ = _serve(model)
        hi = time.time_ns()
    spans = profiling.records(lo, hi)
    by = _by_name(spans)
    ids = {s.id: s for s in spans}
    admits = [(s.req, s.counts["kind"]) for s in by["sched.admit_step"]]
    events = [e for e in sched.events if e[0] != "decode"]
    assert [(r, k) for r, k in admits if k == "prefill"] == [
        (rid, "prefill") for kind, rid in events if kind == "prefill"]
    chunked = [(r, k) for r, k in admits if k != "prefill"]
    assert [r for r, _ in chunked] == [rid for kind, rid in events if kind == "chunk"]
    finishes = [rid for kind, rid in events if kind == "finish"]
    assert [r for r, k in chunked if k == "finish"] == finishes == [1, 2]
    # every kind of admission step holds its install, the finish's too
    installs = [(s.req, ids[s.parent].name, ids[s.parent].counts["kind"])
                for s in by["test.install"]]
    assert sorted(installs) == [(0, "sched.admit_step", "prefill"),
                                (1, "sched.admit_step", "finish"),
                                (2, "sched.admit_step", "finish")]
    steps = by["decode.step"]
    assert len(steps) == Counter(k for k, _ in sched.events)["decode"]
    assert all(s.parent is None for s in steps)


def test_tracing_changes_no_token_set_or_event(model):
    cfg, params, prompts = model
    eng = _engine(model)
    shapes = eng.shapes_for(BUCKET, NEW)
    tokens = torch.zeros((1, BUCKET), dtype=torch.int32)
    tokens[0, :N_PROMPT] = torch.tensor(prompts[0])
    n_true = torch.tensor([N_PROMPT], dtype=torch.int32)

    def run():
        _, cache = prefill_mod.prefill(params, cfg, MCFG, shapes, tokens, n_true)
        return eng.generate([prompts[0]], NEW), cache, _serve(model)[:2]

    off = run()
    with torch.profiler.profile(activities=CPU):
        on = run()
    assert on[0] == off[0] and on[2] == off[2]
    assert torch.equal(on[1].pos, off[1].pos) and torch.equal(on[1].valid, off[1].valid)


def test_admitted_at_lies_between_submit_and_first_token(model):
    *_, done = _serve(model)
    for r in done:
        assert r.submitted_at <= r.admitted_at <= r.prefill_done_at
        assert r.metrics["queue_s"] == r.admitted_at - r.submitted_at


def test_harness_wrappers_still_see_the_engine(model, monkeypatch):
    seen = []
    orig_gen, orig_gather = decode_mod.greedy_generate, prefill_mod.tsp_gather

    def greedy_generate(*a, **kw):
        seen.append("decode")
        return orig_gen(*a, **kw)

    def tsp_gather(state, tsp):
        seen.append("tsp")
        return orig_gather(state, tsp)

    monkeypatch.setattr(decode_mod, "greedy_generate", greedy_generate)
    monkeypatch.setattr(prefill_mod, "tsp_gather", tsp_gather)
    _engine(model).generate([model[2][0]], NEW)
    assert seen == ["tsp", "decode"]


class _FakeStream:
    cuda_stream = 7

    def wait_stream(self, other):
        pass


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: counts captures and replays."""

    def __init__(self):
        self.captures = self.replays = 0

    def capture_begin(self, **kw):
        self.captures += 1

    def capture_end(self):
        pass

    def replay(self):
        self.replays += 1


def test_step_graph_spans_count_its_replays(monkeypatch):
    """``decode.StepGraph``'s bookkeeping with the CUDA calls stood in for:
    its first call runs the step (its own ``decode.step`` span, ``graph``
    0) and captures it under ``decode.capture``; each later call records a
    ``decode.step`` span with ``graph`` 1 around the replay alone (no span
    of the step's Python inside it), and counts the decode kernel's
    launches, the prologue's and the norm kernel's the capture held, the
    prologue's and the norm's also as the capture span's counts
    ``prologue`` and ``norm``; counts that an earlier capture left on the
    stream's handle are not the graph's."""
    from fastkv_tpu_torch.ops import add_rms_norm, decode_attn, decode_prologue

    stream = _FakeStream()
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)

    def captured(fake):  # what the step launched while it was captured, added as a launch adds
        held = decode_attn._captured.setdefault(stream.cuda_stream, [0, 0, 0])
        held[:] = [n + 4 for n in held[:2]] + held[2:]
        decode_prologue._captured[stream.cuda_stream] = (
            decode_prologue._captured.get(stream.cuda_stream, 0) + 4)
        add_rms_norm._captured[stream.cuda_stream] = (
            add_rms_norm._captured.get(stream.cuda_stream, 0) + 8)

    monkeypatch.setattr(_FakeGraph, "capture_end", captured)
    runs = []

    def step():
        with profiling.span("decode.step", b=2, graph=0):
            with profiling.span("decode.layers"):
                runs.append(1)

    graph = decode_mod.StepGraph(torch.device("cuda"))
    before = (decode_attn.launches, decode_attn.int8_launches, decode_prologue.launches,
              add_rms_norm.launches)
    with torch.profiler.profile(activities=CPU):
        lo = time.time_ns()
        # left by an earlier capture on a stream at the same handle
        decode_attn._captured[stream.cuda_stream] = [160, 0, 0]
        decode_prologue._captured[stream.cuda_stream] = 160
        add_rms_norm._captured[stream.cuda_stream] = 320
        for _ in range(4):
            graph(step, b=2)
        hi = time.time_ns()
    by = _by_name(profiling.records(lo, hi))
    ids = {s.id: s for v in by.values() for s in v}
    assert len(runs) == 2 and graph.graph.captures == 1 and graph.graph.replays == 3
    [cap] = by["decode.capture"]
    assert cap.counts == {"b": 2, "prologue": 4, "norm": 8}
    steps = by["decode.step"]
    assert [s.counts["graph"] for s in steps] == [0, 0, 1, 1, 1]
    assert ids[steps[1].parent] is cap and all(s.parent is None for s in steps[2:])
    assert all(s.counts == {"b": 2, "graph": 1} for s in steps[2:])
    assert [ids[s.parent].counts["graph"] for s in by["decode.layers"]] == [0, 0]
    assert (decode_attn.launches - before[0], decode_attn.int8_launches - before[1],
            decode_prologue.launches - before[2], add_rms_norm.launches - before[3]) == (
                12, 12, 12, 24)
    assert stream.cuda_stream not in decode_attn._captured
    assert stream.cuda_stream not in decode_prologue._captured
    assert stream.cuda_stream not in add_rms_norm._captured
