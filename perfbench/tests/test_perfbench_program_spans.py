"""The readers of the program's own spans, on synthetic spans recorded in
``fastkv_tpu_torch.utils.profiling`` and a synthetic device trace: each
reads its value from the spans inside the traced stretch only, gives None
for a stretch with no span, and None for a program without the recorder
(an older one)."""

import itertools
from types import SimpleNamespace

import pytest

from fastkv_tpu_torch.utils import profiling
from perfbench import run
from perfbench.tests import cells
from perfbench.trace import Interval

LO, HI = 10**12, 10**12 + 2 * 10**9  # the traced stretch, ns
MS = 10**6
_ids = itertools.count()


def _span(name, start_ms, end_ms, req=0, device_ms=None):
    return SimpleNamespace(name=name, start_ns=LO + int(start_ms * MS),
                           end_ns=LO + int(end_ms * MS), req=req, id=next(_ids),
                           device_ms=device_ms)


def _offline():
    """One traced Engine.generate (call 5) inside the stretch, and spans of
    an earlier call (4) before it, which no reader may count."""
    spans = [_span("engine.generate", 10, 900, req=5),
             _span("prefill.segment_a", 20, 300, 5, 250.0),
             _span("prefill.tsp", 300, 320, 5, 18.0),
             _span("prefill.segment_b", 320, 400, 5, 75.0)]
    spans += [_span("prefill.select", 30 + 10 * i, 35 + 10 * i, 5, d)
              for i, d in enumerate((2.0, 3.0, 4.0))]
    spans += [_span("decode.step", 500 + 50 * i, 540 + 50 * i, 5) for i in range(4)]
    spans += [_span("engine.generate", -900, -10, req=4),
              _span("prefill.segment_a", -890, -600, 4, 999.0),
              _span("prefill.select", -880, -870, 4, 999.0),
              _span("decode.step", -500, -300, 4)]
    device = ([Interval("prefill", LO + k * MS, LO + (k + 1) * MS) for k in (50, 100, 200)]
              + [Interval("decode", LO + (500 + 30 * k) * MS, LO + (501 + 30 * k) * MS)
                 for k in range(10)]
              + [Interval("after", LO + k * MS, LO + (k + 1) * MS) for k in (950, 1000)])
    return spans, device, {"loop": "closed", "requests": [], "traced_host": []}


def _served():
    """Admission steps and decode steps of a Scheduler's stretch; one step
    of each past its end."""
    spans = [_span("sched.admit_step", 100, 200, 3, 120.0),
             _span("sched.admit_step", 300, 350, 3, 60.0),
             _span("decode.step", 400, 430), _span("decode.step", 450, 470),
             _span("sched.admit_step", 2100, 3099, 4, 999.0),
             _span("decode.step", 2100, 2500)]
    stamp = SimpleNamespace
    reqs = [stamp(req=stamp(submitted_at=1.0, admitted_at=1.25)),
            stamp(req=stamp(submitted_at=2.0, admitted_at=2.75)),
            stamp(req=stamp(submitted_at=4.0, admitted_at=9.0)),  # after the stretch began
            stamp(req=None)]
    # device work of the first step (two operations, the second past its host
    # exit but before its CUDA-event end) and the second; the rest is the
    # decode steps' and the stretch's start
    device = [Interval("k", LO, LO + MS)] + [
        Interval("op", LO + a * MS, LO + b * MS)
        for a, b in ((110, 130), (190, 215), (225, 230), (320, 350), (400, 410))]
    return spans, device, {"loop": "open", "requests": reqs, "traced_host": [(5.0, 6.0)]}


CASES = {
    # metric: (stretch, value)
    "decode.step_host_ms": (_offline, 40.0),
    "decode.ops_per_step": (_offline, 2.5),
    "prefill.segment_a_ms": (_offline, 250.0),
    "prefill.segment_b_ms": (_offline, 75.0),
    "prefill.select_ms": (_offline, 9.0),
    "sched.queue_ms.serve": (_served, 500.0),
    "sched.admit_host_ms.serve": (_served, 75.0),
    "sched.admit_device_ms.serve": (_served, 37.5),
}


def _rec(stretch, monkeypatch, window=(LO, HI)):
    spans, device, rec = stretch()
    monkeypatch.setattr(profiling, "_recorded", spans)
    trace = SimpleNamespace(window=window, device=device, recorded=bool(device))
    return dict(rec, trace=trace)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_takes_the_stretch_only(name, monkeypatch):
    stretch, want = CASES[name]
    got = run.load_metric(cells.REPO, name).read(_rec(stretch, monkeypatch))
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_gives_none_without_spans(name, monkeypatch):
    read = run.load_metric(cells.REPO, name).read
    stretch = CASES[name][0]
    later = (HI + 10 * 10**9, HI + 20 * 10**9)  # a stretch that recorded no span
    if name == "sched.queue_ms.serve":  # its stamps are the Requests', not spans
        rec = _rec(stretch, monkeypatch)
        rec["requests"] = [r for r in rec["requests"] if r.req is None]
        assert read(rec) is None
        return
    assert read(_rec(stretch, monkeypatch, window=later)) is None
    assert read(dict(_rec(stretch, monkeypatch), trace=None)) is None


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_gives_none_for_a_program_without_the_recorder(name, monkeypatch):
    rec = _rec(CASES[name][0], monkeypatch)
    monkeypatch.delattr(profiling, "records")
    for r in rec["requests"]:  # nor an admission stamp
        if r.req is not None:
            del r.req.admitted_at
    assert run.load_metric(cells.REPO, name).read(rec) is None
