"""On the card only (marked ``cuda``; each test decides inside whether there
is one): the device trace records kernels on the clock of the harness's
spans, so an idle gap is named by the span the host was in."""

import time

import pytest
import torch

from perfbench import trace


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_trace_records_kernels_inside_their_span(card):
    x = torch.randn(2048, 2048, device=card)
    x @ x
    spans = trace.Spans()
    dt = trace.DeviceTrace()
    recorded = False
    for _ in range(3):  # the profiler there records nothing in some windows
        dt.start()
        with spans.span("work"):
            for _ in range(20):
                x = torch.tanh(x @ x)
            torch.cuda.synchronize()
        with spans.span("sleep"):
            time.sleep(0.05)
        dt.stop()
        if dt.recorded:
            recorded = True
            break
    assert recorded
    lo, hi = dt.window
    work = spans.named("work")[-1]
    inside = [i for i in dt.device if work.start <= i.start <= work.end]
    assert len(inside) >= 20
    assert trace.busy_ns(dt.device, lo, hi) > 0
    idle = trace.idle_pct(dt.device, lo, hi)
    assert 0.0 < idle < 100.0
    gaps = trace.idle_gaps(dt.device, spans.items, lo, hi)
    assert gaps[0][0] == "sleep" and gaps[0][1] > 0.04
