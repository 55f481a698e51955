"""The reader of ``decode.graph_share``, on synthetic spans recorded in
``fastkv_tpu_torch.utils.profiling``: the share of the traced stretch's
``decode.step`` spans whose count ``graph`` is 1. It counts the stretch
only, and gives None for a stretch with no step, for a program whose steps
carry no ``graph`` count (one without decode graphs), and for a program
without the recorder."""

import itertools
from types import SimpleNamespace

import pytest

from fastkv_tpu_torch.utils import profiling
from perfbench import run
from perfbench.tests import cells

LO, HI = 10**12, 10**12 + 2 * 10**9  # the traced stretch, ns
MS = 10**6
_ids = itertools.count()


def _step(start_ms, end_ms, req=0, **counts):
    return SimpleNamespace(name="decode.step", start_ns=LO + int(start_ms * MS),
                           end_ns=LO + int(end_ms * MS), req=req, id=next(_ids),
                           device_ms=None, counts=counts)


def _offline():
    """A traced call's steps: the first eager, the rest replayed; a step of
    an earlier call before the stretch, eager, which the reader may not count;
    and a span of another name."""
    spans = [_step(500 + 50 * i, 540 + 50 * i, 5, graph=int(i > 0)) for i in range(4)]
    spans += [_step(-500, -300, 4, graph=0),
              SimpleNamespace(name="engine.generate", start_ns=LO + 10 * MS,
                              end_ns=LO + 900 * MS, req=5, id=next(_ids),
                              device_ms=None, counts={})]
    return spans


def _served():
    """A Scheduler's replayed steps, and an eager one past the stretch's end."""
    return [_step(400, 430, graph=1), _step(450, 470, graph=1),
            _step(2100, 2500, graph=0)]


def _older():
    """A program before the decode graphs: its steps have no ``graph`` count."""
    return [_step(500 + 50 * i, 540 + 50 * i, 5) for i in range(4)]


STRETCHES = {"offline": (_offline, 0.75), "served": (_served, 1.0), "older": (_older, None)}


def _read(spans, monkeypatch, window=(LO, HI), trace=True):
    monkeypatch.setattr(profiling, "_recorded", spans)
    tr = SimpleNamespace(window=window, device=[], recorded=False) if trace else None
    return run.load_metric(cells.REPO, "decode.graph_share").read({"trace": tr})


@pytest.mark.parametrize("stretch", sorted(STRETCHES))
def test_reads_the_share_of_replayed_steps_in_the_stretch(stretch, monkeypatch):
    make, want = STRETCHES[stretch]
    got = _read(make(), monkeypatch)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("stretch", sorted(STRETCHES))
@pytest.mark.parametrize("where", ["later_stretch", "no_trace"])
def test_gives_none_without_steps(stretch, where, monkeypatch):
    spans = STRETCHES[stretch][0]()
    if where == "later_stretch":  # a stretch that recorded no span
        got = _read(spans, monkeypatch, window=(HI + 10 * 10**9, HI + 20 * 10**9))
    else:
        got = _read(spans, monkeypatch, trace=False)
    assert got is None


@pytest.mark.parametrize("stretch", sorted(STRETCHES))
def test_gives_none_for_a_program_without_the_recorder(stretch, monkeypatch):
    monkeypatch.delattr(profiling, "records")
    assert _read(STRETCHES[stretch][0](), monkeypatch) is None
