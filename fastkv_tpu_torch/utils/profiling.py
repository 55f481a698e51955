"""Tracing and memory helpers.

Port of ``fastkv_tpu.utils.profiling``:
  * ``span`` and ``records``: the program's own spans at the boundaries of
    its layers (``Engine.generate`` and its prefill, the prefill segments
    and keep-sets, the decode loop and steps, the Scheduler's admission
    steps), each with the counts the host already knows. They are recorded
    only while a ``torch.profiler`` session runs in the process, on the
    clock of its device events (``time.time_ns``); a span asked for the
    device's time also takes a pair of CUDA events on the current stream;
  * ``trace``: a ``torch.profiler`` capture (CPU and, with a card, CUDA
    activity) exported as a Chrome trace (``trace.json``, for Perfetto or
    chrome://tracing), with the spans recorded inside it in rows of their
    own beside the operators and kernels;
  * ``peak_bytes``: the CUDA caching allocator's peak (None on the CPU);
  * ``PhaseLogger``: JSON lines of per-phase records.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

import torch

TRACE_FILE = "trace.json"
# the recorder keeps the newest this many spans of the process
SPANS_CAP = 1 << 16
# Chrome-trace thread ids of the span rows, one per recording thread, counted
# down from here (above any operating-system thread id)
SPAN_ROW_TID = (1 << 31) - 1

# torch.profiler sets this module's _is_profiler_enabled while a session runs
_autograd_profiler = torch.autograd.profiler
_OFF = contextlib.nullcontext()
_recorded: "collections.deque[Span]" = collections.deque(maxlen=SPANS_CAP)
_ids = itertools.count()
_open = threading.local()  # .stack: the spans open on this thread, innermost last


def _stack() -> List["Span"]:
    try:
        return _open.stack
    except AttributeError:
        _open.stack = []
        return _open.stack


class Span:
    """One recorded span: ``name``; ``start_ns`` and ``end_ns`` on
    ``time.time_ns``'s clock, which kineto stamps its events on; ``id``, and
    ``parent``, the id of the span open around it on the same thread (None
    at the top); ``req``, a Scheduler request's id or an ``Engine.generate``
    call's number, taken from the parent where the site gives none;
    ``counts``, numbers the host already knows (never read from the device);
    ``thread``; and ``device_ms``."""

    __slots__ = ("id", "parent", "name", "req", "counts", "thread", "start_ns", "end_ns",
                 "_events", "_device_ms")

    def __init__(self, name: str, req: Any, device: bool, counts: Dict[str, Any]):
        self.name, self.req, self.counts = name, req, counts
        self._events = ((torch.cuda.Event(enable_timing=True),
                         torch.cuda.Event(enable_timing=True))
                        if device and torch.cuda.is_available() else None)
        self._device_ms: Optional[float] = None

    def __enter__(self) -> "Span":
        stack = _stack()
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = None if up is None else up.id
        if self.req is None and up is not None:
            self.req = up.req
        self.thread = threading.get_ident()
        stack.append(self)
        if self._events is not None:
            self._events[0].record()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end_ns = time.time_ns()
        if self._events is not None:
            self._events[1].record()
        _stack().pop()
        _recorded.append(self)
        return False

    @property
    def device_ms(self) -> Optional[float]:
        """Milliseconds on the current CUDA stream from the span's entry to
        its exit (the device's idle time inside included); None for a span
        that asked for none, or without a card. Resolving it waits for the
        exit's event, so read it after the traced work has ended."""
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
            self._events = None
        return self._device_ms


def span(name: str, *, req: Any = None, device: bool = False, **counts):
    """A context manager around one step of the program, yielding its
    ``Span`` while a ``torch.profiler`` session runs in the process. With
    none it is a shared no-op that yields None, and costs one attribute
    read and the call's arguments: no clock, no span, no CUDA event.
    ``device=True`` also times the current CUDA stream (``Span.device_ms``)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return Span(name, req, device, counts)


def records(lo_ns: Optional[int] = None, hi_ns: Optional[int] = None) -> List[Span]:
    """The closed spans that lie inside [lo_ns, hi_ns] on ``time.time_ns``'s
    clock (every one kept, by default), by start; the newest ``SPANS_CAP``
    of the process are kept."""
    lo = -1 if lo_ns is None else lo_ns
    hi = float("inf") if hi_ns is None else hi_ns
    inside = [s for s in _recorded.copy() if lo <= s.start_ns and s.end_ns <= hi]
    return sorted(inside, key=lambda s: (s.start_ns, s.id))


def _write_spans(path: str, spans: List[Span]) -> None:
    """Add ``spans`` to the Chrome trace at ``path``, on its time base
    (microseconds from ``baseTimeNanoseconds``, where the file has one), one
    row a recording thread."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    rows: Dict[int, int] = {}
    events = doc.setdefault("traceEvents", [])
    for s in spans:
        tid = rows.setdefault(s.thread, SPAN_ROW_TID - len(rows))
        args = {"id": s.id, "parent": s.parent, "req": s.req, **s.counts}
        if s.device_ms is not None:
            args["device_ms"] = s.device_ms
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid, "tid": tid,
                       "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": args})
    for thread, tid in rows.items():
        events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                       "args": {"name": f"program spans (thread {thread})"}})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block; writes ``<log_dir>/trace.json`` at its
    end, the program's spans recorded inside the block with it."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        lo = time.time_ns()
        yield prof
        hi = time.time_ns()
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    _write_spans(path, records(lo, hi))


def _cuda(device) -> Optional[torch.device]:
    dev = torch.device(device)
    return dev if dev.type == "cuda" and torch.cuda.is_available() else None


def peak_bytes(device="cuda") -> Optional[int]:
    """Peak bytes allocated on the card since the last
    ``torch.cuda.reset_peak_memory_stats`` (None on the CPU)."""
    dev = _cuda(device)
    return None if dev is None else int(torch.cuda.max_memory_allocated(dev))


@dataclass
class PhaseLogger:
    """Structured JSONL logging of engine phases (queue/prefill/decode).
    Each record is one write of its whole line under the logger's lock, so
    threads sharing a logger (serving replicas) never interleave lines."""

    stream: Any = field(default_factory=lambda: sys.stderr)
    _lock: threading.Lock = field(default_factory=threading.Lock, init=False, repr=False)

    def log(self, phase: str, **fields) -> Dict[str, Any]:
        rec = {"ts": time.time(), "phase": phase, **fields}
        line = json.dumps(rec) + "\n"
        with self._lock:
            self.stream.write(line)
            self.stream.flush()
        return rec

    def request_metrics(self, req) -> Dict[str, Any]:
        """Log a finished ``fastkv_tpu_torch.engine.scheduler.Request``."""
        return self.log("request_done", **req.metrics)
