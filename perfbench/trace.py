"""Device traces and the harness's own spans.

``Spans`` records named host-clock intervals (``time.time_ns``) around the
harness's calls into the program; they always run and cost a clock read.
``DeviceTrace`` runs ``torch.profiler`` with CUDA activity only (no host
operator recording, which would slow the host-bound paths it measures) over
a bounded stretch and keeps the device's kernels, copies and sets as
(name, start, end) in ns on the same clock as the spans.

Readers (``perfbench/metrics``) take from here: ``busy_ns`` (the union of
device intervals inside a stretch), ``kernel_durations`` (by name marks),
``top_ops`` and ``idle_gaps`` (each gap named by the innermost harness span
the host was in) for the result's ``breakdown``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import torch

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


class Interval(NamedTuple):
    name: str
    start: int  # ns
    end: int


class Spans:
    """Named host intervals, innermost last when they nest."""

    def __init__(self):
        self.items: List[Interval] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append(Interval(name, t0, time.time_ns()))

    def named(self, name: str) -> List[Interval]:
        return [s for s in self.items if s.name == name]


class DeviceTrace:
    """One profiled stretch, between ``start()`` and ``stop()``. The
    profiler's events are read when first asked for (``device``), so a stop
    inside a timed loop costs only the profiler's own stop."""

    def __init__(self):
        self.window: Optional[Tuple[int, int]] = None
        self._prof = None
        self._done = None
        self._device: Optional[List[Interval]] = None
        self._t0 = 0

    def start(self) -> None:
        self._prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        torch.cuda.synchronize()
        self._prof.__enter__()
        self._t0 = time.time_ns()
        self._device = None

    def stop(self) -> None:
        torch.cuda.synchronize()
        t1 = time.time_ns()
        self._prof.__exit__(None, None, None)
        self.window = (self._t0, t1)
        self._done, self._prof = self._prof, None

    @property
    def device(self) -> List[Interval]:
        if self._device is None:
            self._device = _device_intervals(self._done) if self._done is not None else []
            self._done = None
        return self._device

    @property
    def active(self) -> bool:
        return self._prof is not None

    @property
    def recorded(self) -> bool:
        return bool(self.device)


def _device_intervals(prof) -> List[Interval]:
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        kind = e.activity_type() if hasattr(e, "activity_type") else "kernel"
        if kind not in DEVICE_KINDS:
            continue
        s = e.start_ns()
        out.append(Interval(e.name(), s, s + e.duration_ns()))
    out.sort(key=lambda x: x.start)
    return out


def clip(items: Iterable[Interval], lo: int, hi: int) -> List[Interval]:
    return [Interval(i.name, max(i.start, lo), min(i.end, hi)) for i in items
            if i.end > lo and i.start < hi]


def busy_ns(device: Sequence[Interval], lo: int, hi: int) -> int:
    """Length of the union of the device intervals inside [lo, hi]."""
    total, cur_s, cur_e = 0, None, None
    for i in clip(device, lo, hi):
        if cur_e is None or i.start > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = i.start, i.end
        else:
            cur_e = max(cur_e, i.end)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_pct(device: Sequence[Interval], lo: int, hi: int) -> Optional[float]:
    """Share of [lo, hi] with nothing running on the device; None when the
    stretch recorded no device activity."""
    inside = clip(device, lo, hi)
    if not inside or hi <= lo:
        return None
    return 100.0 * (1.0 - busy_ns(inside, lo, hi) / (hi - lo))


def kernel_durations(device: Sequence[Interval], marks: Sequence[str], lo: int,
                     hi: int) -> List[int]:
    """Durations (ns) of the kernels starting in [lo, hi] whose name holds
    one of ``marks``."""
    return [i.end - i.start for i in device
            if lo <= i.start < hi and any(m in i.name for m in marks)]


def top_ops(device: Sequence[Interval], lo: int, hi: int, n: int = 10) -> List[list]:
    """The n device operations with the most time in [lo, hi], in seconds."""
    acc: Dict[str, int] = {}
    for i in clip(device, lo, hi):
        acc[i.name] = acc.get(i.name, 0) + i.end - i.start
    top = sorted(acc.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], ns / 1e9] for name, ns in top]


def idle_gaps(device: Sequence[Interval], spans: Sequence[Interval], lo: int, hi: int,
              n: int = 10) -> List[list]:
    """The n longest device-idle gaps in [lo, hi], in seconds, each named by
    the innermost harness span around its middle ("harness" for none)."""
    gaps, cur = [], lo
    for i in clip(device, lo, hi):
        if i.start > cur:
            gaps.append((cur, i.start))
        cur = max(cur, i.end)
    if hi > cur:
        gaps.append((cur, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    out = []
    for g0, g1 in gaps[:n]:
        mid = (g0 + g1) // 2
        around = [s for s in spans if s.start <= mid <= s.end]
        name = min(around, key=lambda s: s.end - s.start).name if around else "harness"
        out.append([name, (g1 - g0) / 1e9])
    return out
