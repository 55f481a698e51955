"""Tracing, memory and roofline helpers.

Port of ``fastkv_tpu.utils.profiling``:
  * ``trace``: a ``torch.profiler`` capture (CPU and, with a card, CUDA
    activity) exported as a Chrome trace (``trace.json``, for Perfetto or
    chrome://tracing);
  * ``memory_stats`` and ``peak_bytes``: the CUDA caching allocator's
    counters (None on the CPU);
  * ``Roofline``: speed-of-light accounting at the H100's peak rates
    (``kernels.timing``), never another device's; the flash prefill's work
    is counted by the same function as ``chip_smoke.py``'s bounds;
  * ``PhaseLogger``: JSON lines of per-phase records.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, Optional

import torch

from fastkv_tpu_torch.kernels.timing import PEAK_BF16_FLOPS, PEAK_BYTES, flash_work

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block; writes ``<log_dir>/trace.json`` at its end."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def _cuda(device) -> Optional[torch.device]:
    dev = torch.device(device)
    return dev if dev.type == "cuda" and torch.cuda.is_available() else None


def memory_stats(device="cuda") -> Optional[Dict[str, Any]]:
    dev = _cuda(device)
    return None if dev is None else dict(torch.cuda.memory_stats(dev))


def peak_bytes(device="cuda") -> Optional[int]:
    """Peak bytes allocated on the card since the last
    ``torch.cuda.reset_peak_memory_stats`` (None on the CPU)."""
    dev = _cuda(device)
    return None if dev is None else int(torch.cuda.max_memory_allocated(dev))


@dataclass
class Roofline:
    """Speed-of-light accounting for one op or phase."""

    flops: float
    bytes_moved: float
    seconds: float
    peak_tflops: float = PEAK_BF16_FLOPS / 1e12
    peak_gbps: float = PEAK_BYTES / 1e9

    @property
    def achieved_tflops(self) -> float:
        return self.flops / self.seconds / 1e12

    @property
    def achieved_gbps(self) -> float:
        return self.bytes_moved / self.seconds / 1e9

    @property
    def compute_bound(self) -> bool:
        return (self.flops / (self.peak_tflops * 1e12)) >= (
            self.bytes_moved / (self.peak_gbps * 1e9))

    @property
    def ideal_seconds(self) -> float:
        return max(self.flops / (self.peak_tflops * 1e12),
                   self.bytes_moved / (self.peak_gbps * 1e9))

    @property
    def efficiency(self) -> float:
        return self.ideal_seconds / self.seconds

    def report(self) -> Dict[str, Any]:
        return {
            "achieved_tflops": round(self.achieved_tflops, 2),
            "achieved_gbps": round(self.achieved_gbps, 1),
            "bound": "compute" if self.compute_bound else "memory",
            "ideal_s": round(self.ideal_seconds, 5),
            "measured_s": round(self.seconds, 5),
            "efficiency": round(self.efficiency, 3),
        }


def attention_prefill_roofline(
    seconds: float, s: int, d: int, num_heads: int, num_kv_heads: int,
    b: int = 1, count: Optional[int] = None, dtype=torch.bfloat16,
) -> Roofline:
    """The flash kernel's causal square form over ``count`` valid rows of
    ``s`` (all by default) an example, its work counted as ``chip_smoke.py``
    counts it (``kernels.timing.flash_work``)."""
    q = torch.empty((b, num_heads, s, d), dtype=dtype, device="meta")
    k = torch.empty((b, num_kv_heads, s, d), dtype=dtype, device="meta")
    pos = torch.arange(s, dtype=torch.int32).expand(b, s)
    cnt = torch.full((b,), s if count is None else count, dtype=torch.int32)
    flops, nbytes = flash_work(q, k, k, pos, cnt)
    return Roofline(flops=flops, bytes_moved=nbytes, seconds=seconds)


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
