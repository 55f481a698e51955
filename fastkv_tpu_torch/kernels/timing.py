"""How the port's kernels are timed and inspected on the card: shared by
``chip_smoke.py``, ``kernels/flash_probe.py`` and ``kernels/decode_probe.py``,
so that a probe's numbers are taken as the smoke run's are.

  * ``events_ms``: CUDA events around back-to-back calls from Python. Right
    for calls of a millisecond or more; for a call of tens of microseconds
    (a decode call) it times the host's launches instead.
  * ``graph_ms``: the calls captured in one CUDA graph, replayed between
    events, so the host's launch gaps drop out: device time per call.
  * ``layer_sdpa``: the yardstick, one ``F.scaled_dot_product_attention``
    call a layer over the same layers the kernel cycles through.
  * ``ptxas_spills``: which kernels spill, from a build's ``ptxas -v`` report.

The card's peak rates (H100 SXM: NVIDIA's data sheet) turn work into bounds.
"""

from __future__ import annotations

import itertools
import re
from typing import Callable, Dict, List

import torch

PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12  # float32 rate outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3 rate


def events_ms(fn: Callable[[], object], reps: int, warmup: int = 2) -> float:
    """Mean ms per call of fn() over reps back-to-back calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn: Callable[[], object], calls: int, replays: int = 10) -> float:
    """Device ms per call of ``calls`` calls of fn captured in one CUDA graph
    and replayed ``replays`` times between CUDA events: the host's launch
    gaps, which back-to-back calls from Python leave between kernels of
    tens of microseconds, drop out. fn launches on the current stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up on the capture stream
        for _ in range(calls):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


def layer_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               masks: torch.Tensor) -> Callable[[], torch.Tensor]:
    """A call of one PyTorch library function for the same attention, each
    call on the next of the L layers of k/v ([L, b, KH, S, d]) with its
    boolean mask (masks[l] broadcast to [b, H, Sq, S]): K/V repeated to the
    query heads beforehand, the mask explicit. A yardstick only: the port
    never calls it."""
    g = q.shape[1] // k.shape[2]
    kr = [k[l].repeat_interleave(g, dim=1) for l in range(k.shape[0])]
    vr = [v[l].repeat_interleave(g, dim=1) for l in range(v.shape[0])]
    layers = itertools.cycle(range(len(kr)))

    def call():
        l = next(layers)
        return torch.nn.functional.scaled_dot_product_attention(q, kr[l], vr[l],
                                                                attn_mask=masks[l])
    return call


def ptxas_spills(log: str) -> Dict[str, List[int]]:
    """{kernel entry: [spill store bytes, spill load bytes]} from a ptxas -v
    report."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            out[name] = [int(m.group(1)), int(m.group(2))]
            name = None
    return out
