"""How the port's kernels are timed and inspected on the card: shared by
``chip_smoke.py``, ``kernels/flash_probe.py`` and ``kernels/decode_probe.py``,
so that a probe's numbers are taken as the smoke run's are.

  * ``events_ms``: CUDA events around back-to-back calls from Python. Right
    for calls of a millisecond or more; for a call of tens of microseconds
    (a decode call) it times the host's launches instead.
  * ``graph_ms``: the calls captured in one CUDA graph, replayed between
    events, so the host's launch gaps drop out: device time per call.
  * ``layer_sdpa``: a yardstick, one ``F.scaled_dot_product_attention``
    call a layer over the same layers the kernel cycles through, its mask
    explicit (which keeps sdpa off its fused flash and cuDNN backends);
  * ``sdpa_causal``: the fair yardstick for a causal form with every key
    valid: sdpa with no explicit mask (``is_causal=True``, or the
    lower-right causal bias for a query chunk at the end of its keys), K/V
    by ``enable_gqa`` or repeated beforehand; ``sdpa_choice`` names the
    backend sdpa's dispatcher picks for it, ``sdpa_backend`` the one the
    kernels it launched belong to;
  * ``flash_work``: the operations and bytes a flash prefill call needs,
    for its bound.
  * ``ptxas_spills``: which kernels spill, from a build's ``ptxas -v`` report.

The card's peak rates (H100 SXM: NVIDIA's data sheet) turn work into bounds.
"""

from __future__ import annotations

import itertools
import re
from typing import Callable, Dict, List, Tuple

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


def sdpa_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, gqa: bool,
                lower_right: bool = False) -> Callable[[], torch.Tensor]:
    """A call of ``F.scaled_dot_product_attention`` for causal attention over
    every key, with no explicit mask: ``is_causal=True`` (query i sees keys
    0..i), or with ``lower_right`` the lower-right causal bias (the queries
    are the last of the keys: query i of s sees keys 0..i + S - s). K/V
    ([b, KH, S, d]) go to the H query heads by ``enable_gqa`` (``gqa``) or
    repeated beforehand. A yardstick only: the port never calls it."""
    F = torch.nn.functional
    kw = {}
    if gqa:
        kw["enable_gqa"] = True
    else:
        g = q.shape[1] // k.shape[1]
        k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    if lower_right:
        from torch.nn.attention.bias import causal_lower_right

        bias = causal_lower_right(q.shape[2], k.shape[2])
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=bias, **kw)
    return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, **kw)


def sdpa_choice(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, gqa: bool) -> str:
    """The backend ``sdpa_causal(q, k, v, gqa)`` takes with is_causal=True, as
    sdpa's dispatcher picks it (``torch._fused_sdp_choice``): 'flash_attention',
    'cudnn_attention', 'efficient_attention' or 'math'."""
    kw = {}
    if gqa:
        kw["enable_gqa"] = True
    else:
        g = q.shape[1] // k.shape[1]
        k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    choice = int(torch._fused_sdp_choice(q, k, v, None, 0.0, True, **kw))
    return torch.nn.attention.SDPBackend(choice).name.lower()


# sdpa's backends and marks of their kernels' names, cuDNN's first (its
# kernels' names may also say "flash")
SDPA_KERNEL_MARKS = (("cudnn", ("cudnn",)), ("flash", ("flash",)),
                     ("efficient", ("fmha", "efficient", "mem_eff")))


def sdpa_backend(kernel_names) -> str:
    """The backend an sdpa call took, from the names of the kernels it
    launched ('math' for any other kernels, 'not recorded' for none)."""
    joined = " ".join(kernel_names).lower()
    for backend, marks in SDPA_KERNEL_MARKS:
        if any(m in joined for m in marks):
            return backend
    return "math" if joined else "not recorded"


def flash_work(q, k, v, pos, cnt, window=None, kpos=None, aux=False) -> Tuple[int, int]:
    """(FLOP, bytes) this call needs: 4*d per visible (query, key) pair and
    query head, the pairs counted on this call's mask (causal, and under a
    sliding window only the band's); each input read once and the output
    written once (the bound that ``chip_smoke.py`` puts beside the square
    and rectangular forms). ``kpos``: the folded key positions of a rectangular call
    (by default those of the square one). In the square form the rows at or
    past an example's count see no key and are written as 0, and the keys
    there are folded out: its q, k, v and positions count over ``cnt`` rows,
    its output over all s. ``aux``: the row statistics (m, l) [b, H, s]
    float32 are written too. A rectangular call whose keys all precede its
    queries (the 'full' pattern of ring attention) counts every pair: 4 * b
    * H * s * sk * d, no causal halving."""
    from fastkv_tpu_torch.ops import flash_prefill as fp

    square = kpos is None
    if square:
        kpos = fp.fold_key_validity(pos, cnt)
    pairs = 0
    for i in range(q.shape[0]):
        srt = kpos[i].sort().values
        qp = pos[i].contiguous()
        seen = torch.searchsorted(srt, qp, right=True)
        if window is not None:  # keys at or below pq - W fall out of the band
            seen = seen - torch.searchsorted(srt, qp - window, right=True)
        pairs += int(seen.sum())
    b, H, s, d = q.shape
    flops = 4 * d * H * pairs
    elt = q.element_size()
    if square:
        rows = int(cnt.clamp(max=s).sum())
        nbytes = elt * d * (rows * (H + 2 * k.shape[1]) + b * H * s) + 4 * 2 * rows
    else:
        nbytes = (elt * (2 * q.numel() + k.numel() + v.numel())
                  + 4 * (pos.numel() + kpos.numel()))
    if aux:
        nbytes += 2 * 4 * b * H * s
    return flops, nbytes


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
