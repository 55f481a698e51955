"""The benchmark's yardstick: the card's peak rates and the work a call or a
step needs, computed from shapes alone.

Everything here is frozen inside the benchmark, so a change to the program
cannot move its own yardstick. The peaks are NVIDIA's data-sheet numbers
for one H100 SXM (dense, no sparsity). The work is what the algorithm needs
for the true prompt, not what the program happens to compute: padding rows
of a bucket add nothing, and a sliding window caps the pairs a query sees.

What no architecture shapes is here: the budgets and segment lengths of the
method, ``flash_pairs`` (the (query, key) pairs of causal attention over
``s`` tokens in layout order, under a window of ``window`` entries if
given), ``kept_per_layer``, and ``share`` (the least time a piece of work
needs over the time it took). What the model's shape decides is counted by
the configuration's architecture module (``perfbench.arch``), named by
``arch`` (the configuration's ``reference``; the Mistral family where none
is given), through the functions below:

  * ``cache_rows``: the rows one token adds to a layer's cache;
  * ``prefill_flops``: every projection, MLP and attention pair of a FastKV
    (or FullKV) prefill of ``n`` tokens, plus the LM head over the last one;
  * ``flash_calls``: (FLOP, bytes) of each layer's prefill attention call;
  * ``decode_step_work``: FLOPs and bytes of one decode step at batch b;
  * ``decode_attn_bytes``: bytes one decode-attention call reads and writes.

A copy of the program's arithmetic (``kernels/timing.py``: the peaks and
``flash_work``'s pair count), kept here so the program can drop its own.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

from perfbench import arch as archs

PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # HBM3 rate
BF16 = 2  # bytes an element of the served dtype
DEFAULT_ARCH = "mistral"  # the architecture of a caller that names none


def floor_rate(n: int, rate: float) -> int:
    """floor(n * rate) as the method computes it: a float32 product."""
    return int(math.floor(np.float32(n) * np.float32(rate)))


def keep_budget(n: int, retain_rate: float, window: int) -> int:
    """Non-window tokens a layer keeps of a segment of ``n`` tokens."""
    return max(min(floor_rate(n, retain_rate), n) - window, 0)


def tsp_count(n: int, tsp_rate: float, window: int) -> int:
    """Tokens the TSP layer hands on: its budget plus the window (whole
    prompt when it is shorter than the budget)."""
    t = min(floor_rate(n, tsp_rate), n)
    return max(t - window, 0) + min(window, n)


def flash_pairs(s: int, window: Optional[int] = None) -> int:
    """Visible (query, key) pairs of causal attention over s tokens, each
    query seeing at most ``window`` keys (itself included)."""
    if window is None or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def segment_lengths(cfg: dict, method: dict, n: int) -> Sequence[int]:
    """The sequence length each layer runs at: FastKV runs layers
    [0, tsp_idx] at n and the rest at the TSP count; FullKV every layer at n."""
    L = cfg["num_hidden_layers"]
    if method["method"] != "fastkv":
        return [n] * L
    t = method["tsp_idx"]
    c = tsp_count(n, method["tsp_rate"], method["window_size"])
    return [n] * (t + 1) + [c] * (L - t - 1)


def kept_per_layer(cfg: dict, method: dict, n: int) -> Sequence[int]:
    """Cache slots each cache head of each layer holds after a prefill of n
    tokens: its budget of selected tokens plus the window (FullKV: all n)."""
    if method["method"] != "fastkv":
        return [n] * cfg["num_hidden_layers"]
    W, T = method["window_size"], method["tsp_idx"]
    out = []
    for l, s in enumerate(segment_lengths(cfg, method, n)):
        rate = method["retain_rate"] / method["tsp_rate"] if l > T else method["retain_rate"]
        out.append(keep_budget(s, rate, W) + min(W, s))
    return out


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card needs: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def share(least_s: float, seconds: float) -> Optional[float]:
    """Per cent of the bound reached; None for no time measured."""
    if seconds <= 0:
        return None
    return 100.0 * least_s / seconds


def cache_rows(cfg: dict, arch: str = DEFAULT_ARCH) -> int:
    """Rows one token adds to a layer's cache: one for each cache head."""
    return archs.load(arch).cache_rows(cfg)


def layer_params(cfg: dict) -> int:
    """Weights of one Mistral-family decoder layer (``arch.mistral``)."""
    return archs.load(DEFAULT_ARCH).layer_params(cfg)


def flash_calls(cfg: dict, method: dict, n: int,
                arch: str = DEFAULT_ARCH) -> Sequence[Tuple[int, int]]:
    """(FLOP, bytes) of each layer's prefill attention call for a prompt of n
    tokens, as the architecture counts them."""
    return archs.load(arch).flash_calls(cfg, method, n)


def prefill_flops(cfg: dict, method: dict, n: int, arch: str = DEFAULT_ARCH) -> int:
    """FLOPs a prefill of n tokens needs, as the architecture counts them."""
    return archs.load(arch).prefill_flops(cfg, method, n)


def decode_attn_bytes(cfg: dict, live: Iterable[int], batch: int = 1,
                      arch: str = DEFAULT_ARCH) -> int:
    """Bytes one decode-attention call moves (``live``: the visible slots of
    each cache head of each example)."""
    return archs.load(arch).decode_attn_bytes(cfg, live, batch)


def decode_step_work(cfg: dict, live_per_layer: Iterable[int], batch: int = 1,
                     arch: str = DEFAULT_ARCH) -> Tuple[int, int]:
    """(FLOP, bytes) of one decode step (``live_per_layer``: each layer's
    visible slots summed over its cache heads and the batch)."""
    return archs.load(arch).decode_step_work(cfg, live_per_layer, batch)
