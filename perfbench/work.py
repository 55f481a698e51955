"""The benchmark's yardstick: the card's peak rates and the work a call or a
step needs, computed from shapes alone.

Everything here is frozen inside the benchmark, so a change to the program
cannot move its own yardstick. The peaks are NVIDIA's data-sheet numbers
for one H100 SXM (dense, no sparsity). The work is what the algorithm needs
for the true prompt, not what the program happens to compute: padding rows
of a bucket add nothing, and a sliding window caps the pairs a query sees.

  * ``flash_pairs``: the (query, key) pairs of causal attention over ``s``
    tokens in layout order, under a window of ``window`` entries if given.
  * ``prefill_flops``: every projection, MLP and attention pair of a FastKV
    (or FullKV) prefill of ``n`` tokens, plus the LM head over the last one.
  * ``decode_step_work``: FLOPs and bytes of one decode step at batch b.
  * ``decode_attn_bytes``: bytes one decode-attention call reads and writes.
  * ``share``: the least time a piece of work needs over the time it took.

A copy of the program's arithmetic (``kernels/timing.py``: the peaks and
``flash_work``'s pair count), kept here so the program can drop its own.
"""

from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np

PEAK_BF16_FLOPS = 989e12  # dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # HBM3 rate
BF16 = 2  # bytes an element of the served dtype


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


def flash_flops(s: int, heads: int, head_dim: int, window: Optional[int] = None) -> int:
    """QK^T and PV: 4 * d per visible pair and query head."""
    return 4 * head_dim * heads * flash_pairs(s, window)


def layer_params(cfg: dict) -> int:
    """Weights of one decoder layer (projections and MLP, not the norms)."""
    D, F = cfg["hidden_size"], cfg["intermediate_size"]
    H, KH, d = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    return D * H * d + 2 * D * KH * d + H * d * D + 3 * D * F


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


def flash_calls(cfg: dict, method: dict, n: int) -> Sequence[Tuple[int, int]]:
    """(FLOP, bytes) of each layer's prefill attention call for a prompt of n
    tokens: q, k, v read and the output written once over the true rows."""
    H, KH, d = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    W = cfg.get("sliding_window")
    out = []
    for s in segment_lengths(cfg, method, n):
        out.append((flash_flops(s, H, d, W), BF16 * d * s * (2 * H + 2 * KH)))
    return out


def prefill_flops(cfg: dict, method: dict, n: int) -> int:
    """FLOPs a prefill of n tokens needs: 2 per weight and token in every
    layer at its segment's length, every attention pair, the LM head once."""
    P = layer_params(cfg)
    H, d = cfg["num_attention_heads"], cfg["head_dim"]
    W = cfg.get("sliding_window")
    total = 0
    for s in segment_lengths(cfg, method, n):
        total += 2 * P * s + flash_flops(s, H, d, W)
    return total + 2 * cfg["hidden_size"] * cfg["vocab_size"]


def decode_attn_bytes(cfg: dict, live: Iterable[int], batch: int = 1) -> int:
    """Bytes one decode-attention call moves: q, the live K/V rows of each
    cache head read once (``live``: the visible slots of each cache head of
    each example), the output written."""
    H, d = cfg["num_attention_heads"], cfg["head_dim"]
    return BF16 * d * (2 * H * batch + 2 * int(sum(live)))


def decode_step_work(cfg: dict, live_per_layer: Iterable[int], batch: int = 1) -> Tuple[int, int]:
    """(FLOP, bytes) of one decode step: every layer's weights read once, the
    LM head, the embedding row of each token, and each layer's live cache
    (``live_per_layer``: visible slots summed over the cache heads and the
    batch); 2 FLOPs per weight and token, 4 * d per visible slot and query
    head (each cache head serves H / CH query heads)."""
    L, D, V = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["vocab_size"]
    H, KH, d = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    P = layer_params(cfg)
    live_sum = int(sum(live_per_layer))
    weights = L * P + D * V
    flops = 2 * weights * batch + 4 * d * (H // KH) * live_sum
    nbytes = BF16 * (weights + batch * D) + BF16 * 2 * d * live_sum
    return flops, nbytes


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card needs: the larger of the two bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def share(least_s: float, seconds: float) -> Optional[float]:
    """Per cent of the bound reached; None for no time measured."""
    if seconds <= 0:
        return None
    return 100.0 * least_s / seconds
