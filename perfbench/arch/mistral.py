"""The Mistral family (and Llama's shape): dense GQA decoder layers, all
alike, each with a SwiGLU MLP; a cache head per kv head holds one K row and
one V row a token. The architecture module of ``perfbench.arch``'s contract,
with ``layer_params`` and ``flash_flops`` as its own helpers."""

from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import torch

from perfbench.work import BF16, flash_pairs, segment_lengths


def make_weights(m: dict, seed: int, device: str, dtype: torch.dtype) -> Dict[str, Any]:
    """The model's weights from the seed, on the device, in the served dtype:
    one normal(0, initializer_range) draw per stacked tensor (the published
    range, 0.02 where the configuration gives none), norms at 1, laid out as
    the program takes them (per-layer weights stacked on a leading axis,
    stored [in, out])."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    std = m.get("initializer_range", 0.02)
    L, D, F = m["num_hidden_layers"], m["hidden_size"], m["intermediate_size"]
    H, KH, d, V = (m["num_attention_heads"], m["num_key_value_heads"], m["head_dim"],
                   m["vocab_size"])

    def draw(*shape):
        return torch.empty(shape, dtype=dtype, device=device).normal_(0.0, std, generator=gen)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    w = {"embed": draw(V, D), "final_norm": ones(D),
         "layers": {"wq": draw(L, D, H * d), "wk": draw(L, D, KH * d), "wv": draw(L, D, KH * d),
                    "wo": draw(L, H * d, D), "w_gate": draw(L, D, F), "w_up": draw(L, D, F),
                    "w_down": draw(L, F, D), "ln_attn": ones(L, D), "ln_mlp": ones(L, D)}}
    if not m.get("tie_word_embeddings", False):
        w["lm_head"] = draw(D, V)
    return w


def cache_rows(m: dict) -> int:
    """Cache heads a layer has: one K and one V row each a token."""
    return m["num_key_value_heads"]


def flash_flops(s: int, heads: int, head_dim: int, window: Optional[int] = None) -> int:
    """QK^T and PV: 4 * d per visible pair and query head."""
    return 4 * head_dim * heads * flash_pairs(s, window)


def layer_params(cfg: dict) -> int:
    """Weights of one decoder layer (projections and MLP, not the norms)."""
    D, F = cfg["hidden_size"], cfg["intermediate_size"]
    H, KH, d = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    return D * H * d + 2 * D * KH * d + H * d * D + 3 * D * F


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
