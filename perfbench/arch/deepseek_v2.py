"""DeepSeek-V2: multi-head latent attention (MLA) with one latent cache head,
a dense first layer (``first_k_dense_replace``), then expert layers of
``n_routed_experts`` SwiGLU experts of which a token takes
``num_experts_per_tok``, plus ``n_shared_experts`` every token takes. The
architecture module of ``perfbench.arch``'s contract.

How it counts:
  * attention projections per token and layer: ``wq`` D x H (n + r),
    ``kv_a`` D x (R + r), ``kv_b`` R x H (n + v), ``wo`` H v x D;
  * prefill attention: 2 (n + r) + 2 v FLOPs a visible (query, key) pair and
    head (QK^T at the q/k width, PV at the v width), the pairs of the true
    prompt at each layer's length;
  * decode attention, absorbed: 2 (R + r) + 2 R FLOPs a live latent slot and
    head (the query against the latent and the rope key, the weighted
    latent), R + r bf16 values read a live slot; the absorption's own
    products are ``kv_b``'s, counted with the weights;
  * experts: a token's MLP in an expert layer is the router (D x E), the
    shared experts and its k routed experts. A decode step reads the
    weights of k routed experts a layer: exact at batch 1; at batch b the
    rows may pick up to b k distinct experts, and the count stays at k,
    the least possible, so that no share can read above 100%.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Sequence, Tuple

import torch

from perfbench.work import BF16, flash_pairs, segment_lengths


def _sizes(m: dict):
    return (m["num_hidden_layers"], m["hidden_size"], m["num_attention_heads"],
            m["qk_nope_head_dim"], m["qk_rope_head_dim"], m["kv_lora_rank"], m["v_head_dim"])


def _dense_layers(m: dict) -> int:
    return min(m.get("first_k_dense_replace", 0), m["num_hidden_layers"])


def make_weights(m: dict, seed: int, device: str, dtype: torch.dtype) -> Dict[str, Any]:
    """The model's weights from the seed, on the device, in the served dtype:
    one normal(0, initializer_range) draw per stacked tensor (0.02 where the
    configuration gives none), norms at 1, laid out as the program takes
    them: ``layers`` stacked over every layer (attention and norms),
    ``dense`` over the dense layers, ``moe`` over the expert layers (router
    [D, E], routed experts [E, in, out], shared experts), stored [in, out]."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    std = m.get("initializer_range", 0.02)
    L, D, H, n, r, R, v = _sizes(m)
    V = m["vocab_size"]
    Ld = _dense_layers(m)
    Le = L - Ld

    def draw(*shape):
        return torch.empty(shape, dtype=dtype, device=device).normal_(0.0, std, generator=gen)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    w = {"embed": draw(V, D), "final_norm": ones(D),
         "layers": {"ln_attn": ones(L, D), "ln_mlp": ones(L, D), "wq": draw(L, D, H * (n + r)),
                    "w_kv_a": draw(L, D, R + r), "kv_norm": ones(L, R),
                    "w_kv_b": draw(L, R, H * (n + v)), "wo": draw(L, H * v, D)}}
    if Ld:
        F = m["intermediate_size"]
        w["dense"] = {"w_gate": draw(Ld, D, F), "w_up": draw(Ld, D, F), "w_down": draw(Ld, F, D)}
    if Le:
        E, Fe = m["n_routed_experts"], m["moe_intermediate_size"]
        w["moe"] = {"router": draw(Le, D, E), "w_gate": draw(Le, E, D, Fe),
                    "w_up": draw(Le, E, D, Fe), "w_down": draw(Le, E, Fe, D)}
        Fs = (m.get("n_shared_experts") or 0) * Fe
        if Fs:
            w["moe"].update(ws_gate=draw(Le, D, Fs), ws_up=draw(Le, D, Fs),
                            ws_down=draw(Le, Fs, D))
    if not m.get("tie_word_embeddings", False):
        w["lm_head"] = draw(D, V)
    return w


def cache_rows(m: dict) -> int:
    """One latent cache head a layer: one row (latent and rope key) a token."""
    return 1


def attn_params(m: dict) -> int:
    """Attention weights of one layer."""
    _, D, H, n, r, R, v = _sizes(m)
    return D * H * (n + r) + D * (R + r) + R * H * (n + v) + H * v * D


def expert_params(m: dict) -> int:
    """Weights of one routed expert."""
    return 3 * m["hidden_size"] * m["moe_intermediate_size"]


def mlp_params(m: dict, layer: int) -> int:
    """Weights a token's MLP reads in ``layer``: the dense SwiGLU, or the
    router, the shared experts and ``num_experts_per_tok`` routed experts."""
    D = m["hidden_size"]
    if layer < _dense_layers(m):
        return 3 * D * m["intermediate_size"]
    shared = 3 * D * (m.get("n_shared_experts") or 0) * m["moe_intermediate_size"]
    return D * m["n_routed_experts"] + shared + m["num_experts_per_tok"] * expert_params(m)


def pair_flops(m: dict) -> int:
    """Prefill attention FLOPs a visible pair and head: QK^T and PV."""
    return 2 * (m["qk_nope_head_dim"] + m["qk_rope_head_dim"]) + 2 * m["v_head_dim"]


def slot_flops(m: dict) -> int:
    """Absorbed decode attention FLOPs a live latent slot and head."""
    R, r = m["kv_lora_rank"], m["qk_rope_head_dim"]
    return 2 * (R + r) + 2 * R


def flash_calls(cfg: dict, method: dict, n: int) -> Sequence[Tuple[int, int]]:
    """(FLOP, bytes) of each layer's prefill attention call for a prompt of n
    tokens: q and k (n + r wide), v and the output (v wide), each of the H
    heads, read or written once over the true rows."""
    H, qk, v = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
                cfg["v_head_dim"])
    return [(pair_flops(cfg) * H * flash_pairs(s), BF16 * s * H * (2 * qk + 2 * v))
            for s in segment_lengths(cfg, method, n)]


def prefill_flops(cfg: dict, method: dict, n: int) -> int:
    """FLOPs a prefill of n tokens needs: 2 per weight a token reads (the
    attention's, the dense MLP's or the router's, shared and k routed
    experts') in every layer at its segment's length, every attention pair,
    the LM head once."""
    total = 0
    for l, s in enumerate(segment_lengths(cfg, method, n)):
        total += 2 * (attn_params(cfg) + mlp_params(cfg, l)) * s
        total += pair_flops(cfg) * cfg["num_attention_heads"] * flash_pairs(s)
    return total + 2 * cfg["hidden_size"] * cfg["vocab_size"]


def decode_attn_bytes(cfg: dict, live: Iterable[int], batch: int = 1) -> int:
    """Bytes one decode-attention call moves: q and the output of each head,
    the live latent rows (R + r values) read once."""
    H, qk, v = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"],
                cfg["v_head_dim"])
    row = cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]
    return BF16 * (H * batch * (qk + v) + row * int(sum(live)))


def decode_step_work(cfg: dict, live_per_layer: Iterable[int], batch: int = 1) -> Tuple[int, int]:
    """(FLOP, bytes) of one decode step: every layer's attention weights,
    its dense MLP or its router, shared experts and k routed experts (k at
    any batch: see the module docstring), the LM head, read once; the
    embedding row of each token; each layer's live latent rows
    (``live_per_layer``: visible slots summed over the batch). 2 FLOPs per
    weight and token; ``slot_flops`` a live slot and head."""
    L, D, V = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["vocab_size"]
    H = cfg["num_attention_heads"]
    row = cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]
    weights = sum(attn_params(cfg) + mlp_params(cfg, l) for l in range(L)) + D * V
    live_sum = int(sum(live_per_layer))
    flops = 2 * weights * batch + slot_flops(cfg) * H * live_sum
    nbytes = BF16 * (weights + batch * D) + BF16 * row * live_sum
    return flops, nbytes
