"""DeepSeek-V3 at one device's share of an expert-parallel deployment:
multi-head latent attention (MLA) with a query LoRA and one latent cache
head, ``first_k_dense_replace`` dense layers, then expert layers whose
router spans ``n_routed_experts`` x ``ep_size`` experts (``noaux_tc``: a
float32 correction bias per router expert), of which this device holds
``n_routed_experts`` (the ``ep_rank``-th block, 0 unless given), plus
``n_shared_experts`` every token takes. The architecture module of
``perfbench.arch``'s contract; the latent attention's counts are
``arch.deepseek_v2``'s.

How it counts:
  * attention projections per token and layer: ``q_a`` D x Q, ``q_b``
    Q x H (n + r), ``kv_a`` D x (R + r), ``kv_b`` R x H (n + v), ``wo``
    H v x D;
  * prefill attention and absorbed decode attention as DeepSeek-V2's
    (``arch.deepseek_v2``: ``pair_flops``, ``slot_flops``, ``flash_calls``,
    ``decode_attn_bytes``);
  * a token's expert layer in prefill: the router (D x E_router), the
    shared experts, and its k routed experts at their expected share on
    this device, k x n_routed_experts / E_router (a prompt's rows spread
    over the router's experts: random weights route near uniformly);
  * a decode step reads the least: no routed expert, since at batch 1 no
    token need land on an expert held here (8 of 256 at the published
    share: ~0.25 pairs a token and layer); the router, the shared experts,
    the attention, the dense layers and the LM head in full. So no share of
    a decode step can read above 100%.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Tuple

import torch

from perfbench.arch import deepseek_v2 as v2
from perfbench.work import BF16, flash_pairs, segment_lengths

cache_rows = v2.cache_rows
pair_flops = v2.pair_flops
slot_flops = v2.slot_flops
flash_calls = v2.flash_calls
decode_attn_bytes = v2.decode_attn_bytes
expert_params = v2.expert_params


def router_experts(m: dict) -> int:
    """The router's width: the experts of every device that shares a layer."""
    return m["n_routed_experts"] * (m.get("ep_size") or 1)


def make_weights(m: dict, seed: int, device: str, dtype: torch.dtype) -> Dict[str, Any]:
    """The model's weights from the seed, on the device, in the served dtype:
    one normal(0, initializer_range) draw per stacked tensor (0.02 where the
    configuration gives none), norms at 1, laid out as the program takes
    them: ``layers`` stacked over every layer (``q_a``, ``q_a_norm``,
    ``q_b``, the latent projections, norms), ``dense`` over the dense
    layers, ``moe`` over the expert layers (router [D, E_router], the held
    experts [E, in, out], the shared experts), stored [in, out]; the
    router's correction bias ``e_bias`` [E_router] float32, normal(0,
    ``e_score_correction_bias_std``), initializer_range where not given
    (the configuration's ``assumed`` says why)."""
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    std = m.get("initializer_range", 0.02)
    L, D, H, n, r, R, v = v2._sizes(m)
    Q, V = m["q_lora_rank"], m["vocab_size"]
    Ld = v2._dense_layers(m)
    Le = L - Ld

    def draw(*shape, dt=dtype, sd=std):
        return torch.empty(shape, dtype=dt, device=device).normal_(0.0, sd, generator=gen)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    w = {"embed": draw(V, D), "final_norm": ones(D),
         "layers": {"ln_attn": ones(L, D), "ln_mlp": ones(L, D), "q_a": draw(L, D, Q),
                    "q_a_norm": ones(L, Q), "q_b": draw(L, Q, H * (n + r)),
                    "w_kv_a": draw(L, D, R + r), "kv_norm": ones(L, R),
                    "w_kv_b": draw(L, R, H * (n + v)), "wo": draw(L, H * v, D)}}
    if Ld:
        F = m["intermediate_size"]
        w["dense"] = {"w_gate": draw(Ld, D, F), "w_up": draw(Ld, D, F), "w_down": draw(Ld, F, D)}
    if Le:
        E, Fe, Er = m["n_routed_experts"], m["moe_intermediate_size"], router_experts(m)
        w["moe"] = {"router": draw(Le, D, Er),
                    "e_bias": draw(Le, Er, dt=torch.float32,
                                   sd=m.get("e_score_correction_bias_std", std)),
                    "w_gate": draw(Le, E, D, Fe), "w_up": draw(Le, E, D, Fe),
                    "w_down": draw(Le, E, Fe, D)}
        Fs = (m.get("n_shared_experts") or 0) * Fe
        if Fs:
            w["moe"].update(ws_gate=draw(Le, D, Fs), ws_up=draw(Le, D, Fs),
                            ws_down=draw(Le, Fs, D))
    if not m.get("tie_word_embeddings", False):
        w["lm_head"] = draw(D, V)
    return w


def attn_params(m: dict) -> int:
    """Attention weights of one layer."""
    _, D, H, n, r, R, v = v2._sizes(m)
    Q = m["q_lora_rank"]
    return D * Q + Q * H * (n + r) + D * (R + r) + R * H * (n + v) + H * v * D


def mlp_params(m: dict, layer: int, routed: float) -> float:
    """Weights a token's MLP reads in ``layer``: the dense SwiGLU, or the
    router, the shared experts and ``routed`` routed experts."""
    D = m["hidden_size"]
    if layer < v2._dense_layers(m):
        return 3 * D * m["intermediate_size"]
    shared = 3 * D * (m.get("n_shared_experts") or 0) * m["moe_intermediate_size"]
    return D * router_experts(m) + shared + routed * expert_params(m)


def routed_here(m: dict) -> float:
    """A token's expected routed experts on this device: k x E / E_router."""
    return m["num_experts_per_tok"] * m["n_routed_experts"] / router_experts(m)


def prefill_flops(cfg: dict, method: dict, n: int) -> int:
    """FLOPs a prefill of n tokens needs: 2 per weight a token reads (the
    attention's, the dense MLP's or the router's, the shared experts' and
    its routed experts' expected share here) in every layer at its
    segment's length, every attention pair, the LM head once."""
    total = 0
    for l, s in enumerate(segment_lengths(cfg, method, n)):
        total += 2 * (attn_params(cfg) + mlp_params(cfg, l, routed_here(cfg))) * s
        total += pair_flops(cfg) * cfg["num_attention_heads"] * flash_pairs(s)
    return int(total) + 2 * cfg["hidden_size"] * cfg["vocab_size"]


def decode_step_work(cfg: dict, live_per_layer: Iterable[int], batch: int = 1) -> Tuple[int, int]:
    """(FLOP, bytes) of one decode step: every layer's attention weights,
    its dense MLP or its router and shared experts, the LM head, read once
    (no routed expert: see the module docstring); the embedding row of each
    token; each layer's live latent rows (``live_per_layer``: visible slots
    summed over the batch). 2 FLOPs per weight and token; ``slot_flops`` a
    live slot and head."""
    L, D, V = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["vocab_size"]
    H = cfg["num_attention_heads"]
    row = cfg["kv_lora_rank"] + cfg["qk_rope_head_dim"]
    weights = int(sum(attn_params(cfg) + mlp_params(cfg, l, 0) for l in range(L))) + D * V
    live_sum = int(sum(live_per_layer))
    flops = 2 * weights * batch + slot_flops(cfg) * H * live_sum
    nbytes = BF16 * (weights + batch * D) + BF16 * row * live_sum
    return flops, nbytes
