"""Decode: single-token step over the compressed cache + greedy generation loop.

Port of the uniform-slot path of ``fastkv_tpu.engine.decode``. Decode token t
has position n_true + t (positions continue from the original prompt length)
and goes into the static cache slot prefill_capacity + t, written in place.
Attention runs through ``ops.decode_attn.decode_attention``: the CUDA kernel
on the card, its plain version on the CPU. Under a sliding window it sees the
last ``sliding_window`` cache entries by rank (``window_mask``). The
per-example slot path (the continuous-batching Scheduler's) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from fastkv_tpu_torch.cache.kv_cache import KVCache
from fastkv_tpu_torch.core.config import MethodConfig, ModelConfig
from fastkv_tpu_torch.engine.prefill import PrefillShapes
from fastkv_tpu_torch.models import llama
from fastkv_tpu_torch.models.rope import compute_inv_freq
from fastkv_tpu_torch.ops import decode_attn


def window_mask(valid: torch.Tensor, sliding_window: Optional[int]) -> torch.Tensor:
    """The cache slots a decode step attends, [..., C] bool.

    Without a window, every valid slot. Under a window, the last
    ``sliding_window`` valid entries in cache order, not by original position,
    as the JAX package's decode_step (after the reference's Mistral cache
    slicing): a compressed cache shorter than the window keeps far-past kept
    tokens visible. Kept slots form an ordered prefix and decode slots append
    after it, so an entry's rank is a cumulative sum over ``valid``."""
    if sliding_window is None:
        return valid
    rank = torch.cumsum(valid.to(torch.int32), dim=-1, dtype=torch.int32)
    return valid & (rank > rank[..., -1:] - sliding_window)


def decode_step(
    params: Dict[str, Any],
    cfg: ModelConfig,
    mcfg: MethodConfig,
    cache: KVCache,
    token: torch.Tensor,  # [b] int32
    pos: torch.Tensor,  # [b] int32: original position of this token
    slot: int,  # cache slot, the same for every example
    inv_freq: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step. Returns (logits [b, V] float32, the cache updated in place)."""
    if inv_freq is None:
        inv_freq = torch.from_numpy(compute_inv_freq(cfg)).to(token.device)
    h = llama.embed(params, cfg, token[:, None])  # [b, 1, D]
    # in place at the static slot, and a step never copies the cache; the new
    # slot's position and validity are the same in every layer, so they are
    # written for all layers at once, and the mask taken after
    cache.pos[:, :, :, slot] = pos[None, :, None]
    cache.valid[:, :, :, slot] = True
    attend = window_mask(cache.valid, cfg.sliding_window)  # [L, b, CH, C]
    for l in range(cfg.num_layers):
        lp = llama.layer_params(params, l)
        hn = llama.rms_norm(h, lp["ln_attn"], cfg.rms_norm_eps)
        q, k_new, v_new = llama.qkv_proj(lp, cfg, hn)  # q [b, H, 1, d]
        q, k_new = llama.rope_qk(q, k_new, pos[:, None], inv_freq)
        cache.k[l, :, :, slot] = k_new[:, :, 0]
        cache.v[l, :, :, slot] = v_new[:, :, 0]
        attn = decode_attn.decode_attention(q, cache.k[l], cache.v[l], attend[l])
        h = h + llama.attn_out_proj(lp, attn)
        h = h + llama.mlp(lp, llama.rms_norm(h, lp["ln_mlp"], cfg.rms_norm_eps))
    logits = llama.unembed(params, cfg, h)[:, 0, :]
    return logits, cache


class GenResult(NamedTuple):
    tokens: torch.Tensor  # [b, max_new] int32 (0 after EOS)
    num_generated: torch.Tensor  # [b] int32


def greedy_generate(
    params: Dict[str, Any],
    cfg: ModelConfig,
    mcfg: MethodConfig,
    shapes: PrefillShapes,
    first_logits: torch.Tensor,  # [b, V] from prefill
    cache: KVCache,
    n_true: torch.Tensor,  # [b] int32 original prompt lengths
    max_new_tokens: int,
    eos_ids: Optional[Sequence[int]] = None,
    min_new_tokens: int = 1,
) -> Tuple[GenResult, KVCache]:
    """Greedy decoding: at least ``min_new_tokens`` before EOS may win; tokens
    after EOS are 0 and excluded from num_generated. The loop runs all
    max_new_tokens - 1 steps without reading anything back to the host."""
    b, vocab = first_logits.shape
    dev = first_logits.device
    inv_freq = torch.from_numpy(compute_inv_freq(cfg)).to(dev)
    eos_mask = None
    if eos_ids is not None:
        eos_mask = torch.zeros(vocab, dtype=torch.bool, device=dev)
        eos_mask[torch.as_tensor(list(eos_ids), dtype=torch.long, device=dev)] = True

    def sample(logits, step):
        """Greedy pick; EOS suppressed while step < min_new_tokens."""
        if eos_mask is not None and step < min_new_tokens:
            logits = logits.masked_fill(eos_mask[None], float("-inf"))
        return torch.argmax(logits, dim=-1).to(torch.int32)

    def is_eos(tok):
        if eos_mask is None:
            return torch.zeros_like(tok, dtype=torch.bool)
        return eos_mask[tok.long()]

    tok = sample(first_logits, 0)
    done = is_eos(tok)
    toks, alive = [tok], [torch.ones_like(done)]
    for step in range(max_new_tokens - 1):
        logits, cache = decode_step(
            params, cfg, mcfg, cache, tok, n_true + step,
            shapes.prefill_capacity + step, inv_freq)
        tok = torch.where(done, 0, sample(logits, step + 1)).to(torch.int32)
        alive.append(~done)
        done = done | is_eos(tok)
        toks.append(tok)
    alive_t = torch.stack(alive, dim=1)
    tokens = torch.where(alive_t, torch.stack(toks, dim=1), 0)
    return GenResult(tokens=tokens, num_generated=alive_t.sum(dim=1).to(torch.int32)), cache
