"""Decode: single-token step over the compressed cache + greedy generation loop.

Port of ``fastkv_tpu.engine.decode``. Decode token t has position n_true + t
(positions continue from the original prompt length) and goes into the static
cache slot prefill_capacity + t, written in place; the continuous-batching
Scheduler passes one slot per example instead, as its slots sit at different
depths. Attention runs through ``ops.decode_attn.decode_attention``: the CUDA
kernel on the card, its plain version on the CPU. Under a sliding window it
sees the last ``sliding_window`` cache entries by rank (``window_mask``). An
int8 cache (``EngineConfig.kv_int8``) gets the new token's K/V quantized, with
their scales written at the same slot, and the kernel folds the layer's
scales in.

Over a mesh (``decode_step(mesh=)``) a rank runs its ``parallel.pipeline.
Part``: its cache holds its cache heads and its stage's layers, each step
runs the stages in turn (the [b, 1, D] hidden state handed on), and the last
stage's logits go to every stage, so ``greedy_generate`` picks the same
tokens on every rank.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from fastkv_tpu_torch.cache.kv_cache import KVCache
from fastkv_tpu_torch.core import quant
from fastkv_tpu_torch.core.config import MethodConfig, ModelConfig
from fastkv_tpu_torch.engine.prefill import PrefillShapes
from fastkv_tpu_torch.models import llama
from fastkv_tpu_torch.models.rope import compute_inv_freq
from fastkv_tpu_torch.ops import decode_attn
from fastkv_tpu_torch.parallel import pipeline
from fastkv_tpu_torch.utils import guards, profiling


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


def _write_slot(dst: torch.Tensor, src: torch.Tensor, slot) -> None:
    """dst [b, CH, C, ...] <- src [b, CH, ...] at cache slot ``slot``: an int
    for every example, or a [b] tensor of one slot per example. The per-example
    write indexes a [b, C, CH, ...] view with two adjacent index tensors, so the
    indexed axes stay where they are (indices split by a slice would move them
    to the front)."""
    if isinstance(slot, int):
        dst[:, :, slot] = src
    else:
        rows = torch.arange(dst.shape[0], device=dst.device)
        dst.transpose(1, 2)[rows, slot] = src


def decode_step(
    params: Dict[str, Any],
    cfg: ModelConfig,
    mcfg: MethodConfig,
    cache: KVCache,
    token: torch.Tensor,  # [b] int32
    pos: torch.Tensor,  # [b] int32: original position of this token
    slot: Union[int, torch.Tensor],  # cache slot: one int, or a [b] tensor per example
    inv_freq: Optional[torch.Tensor] = None,
    mesh=None,  # parallel.sharding.Mesh: the params and cache are this rank's shard
) -> Tuple[torch.Tensor, KVCache]:
    """One decode step. Returns (logits [b, V] float32, the cache updated in
    place). ``cfg`` is the whole model's."""
    with profiling.span("decode.step", b=token.shape[0]):
        if inv_freq is None:
            inv_freq = torch.from_numpy(compute_inv_freq(cfg)).to(token.device)
        if not isinstance(slot, int):
            slot = slot.to(device=token.device, dtype=torch.long)
        part = pipeline.part(cfg, mesh)
        lcfg, tp = part.cfg, part.tp
        b = token.shape[0]
        ch = cache.k.shape[2]
        g_rep = ch // lcfg.num_kv_heads  # 1, or the group for a per-query-head cache
        # in place at the slot, and a step never copies the cache; the new slot's
        # position and validity are the same in every layer, so they are written
        # for all of the stage's layers at once (through a [b, CH, C, L] view),
        # and the mask taken after
        _write_slot(cache.pos.permute(1, 2, 3, 0),
                    pos[:, None, None].expand(b, ch, part.num_layers), slot)
        _write_slot(cache.valid.permute(1, 2, 3, 0), True, slot)
        attend = window_mask(cache.valid, cfg.sliding_window)  # [L, b, CH, C]

        def layer(st, l):
            (h,) = st
            guards.at(f"decode layer {l}")
            i = l - part.lo
            lp = llama.layer_params(params, i)
            hn = llama.rms_norm(h, lp["ln_attn"], cfg.rms_norm_eps)
            q, k_new, v_new = llama.qkv_proj(lp, lcfg, hn)  # q [b, H, 1, d]
            guards.finite("q/k/v", q, k_new, v_new)
            q, k_new = llama.rope_qk(q, k_new, pos[:, None], inv_freq)
            if g_rep > 1:  # the reference repeats kv heads before caching (SnapKV)
                k_new = k_new.repeat_interleave(g_rep, dim=1)
                v_new = v_new.repeat_interleave(g_rep, dim=1)
            scales = {}
            if cache.k_scale is not None:
                k_new, k_sc = quant.quantize_kv(k_new)
                v_new, v_sc = quant.quantize_kv(v_new)
                _write_slot(cache.k_scale[i], k_sc[:, :, 0], slot)
                _write_slot(cache.v_scale[i], v_sc[:, :, 0], slot)
                scales = dict(k_scale=cache.k_scale[i], v_scale=cache.v_scale[i])
            _write_slot(cache.k[i], k_new[:, :, 0], slot)
            _write_slot(cache.v[i], v_new[:, :, 0], slot)
            attn = decode_attn.decode_attention(q, cache.k[i], cache.v[i], attend[i], **scales)
            h = h + llama.attn_out_proj(lp, attn, tp)
            h = h + llama.mlp_sum(lp, llama.rms_norm(h, lp["ln_mlp"], cfg.rms_norm_eps), tp=tp)
            guards.finite("hidden states", h)
            return (h,)

        h0 = (llama.embed(params, cfg, token[:, None]),) if part.stage == 0 else None  # [b, 1, D]
        with profiling.span("decode.layers"):
            out = pipeline.run_layers(part, 0, cfg.num_layers, h0, layer)
        logits = None
        if out is not None:
            with profiling.span("decode.head"):
                guards.at("the LM head")
                logits = llama.unembed(params, cfg, out[0], tp)[:, 0, :]
                guards.finite("logits", logits)
        [logits] = part.share(part.pipe - 1, None if logits is None else [logits], token.device)
        return logits, cache


class GenResult(NamedTuple):
    tokens: torch.Tensor  # [b, max_new] int32 (0 after EOS)
    num_generated: torch.Tensor  # [b] int32


# one decode step of the generation loop: (cache, token [b], step t, inv_freq)
# -> (logits [b, V], cache)
StepFn = Callable[[KVCache, torch.Tensor, int, torch.Tensor], Tuple[torch.Tensor, KVCache]]


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
    step_fn: Optional[StepFn] = None,
    mesh=None,  # parallel.sharding.Mesh of the default step (decode_step's)
) -> Tuple[GenResult, KVCache]:
    """Greedy decoding: at least ``min_new_tokens`` before EOS may win; tokens
    after EOS are 0 and excluded from num_generated. The loop runs all
    max_new_tokens - 1 steps without reading anything back to the host.

    ``step_fn(cache, token, t, inv_freq) -> (logits, cache)`` takes decode
    step t (from 0); by default ``decode_step`` at position n_true + t and
    slot prefill_capacity + t. PyramidInfer passes its own
    (``engine.pyramid.generation_step``)."""
    b, vocab = first_logits.shape
    dev = first_logits.device
    inv_freq = torch.from_numpy(compute_inv_freq(cfg)).to(dev)
    if step_fn is None:
        over = {} if mesh is None else {"mesh": mesh}

        def step_fn(cache, tok, t, inv_freq):
            return decode_step(params, cfg, mcfg, cache, tok, n_true + t,
                               shapes.prefill_capacity + t, inv_freq, **over)
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
    with profiling.span("decode.loop", steps=max_new_tokens - 1):
        for step in range(max_new_tokens - 1):
            logits, cache = step_fn(cache, tok, step, inv_freq)
            tok = torch.where(done, 0, sample(logits, step + 1)).to(torch.int32)
            alive.append(~done)
            done = done | is_eos(tok)
            toks.append(tok)
    alive_t = torch.stack(alive, dim=1)
    tokens = torch.where(alive_t, torch.stack(toks, dim=1), 0)
    return GenResult(tokens=tokens, num_generated=alive_t.sum(dim=1).to(torch.int32)), cache
