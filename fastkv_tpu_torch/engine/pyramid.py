"""PyramidInfer: per-layer pyramidal compression of the hidden states and the
KV cache, and its generation-stage re-compression.

Port of ``fastkv_tpu.engine.pyramid``, function by function:

  * a decay schedule over depth (cosine or linear) from
    ``pyramid_decay_ratio``; the per-layer sequence capacities are static,
    planned from the padded bucket (``plan_layer_lengths``); per-example
    budgets only drive validity;
  * scores: the causal softmax probabilities of the last (1 + recent) query
    rows, averaged over heads, weighted by distance (``linspace(1.0,
    distance_weight)`` over the rows) and averaged over rows; the first
    ``pyramid_sink_len`` context slots are pinned to 3e38;
  * each compressing layer keeps the top-k of its context (all of it below
    ``min_context_length``) plus the recent rows, and gathers the hidden
    states AND original positions, so the next layer sees a shorter sequence.
    The gathered layout is an ascending valid prefix, so the next layer's
    attention is the flash kernel's square form with a count (on the card the
    CUDA kernel, at each layer's own length);
  * each layer's cache holds its own (already shrunk) input K/V, written in
    place into one stacked cache of uniform capacity (bucket + decode room),
    validity-masked;
  * decode (``models.family.decode_layer``: the prologue kernel writes the
    row): attention that also returns the head-averaged probabilities
    (``_decode_attn_with_probs``, plain torch: the decode kernel returns no
    probabilities), a rolling score buffer of the last (1 + recent) rows per
    layer (``PyramidDecodeState``), and whenever a layer's uncompressed part
    grows past ``exceed_length_to_compress``, eviction of all but the top-k
    of the entries that slid out of the recent window, by validity masking
    (no rewrite of the cache).

The decode state is large (``probs`` is [L, b, rr, C] float32: 1.75 GB per
example at Llama-3.1-8B width and bucket 8192), so every step writes its rows
and layers in place; nothing of it is copied. ``_rows_probs`` takes its
products in float32 from the operands (no TF32), over one kv head's query
group at a time, its logits scaled, masked and softmaxed in place.

Where this differs from the JAX package, by design and with equal results up
to float32 summation order: a layer's probabilities are computed once, over
the seed rows of the decode state (the last rr valid rows), and the recent
scores take their rows from them (the recent rows are the last
``recent_dyn + 1`` of those, wherever float32 rounding keeps ``recent_dyn``
within ``recent_cap``); the JAX package runs ``_rows_probs`` twice in a
compressing layer. Under a sliding window the prefill attention applies the
window (``prefill._attend``) and neither the scores nor
``_decode_attn_with_probs`` do, as in the JAX package.

Over a mesh (``mesh=``) a rank runs its ``parallel.pipeline.Part``: the
prefill's and each decode step's layers on their stages (the shrinking
``SeqState``, or the decode step's hidden state, handed on), its heads; the
fold of ``_rows_probs`` over kv heads and the decode-time mean over heads
gather every head's terms over the model group and fold them as one device
does; the cache and the score state hold the rank's kv heads and the
stage's layers; the last stage's logits go to every stage.

Conscious divergences of the JAX package from the reference, kept here:
``recent_length`` is frozen at its prefill value (the reference recomputes
``int((n + step) * recent_ratio)`` every decode step), and the decay-strategy
dispatch is an if/elif chain (the reference's if/if/else lets "linear" fall
through to the constant ratio).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from fastkv_tpu_torch.cache.kv_cache import KVCache, empty_cache, write_slot
from fastkv_tpu_torch.core.config import EngineConfig, MethodConfig, ModelConfig, round_up
from fastkv_tpu_torch.engine.decode import StepFn
from fastkv_tpu_torch.engine.prefill import (
    PrefillShapes,
    SeqState,
    _attend,
    last_token_logits,
)
from fastkv_tpu_torch.models import family, llama
from fastkv_tpu_torch.models.rope import inv_freq_on
from fastkv_tpu_torch.ops import attention as att
from fastkv_tpu_torch.parallel import comm, pipeline
from fastkv_tpu_torch.policies import selection
from fastkv_tpu_torch.utils import guards

# the stamp of an empty score-buffer row
EMPTY_STAMP = -(2**30)
# the score pinned on the first sink_len context slots after the weighted
# sum: finite in float32, above any probability
SINK_SCORE = 3.0e38


def _decay(base: float, strategy: str, layer: int, num_layers: int) -> float:
    if strategy == "linear":
        return (1.0 - base) * (layer / num_layers) + base
    if strategy == "cosine":
        return (1.0 - base) * (math.cos(math.pi * layer / num_layers) + 1) / 2 + base
    return base


def decay_ratio(mcfg: MethodConfig, layer: int, num_layers: int) -> float:
    """The prefill keep ratio of ``layer``'s context."""
    return _decay(mcfg.pyramid_decay_ratio, mcfg.pyramid_decay_strategy, layer, num_layers)


def gen_decay_ratio(mcfg: MethodConfig, layer: int, num_layers: int) -> float:
    """The generation-stage keep ratio of ``layer``'s candidate band."""
    return _decay(mcfg.pyramid_gen_decay_ratio, mcfg.pyramid_gen_decay_strategy, layer,
                  num_layers)


def plan_layer_lengths(
    cfg: ModelConfig, mcfg: MethodConfig, bucket: int, align: int = 128
) -> List[int]:
    """Static per-layer sequence capacities [num_layers + 1] (the input of layer l)."""
    recent_cap = int(bucket * mcfg.pyramid_recent_ratio)
    # the reference adjusts min_context_length to the prompt
    min_ctx = min(mcfg.pyramid_min_context_length, bucket - 1 - recent_cap)
    lengths = [bucket]
    s = bucket
    for l in range(cfg.num_layers):
        r = decay_ratio(mcfg, l, cfg.num_layers)
        ctx = s - (1 + recent_cap)
        compresses = (l % mcfg.pyramid_downsample_interval) == 0
        if compresses and ctx > min_ctx and r < 1.0:
            topk = int(ctx * r)
            if topk <= min_ctx:
                topk = ctx
            s = min(round_up(topk + 1 + recent_cap, align), s)
        lengths.append(s)
    return lengths


def decode_buffer_rows(mcfg: MethodConfig, bucket: int) -> int:
    """Score-buffer row count for one (method, bucket) pair."""
    return int(bucket * mcfg.pyramid_recent_ratio) + 1


def recent_length(n: torch.Tensor, mcfg: MethodConfig) -> torch.Tensor:
    """``floor(float32(n) * recent_ratio)`` [b] int32: the frozen recent length
    of ``Engine.generate`` and the prefill (the Scheduler rounds in double
    precision, ``int(n * ratio)``, as the JAX Scheduler does)."""
    ratio = torch.tensor(mcfg.pyramid_recent_ratio, dtype=torch.float32, device=n.device)
    return torch.floor(n.to(torch.float32) * ratio).to(torch.int32)


def _rows_probs(
    q: torch.Tensor,  # [b, H, s, d]
    k: torch.Tensor,  # [b, KH, s, d]
    state: SeqState,
    row_idx: torch.Tensor,  # [b, R]
    row_valid: torch.Tensor,  # [b, R]
    tp=None,  # the model group: q and k hold this rank's heads
) -> torch.Tensor:
    """Head-averaged causal softmax probabilities of the selected query rows
    -> [b, R, s] float32, invalid rows all zero. The products are float32
    from the operands; one kv head's query group at a time ([b, g, R, s]
    float32 logits, scaled, masked and softmaxed in place). Under tensor
    parallelism each kv head's group sum is gathered over ``tp`` and the
    sums are folded in the model's head order, as one device folds them."""
    b, h, s, d = q.shape
    kh = k.shape[1]
    g = h // kh
    rows = row_idx.shape[1]
    q_rows = torch.gather(q, 2, row_idx[:, None, :, None].expand(b, h, rows, d))
    qp = torch.gather(state.positions, 1, row_idx)
    attend = (state.positions[:, None, :] <= qp[:, :, None]) & state.valid[:, None, :]
    masked = ~(attend & row_valid[:, :, None])[:, None]  # [b, 1, R, s]
    acc = torch.zeros((b, rows, s), dtype=torch.float32, device=q.device)
    sums = []
    for j in range(kh):
        logits = torch.matmul(q_rows[:, j * g:(j + 1) * g].to(torch.float32),
                              k[:, j, None].to(torch.float32).transpose(-1, -2))
        logits.mul_(d ** -0.5).masked_fill_(masked, att.NEG_INF)
        logits.sub_(torch.amax(logits, dim=-1, keepdim=True)).exp_()
        logits.div_(torch.clamp(logits.sum(dim=-1, keepdim=True), min=1e-30))
        if tp is None:
            acc.add_(logits.sum(dim=1))
        else:
            sums.append(logits.sum(dim=1))
        del logits  # else it lives on while the next group's logits are made
    if tp is not None:  # every kv head's sum, in the model's head order
        every = comm.all_gather(torch.stack(sums), tp, dim=0)
        for j in range(every.shape[0]):
            acc.add_(every[j])
        h = every.shape[0] * g
    return acc.div_(h).masked_fill_(~row_valid[:, :, None], 0.0)


def _recent_scores(
    mcfg: MethodConfig,
    p: torch.Tensor,  # [b, R, s] probabilities of the rows row_idx
    row_idx: torch.Tensor,  # [b, R]
    row_valid: torch.Tensor,  # [b, R]
    state: SeqState,
    recent_dyn: torch.Tensor,  # [b] int32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The mean over the (distance-weighted) recent rows of their
    head-averaged probabilities -> (scores [b, s] float32, context [b, s]).

    The recent rows are the valid rows of ``row_idx`` from layout index
    ``count - (recent_dyn + 1)`` on; a recent row's weight is
    ``linspace(1.0, distance_weight)`` at its rank from that index, and every
    other row of ``p`` weighs 0. Context columns lie before the recent rows;
    the first ``sink_len`` of them are pinned to 3e38 after the sum."""
    n_rows = (recent_dyn + 1).to(torch.float32)[:, None]
    start = torch.clamp(state.count - (recent_dyn + 1), min=0)[:, None]
    rank = row_idx - start
    recent = row_valid & (rank >= 0)
    w = 1.0 + (mcfg.pyramid_distance_weight - 1.0) * (
        rank.to(torch.float32) / torch.clamp(n_rows - 1.0, min=1.0))
    w = torch.where(recent, w, 0.0)
    scores = torch.bmm(w[:, None, :], p)[:, 0] / torch.clamp(n_rows, min=1.0)
    s = p.shape[2]
    idx = torch.arange(s, device=p.device)[None, :]
    context = state.valid & (idx < (state.count - (recent_dyn + 1))[:, None])
    scores = torch.where((idx < mcfg.pyramid_sink_len) & context, SINK_SCORE, scores)
    return torch.where(context, scores, 0.0), context


class PyramidDecodeState(NamedTuple):
    """Rolling score state for generation-stage re-compression.

    Rows are a stamp ring of the last ``rr = recent_cap + 1`` query rows'
    head-averaged probabilities; columns are cache slots. A row's
    probability at a slot appended after the row ran is zero by construction
    (the slot was invalid when its softmax ran); evicted slots stop being
    candidates. Every field is written in place."""

    probs: torch.Tensor  # [L, b, rr, C] float32
    row_stamp: torch.Tensor  # [L, b, rr] int32 (decode step stamp; EMPTY_STAMP = empty)
    past: torch.Tensor  # [L, b] int32: the reference's past_kv_seq_lens
    live: torch.Tensor  # [L, b] int32: live entries per layer


def empty_decode_state(num_layers: int, batch: int, rr: int, capacity: int,
                       device) -> PyramidDecodeState:
    return PyramidDecodeState(
        probs=torch.zeros((num_layers, batch, rr, capacity), dtype=torch.float32, device=device),
        row_stamp=torch.full((num_layers, batch, rr), EMPTY_STAMP, dtype=torch.int32,
                             device=device),
        past=torch.zeros((num_layers, batch), dtype=torch.int32, device=device),
        live=torch.zeros((num_layers, batch), dtype=torch.int32, device=device))


def _seed_layer_state(pstate: PyramidDecodeState, l: int, p: torch.Tensor,
                      row_idx: torch.Tensor, row_valid: torch.Tensor,
                      count: torch.Tensor) -> None:
    """Seed layer ``l``'s score buffer from prefill, in place: rows = the last
    rr valid prefill queries' probabilities ``p`` [b, rr, s] (columns = this
    layer's cache slots, front-aligned; decode slots stay zero), each at ring
    index ``stamp mod rr`` with stamp 0 for the last prefill token."""
    b, rr, s = p.shape
    stamp = row_idx - (count - 1)[:, None]
    stamp = torch.where(row_valid, stamp, EMPTY_STAMP).to(torch.int32)
    ring = torch.remainder(row_idx - count[:, None] + 1, rr)  # distinct for the rr rows
    rows = torch.arange(b, device=p.device)[:, None]
    pstate.probs[l, :, :, :s][rows, ring] = p
    pstate.row_stamp[l][rows, ring] = stamp


def prefill(
    params: Dict[str, Any],
    cfg: ModelConfig,
    mcfg: MethodConfig,
    ecfg: EngineConfig,
    shapes: PrefillShapes,
    tokens: torch.Tensor,  # [b, bucket]
    n_true: torch.Tensor,  # [b] int32
    want_decode_state: bool = False,
    mesh=None,  # parallel.sharding.Mesh: the params are this rank's shard
):
    """The pyramidal prefill -> (last-token logits [b, V] float32, cache), and
    the seeded ``PyramidDecodeState`` with ``want_decode_state``. The cache's
    capacity is uniform (bucket + decode room); each layer's contents follow
    the pyramid, validity-masked. ``cfg`` is the whole model's; over a mesh
    the cache and the state are the rank's (its kv heads, its stage's
    layers)."""
    b, s0 = tokens.shape
    if s0 != shapes.bucket:
        raise ValueError(f"tokens length {s0} != bucket {shapes.bucket}")
    dev = tokens.device
    L = cfg.num_layers
    lengths = plan_layer_lengths(cfg, mcfg, s0, ecfg.capacity_align)
    recent_cap = int(s0 * mcfg.pyramid_recent_ratio)
    recent_dyn = recent_length(n_true, mcfg)
    rr = decode_buffer_rows(mcfg, s0)
    cap_total = shapes.total_capacity
    # whether every example's recent rows (the last recent_dyn + 1) lie among
    # the seed rows (the last rr), so a compressing layer's scores reuse the
    # seed's probabilities; float32 rounding of recent_dyn can pass recent_cap
    ratio = np.float32(mcfg.pyramid_recent_ratio)
    recent_in_seed = int(np.floor(np.float32(s0) * ratio)) <= recent_cap

    part = pipeline.part(cfg, mesh)
    lcfg, tp = part.cfg, part.tp
    state = None
    if part.stage == 0:
        positions = torch.arange(s0, dtype=torch.int32, device=dev)[None].expand(b, s0)
        state = SeqState(h=llama.embed(params, cfg, tokens), positions=positions,
                         valid=positions < n_true[:, None], count=n_true, n_orig=n_true)
    caches: List[KVCache] = []
    pstate = (empty_decode_state(part.num_layers, b, rr, cap_total, dev) if want_decode_state
              else None)

    def layer(state: SeqState, l: int) -> SeqState:
        guards.at(f"prefill layer {l}")
        i = l - part.lo
        h, _, q, k, _, v = family.prefill_layer(
            family.of(cfg).layer_params(params, i), lcfg, state.h, state.positions,
            lambda q, k, v: (_attend(cfg, q, k, v, state), None), l,
            mlp_chunk=ecfg.mlp_chunk_for(state.h.shape[1]), tp=tp)

        # this layer's cache: its (already shrunk) K/V, front-aligned
        s_l = k.shape[2]
        if not caches:
            caches.append(empty_cache(part.num_layers, b, lcfg.num_kv_heads, cap_total,
                                      cfg.head_dim, dtype=k.dtype, device=dev))
        cache = caches[0]
        cache.k[i, :, :, :s_l] = k
        cache.v[i, :, :, :s_l] = v
        cache.pos[i, :, :, :s_l] = state.positions[:, None, :]
        cache.valid[i, :, :, :s_l] = state.valid[:, None, :]

        new_cap = lengths[l + 1]
        compresses = new_cap < s_l
        if want_decode_state:
            # the last rr valid rows seed the decode state
            row_idx, row_valid = selection.window_indices(state.count - rr, rr, state.count)
            p = _rows_probs(q, k, state, row_idx, row_valid, tp)
            _seed_layer_state(pstate, i, p, row_idx, row_valid, state.count)
        if not compresses:
            return state._replace(h=h)
        if not (want_decode_state and recent_in_seed):
            # the JAX package's recent-row window
            row_idx, row_valid = selection.window_indices(
                state.count - (recent_dyn + 1), recent_cap + 1, state.count)
            p = _rows_probs(q, k, state, row_idx, row_valid, tp)
        scores, context = _recent_scores(mcfg, p, row_idx, row_valid, state, recent_dyn)
        ctx_dyn = torch.clamp(state.count - (recent_dyn + 1), min=0)
        r = decay_ratio(mcfg, l, L)
        topk_dyn = torch.floor(ctx_dyn.to(torch.float32) * r).to(torch.int32)
        # keep everything when the target falls below min_context_length
        # or the context itself is small; the reference adjusts
        # min_context_length to the prompt
        min_ctx_dyn = torch.clamp(n_true - 1 - recent_dyn,
                                  max=mcfg.pyramid_min_context_length)
        keep_all = (ctx_dyn <= min_ctx_dyn) | (topk_dyn <= min_ctx_dyn)
        topk_dyn = torch.where(keep_all, ctx_dyn, topk_dyn)
        ctx_keep_cap = max(new_cap - 1 - recent_cap, 1)
        top_idx, top_valid = selection.topk_select(
            scores[:, None, :], context, topk_dyn, ctx_keep_cap)
        keep = torch.zeros((b, s_l), dtype=torch.int32, device=dev)
        keep.scatter_add_(1, top_idx[:, 0], top_valid[:, 0].to(torch.int32))
        # the recent rows (the boundary row included) always survive
        idx = torch.arange(s_l, device=dev)[None, :]
        recent = state.valid & (idx >= (state.count - (recent_dyn + 1))[:, None])
        sel_idx, sel_valid = selection.sorted_union_indices((keep > 0) | recent, new_cap)
        h_new = selection.gather_tokens(h, sel_idx)
        pos_new = torch.gather(state.positions, 1, sel_idx)
        return SeqState(
            h=torch.where(sel_valid[:, :, None], h_new, 0),
            positions=torch.where(sel_valid, pos_new, 0).to(torch.int32),
            valid=sel_valid, count=sel_valid.sum(dim=-1).to(torch.int32),
            n_orig=state.n_orig)

    state = pipeline.run_layers(part, 0, L, state, layer, SeqState)
    logits = None if state is None else last_token_logits(params, lcfg, state, tp)
    [logits] = part.share(part.pipe - 1, None if logits is None else [logits], dev)
    cache = caches[0]
    if not want_decode_state:
        return logits, cache
    # the reference seeds past_kv_seq_lens with the whole layer length, the
    # recent window included, so the first event is late by ~recent
    counts = cache.valid[:, :, 0, :].sum(dim=-1).to(torch.int32)  # [L, b]
    pstate.past.copy_(counts)
    pstate.live.copy_(counts)
    return logits, cache, pstate


def _decode_attn_with_probs(
    q: torch.Tensor,  # [b, H, 1, d]
    k_cache: torch.Tensor,  # [b, KH, C, d]
    v_cache: torch.Tensor,
    valid: torch.Tensor,  # [b, KH, C]
    tp=None,  # the model group: q and the cache hold this rank's heads
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode attention that also returns the head-averaged probabilities
    [b, C] float32; logits and P.V in float32 from the operands, P cast to
    V's dtype first, as in the JAX package. Under tensor parallelism the mean
    is over every rank's heads, gathered over ``tp``."""
    b, H, _, d = q.shape
    kh = k_cache.shape[1]
    qg = q.reshape(b, kh, H // kh, d).to(torch.float32)
    logits = torch.matmul(qg, k_cache.to(torch.float32).transpose(-1, -2)) * (d ** -0.5)
    logits = logits.masked_fill(~valid[:, :, None, :], att.NEG_INF)
    p = torch.softmax(logits, dim=-1)  # [b, kh, g, C]
    out = torch.matmul(p.to(v_cache.dtype).to(torch.float32), v_cache.to(torch.float32))
    if tp is not None:
        p = comm.all_gather(p, tp, dim=1)
    return out.reshape(b, H, 1, d).to(q.dtype), p.mean(dim=(1, 2))


def decode_step(
    params: Dict[str, Any],
    cfg: ModelConfig,
    mcfg: MethodConfig,
    cache: KVCache,
    pstate: PyramidDecodeState,
    token: torch.Tensor,  # [b] int32
    pos: torch.Tensor,  # [b] int32 original position
    slot: Union[int, torch.Tensor],  # one cache slot, or a [b] tensor per example
    stamp: Union[int, torch.Tensor],  # decode step stamp (1 = first), int or [b]
    n_true: torch.Tensor,  # [b]
    r_dyn: torch.Tensor,  # [b] frozen recent length
    inv_freq: Optional[torch.Tensor] = None,
    mesh=None,  # parallel.sharding.Mesh: params, cache and state are this rank's
) -> Tuple[torch.Tensor, KVCache, PyramidDecodeState]:
    """One pyramid decode step: forward, score-buffer update and the
    conditional generation-stage eviction per layer. Returns (logits [b, V]
    float32, the cache and the state, both updated in place).

    Per-example ``slot``/``stamp`` serve the Scheduler, whose slots sit at
    different depths; ``Engine.generate`` passes ints."""
    dev = token.device
    if inv_freq is None:
        inv_freq = inv_freq_on(cfg, dev)
    if not isinstance(slot, int):
        slot = slot.to(device=dev, dtype=torch.long)
    part = pipeline.part(cfg, mesh)
    lcfg, tp = part.cfg, part.tp
    b = token.shape[0]
    L = cfg.num_layers
    ch = cache.k.shape[2]
    cap = cache.k.shape[3]
    rr = pstate.probs.shape[2]
    exceed = mcfg.pyramid_exceed_length_to_compress
    stamp = torch.as_tensor(stamp, dtype=torch.int32, device=dev).expand(b)
    n_true = n_true.to(dev)
    r_dyn = r_dyn.to(device=dev, dtype=torch.int32)
    rows = torch.arange(b, device=dev)
    ring = torch.remainder(stamp, rr).long()
    write_slot(cache.pos.permute(1, 2, 3, 0), pos[:, None, None].expand(b, ch, part.num_layers),
               slot)
    write_slot(cache.valid.permute(1, 2, 3, 0), True, slot)

    def layer(st, l):
        guards.at(f"decode layer {l}")
        i = l - part.lo
        valid_l = cache.valid[i]  # [b, CH, C], a view
        h, pm = family.decode_layer(
            family.of(cfg).layer_params(params, i), lcfg, st[0], pos, inv_freq, cache, i,
            slot, rows, tp=tp,
            attend=lambda q: _decode_attn_with_probs(q, cache.k[i], cache.v[i], valid_l, tp))

        # the score buffer: this query's probabilities over the cache slots
        probs_l, stamp_l = pstate.probs[i], pstate.row_stamp[i]
        probs_l[rows, ring] = pm
        stamp_l[rows, ring] = stamp
        live_l = pstate.live[i] + 1

        # the generation-stage event: the candidate band is the live entries
        # ranked [r_dyn + 2, r_dyn + 1 + exceed] from the end; entry order is
        # slot order, so the rank from the end is a reversed cumulative sum
        past_l = pstate.past[i]
        trigger = (n_true + stamp - r_dyn - past_l) >= exceed  # [b]
        live_slots = valid_l[:, 0, :]  # [b, C]
        rank = live_slots.flip(-1).to(torch.int32).cumsum(-1, dtype=torch.int32).flip(-1)
        band = live_slots & (rank >= (r_dyn + 2)[:, None]) & (rank <= (r_dyn + 1 + exceed)[:, None])
        # distance-weighted mean over the last (1 + recent) rows
        i_rank = stamp_l - (stamp - r_dyn)[:, None]
        row_ok = (i_rank >= 0) & (i_rank <= r_dyn[:, None])
        wrow = 1.0 + (mcfg.pyramid_distance_weight - 1.0) * (
            i_rank.to(torch.float32) / torch.clamp(r_dyn, min=1)[:, None].to(torch.float32))
        wrow = torch.where(row_ok, wrow, 0.0)
        scores = torch.bmm(wrow[:, None, :], probs_l)[:, 0] / (
            (r_dyn + 1).to(torch.float32)[:, None])
        k_keep = max(int(exceed * mcfg.pyramid_gen_compress_ratio * gen_decay_ratio(mcfg, l, L)),
                     1)
        top_idx, top_val = selection.topk_select(
            scores[:, None, :], band, torch.full((b,), k_keep, dtype=torch.int32, device=dev),
            min(k_keep, exceed))
        keep = torch.zeros((b, cap), dtype=torch.int32, device=dev)
        keep.scatter_add_(1, top_idx[:, 0], top_val[:, 0].to(torch.int32))
        evict = band & (keep == 0) & trigger[:, None]
        valid_l &= ~evict[:, None, :]
        live_l = live_l - evict.sum(dim=-1).to(torch.int32)
        pstate.past[i] = torch.where(trigger, live_l - r_dyn, past_l)
        pstate.live[i] = live_l
        return (h,)

    h0 = (llama.embed(params, cfg, token[:, None]),) if part.stage == 0 else None
    out = pipeline.run_layers(part, 0, L, h0, layer)
    logits = None if out is None else llama.unembed(params, cfg, out[0], tp)[:, 0, :]
    [logits] = part.share(part.pipe - 1, None if logits is None else [logits], dev)
    return logits, cache, pstate


def generation_step(
    params: Dict[str, Any],
    cfg: ModelConfig,
    mcfg: MethodConfig,
    shapes: PrefillShapes,
    pstate: PyramidDecodeState,
    n_true: torch.Tensor,  # [b] int32
    mesh=None,
) -> StepFn:
    """The step ``engine.decode.greedy_generate`` takes for PyramidInfer:
    ``decode_step`` at slot prefill_capacity + t with stamp t + 1, the score
    state updated in place; the recent length frozen at
    ``floor(float32(n) * recent_ratio)``."""
    r_dyn = recent_length(n_true, mcfg)

    def step(cache, tok, t, inv_freq):
        logits, cache, _ = decode_step(
            params, cfg, mcfg, cache, pstate, tok, n_true + t,
            shapes.prefill_capacity + t, t + 1, n_true, r_dyn, inv_freq, mesh)
        return logits, cache

    return step
