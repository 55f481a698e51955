"""Prefill: full-context attention + per-layer cache compression + TSP.

Port of ``fastkv_tpu.engine.prefill`` for FullKV, FastKV, SnapKV, H2O and
StreamingLLM on the Llama and Mistral families, with or without a sliding
window, on one device or over a mesh (sequence, tensor and pipeline
parallelism); and for FullKV and FastKV on DeepSeek-V2 on one device. A
layer is ``models.family.prefill_layer``, then its keep-set: DeepSeek-V2's
attention expands its latent to 16 heads of q/k width 192 and v width 128
for the flash call, its window scores sum all 16 query heads into its one
latent cache head, and its cache rows are the latents and the shared rope
key (``models.deepseek_v2``). GemFilter's
second pass is this module's FullKV prefill of the reduced prompt
(``engine.gemfilter`` selects it); PyramidInfer's prefill is
``engine.pyramid.prefill``, which ``prefill`` hands it to, as the JAX
package does.

  * The decoder runs as a Python loop over layer indices, ``run_segment``
    (the JAX package's ``lax.scan``, ``scan_segment``). FastKV's TSP layer
    runs between two segments: layers [0, tsp_idx) at the bucket length, the
    TSP layer (which also emits the surviving token set), the token gather,
    then layers (tsp_idx, L) at the reduced ``tsp_capacity``.
  * Budgets: static capacities from the bucketed length; per-example budgets
    drive validity masks (``fastkv_tpu_torch.policies.budgets``).
  * Attention runs through ``ops.flash_prefill.flash_attention``: the CUDA
    kernel on the card, its plain version on the CPU. Under a sliding window
    it masks by layout index (``_mask_positions``); RoPE keeps the original
    positions. With ``EngineConfig.fuse_window_scores`` FastKV and SnapKV
    take their observation-window scores from the same flash call (its fused
    form) instead of a separate pass, in every layer of both segments.
  * H2O scores every key by its accumulated attention mass over all query
    rows (``ops.attention.h2o_scores``, plain torch over row blocks, after the
    layer's flash call) and keeps a per-query-head cache, as SnapKV does.
  * Each layer's kept K/V/positions are written into the one stacked cache
    buffer in place, so the layers' results are never concatenated. With
    ``EngineConfig.kv_int8`` the kept K/V are quantized per (head, slot)
    after the invalid slots are zeroed, and their scales are cached too.
  * The LM head sees only the last valid token of each example.
  * Sequence parallelism (``pcfg.sp_mode`` 'ring' or 'ulysses' with
    ``pcfg.seq`` > 1, over ``parallel.sharding.make_mesh``; JAX :436-465,
    :491-530): each rank of a seq group embeds and runs its own [s/P]-token
    slice of the bucket through the pre-TSP segment (FastKV's layers [0,
    tsp_idx], every layer for the other methods), with ring or Ulysses
    attention (``parallel.ring_attention``). Where the JAX package's
    partitioner gathered implicitly, this module gathers explicitly over the
    seq group, so the single-device code runs unchanged on the gathered
    tensors and every rank computes the same keep-sets as one device would:
    the layer's K and V (the window scores read every key, and the keep-set
    gathers the cache from them), the observation-window query rows (which
    may straddle two ranks), and, at the end of the segment, the hidden
    states for the TSP gather or the last valid token's row for the LM head.
    H2O's scores sum every row's probabilities over the whole sequence: each
    rank takes the column sums of its own rows against the gathered K
    (``h2o_scores(row_offset=)``), and the partial sums are folded over the
    seq group in rank order. After the TSP gather segment B runs whole on
    every rank of the group, and the cache comes out whole on each. Fused
    window scores are off in the sharded segment (the kernel sees one
    slice), as in the JAX package. PyramidInfer returns before the SP
    branch (its own prefill), as in the JAX package.
  * Tensor and pipeline parallelism (``pcfg.model``, ``pcfg.pipe`` > 1; the
    JAX package's partitioner over ``sharding.param_pspecs``): a rank runs
    its ``parallel.pipeline.Part``, the layers of its stage over its heads
    and MLP columns (``models.llama`` sums the row-parallel products over the
    model group), and its cache holds those heads and layers. The stages run
    in turn (``pipeline.run_layers``): each hands the ``SeqState`` to the
    next, after the TSP gather where the TSP layer is its last; the last
    stage's logits go to every stage. TSP's cross-head sum gathers over the
    model group (``methods.fastkv_tsp_set``). Sequence parallelism composes
    with both: each seq group is one model rank's, on one stage.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from fastkv_tpu_torch.cache.kv_cache import KVCache, empty_cache
from fastkv_tpu_torch.core import quant
from fastkv_tpu_torch.core.config import (
    EngineConfig,
    Method,
    MethodConfig,
    ModelConfig,
    round_up,
)
from fastkv_tpu_torch.models import family, llama
from fastkv_tpu_torch.ops import attention as att
from fastkv_tpu_torch.ops import flash_prefill
from fastkv_tpu_torch.parallel import comm, pipeline
from fastkv_tpu_torch.parallel import ring_attention as ra
from fastkv_tpu_torch.policies import budgets, methods, selection
from fastkv_tpu_torch.utils import guards, profiling

@dataclasses.dataclass(frozen=True)
class PrefillShapes:
    """Static shape plan for one (method, bucket) pair."""

    bucket: int
    prefill_capacity: int  # kept-slot extent per layer (incl. window for scores)
    keep_capacity: int  # non-window top-k extent (score methods)
    tsp_capacity: int  # post-TSP sequence extent (fastkv; else = bucket)
    decode_capacity: int

    @property
    def total_capacity(self) -> int:
        return self.prefill_capacity + self.decode_capacity


def plan_shapes(
    cfg: ModelConfig, mcfg: MethodConfig, ecfg: EngineConfig, n_bucket: int
) -> PrefillShapes:
    """The JAX package's plan without its TPU decode-block padding: the port's
    decode kernel masks its own ragged edge."""
    align = ecfg.capacity_align
    decode_cap = round_up(ecfg.max_new_tokens, align)
    m = mcfg.method
    if m in (Method.FULLKV, Method.GEMFILTER, Method.PYRAMIDINFER):
        return PrefillShapes(n_bucket, n_bucket, n_bucket, n_bucket, decode_cap)
    if m == Method.STREAMINGLLM:
        if mcfg.eviction_mode == "proportional":
            cap = int(n_bucket * mcfg.retain_rate)
        else:
            cap = mcfg.max_capacity_prompt
        cap = min(round_up(max(cap, 8), align), n_bucket)
        return PrefillShapes(n_bucket, cap, cap, n_bucket, decode_cap)
    # score-based: fastkv / snapkv / h2o
    bud_a = budgets.static_prefill_budget(mcfg, n_bucket, is_post_tsp=False, align=align)
    keep_cap = bud_a.keep_capacity
    tsp_cap = n_bucket
    if m == Method.FASTKV:
        tsp_cap = bud_a.tsp_capacity
        bud_b = budgets.static_prefill_budget(mcfg, tsp_cap, is_post_tsp=True, align=align)
        keep_cap = max(keep_cap, bud_b.keep_capacity)
    prefill_cap = min(keep_cap + mcfg.window_size, n_bucket)
    return PrefillShapes(n_bucket, prefill_cap, keep_cap, tsp_cap, decode_cap)


class SeqState(NamedTuple):
    """The running sequence of one prefill segment."""

    h: torch.Tensor  # [b, s, D]
    positions: torch.Tensor  # [b, s] int32 original position ids (invalid slots: 0)
    valid: torch.Tensor  # [b, s] bool
    count: torch.Tensor  # [b] int32 number of valid tokens in this layout
    n_orig: torch.Tensor  # [b] int32 original true prompt length (window anchor)


def _mask_positions(cfg: ModelConfig, state: SeqState) -> torch.Tensor:
    """Positions used for attention masking (RoPE always uses the original
    positions). Under a sliding window the window distance is measured in
    layout indices, as in the JAX package: the reference hands flash-attn the
    post-TSP sequence contiguously, so its window counts entries, not original
    positions. For an ascending valid prefix, index causality equals position
    causality, so this changes only the window term."""
    if cfg.sliding_window is None:
        return state.positions
    b, s = state.positions.shape
    return torch.arange(s, dtype=torch.int32, device=state.positions.device)[None].expand(b, s)


def _attend(cfg: ModelConfig, q, k, v, state: SeqState) -> torch.Tensor:
    return flash_prefill.flash_attention(
        q, k, v, _mask_positions(cfg, state), state.count, sliding_window=cfg.sliding_window,
        scale=cfg.softmax_scale)


def _window_rows(
    q: torch.Tensor, state: SeqState, window_size: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The observation-window query rows (last W valid tokens).

    Returns (q_win [b, H, W, d], win_idx [b, W], win_valid [b, W])."""
    win_idx, win_valid = selection.window_indices(
        state.count - window_size, window_size, state.count)
    b, h, _, d = q.shape
    guards.in_bounds("observation-window rows", win_idx, q.shape[2])
    q_win = torch.gather(q, 2, win_idx[:, None, :, None].expand(b, h, window_size, d))
    return q_win, win_idx, win_valid


def _window_scores(
    q_win: torch.Tensor,
    k: torch.Tensor,
    win_idx: torch.Tensor,
    win_valid: torch.Tensor,
    state: SeqState,
    window_size: int,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact SnapKV/FastKV observation scores in O(W·s) memory: the causal
    softmax of the last W rows, summed over those rows. Columns inside the
    window or invalid get score 0. The mask has no sliding-window term, as in
    the JAX package: the scores of a sliding-window model see the whole
    causal prefix. ``scale``: the logits' (the model's softmax scale).

    Returns (scores [b, H, s] float32, selectable [b, s])."""
    b, h, w, d = q_win.shape
    kh = k.shape[1]
    qg = q_win.reshape(b, kh, h // kh, w, d).to(torch.float32)
    logits = torch.matmul(qg, k.to(torch.float32)[:, :, None].transpose(-1, -2))
    logits = logits.reshape(b, h, w, -1) * scale
    qw_pos = torch.gather(state.positions, 1, win_idx)  # [b, W]
    attend = (state.positions[:, None, :] <= qw_pos[:, :, None]) & state.valid[:, None, :]
    attend = attend & win_valid[:, :, None]
    logits = logits.masked_fill(~attend[:, None], att.NEG_INF)
    m = torch.amax(logits, dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    p = e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    p = torch.where(win_valid[:, None, :, None], p, 0.0)
    scores = p.sum(dim=-2)  # [b, H, s]
    col_in_window = state.positions >= (state.n_orig[:, None] - window_size)
    selectable = state.valid & ~col_in_window
    return torch.where(selectable[:, None, :], scores, 0.0), selectable


def _keep_set_for_layer(
    cfg: ModelConfig,
    mcfg: MethodConfig,
    shapes: PrefillShapes,
    state: SeqState,
    q: torch.Tensor,
    k: torch.Tensor,
    is_post_tsp: bool,
    precomputed=None,
):
    """This layer's cache keep-set, plus the raw window-score context
    (scores, selectable, win_idx, win_valid) that the TSP layer reuses.
    ``precomputed``: that context from the fused flash call, which skips the
    separate scoring pass."""
    m = mcfg.method
    if m in (Method.FULLKV, Method.STREAMINGLLM) or precomputed is not None:
        return keep_from_window(cfg, mcfg, shapes, state, None, None, None, k, is_post_tsp,
                                precomputed)
    if m == Method.H2O:
        W = mcfg.window_size
        raw = att.h2o_scores(q, k, state.valid, state.n_orig, W)
        selectable = state.valid & ~(state.positions >= state.n_orig[:, None] - W)
        _, win_idx, win_valid = _window_rows(q, state, W)
        return keep_from_window(cfg, mcfg, shapes, state, None, None, None, k, is_post_tsp,
                                (raw, selectable, win_idx, win_valid))
    q_win, win_idx, win_valid = _window_rows(q, state, mcfg.window_size)
    return keep_from_window(cfg, mcfg, shapes, state, q_win, win_idx, win_valid, k, is_post_tsp)


def keep_from_window(
    cfg: ModelConfig,
    mcfg: MethodConfig,
    shapes: PrefillShapes,
    state: SeqState,
    q_win: Optional[torch.Tensor],  # [b, H, W, d] observation-window query rows
    win_idx: Optional[torch.Tensor],  # [b, W]
    win_valid: Optional[torch.Tensor],  # [b, W]
    k: torch.Tensor,
    is_post_tsp: bool,
    precomputed=None,  # (raw, selectable, win_idx, win_valid) from the fused flash call
):
    """The keep-set from the observation-window rows (score methods; FullKV
    and StreamingLLM need none of them), or from scores already taken (the
    fused flash call's, or H2O's). Chunked admission captures the rows chunk
    by chunk and calls this at its finish."""
    m = mcfg.method
    b = state.count.shape[0]
    ch = methods.cache_heads(m, cfg)
    if m == Method.FULLKV:
        return methods.fullkv_keep(ch, b, shapes.prefill_capacity, state.count), None
    if m == Method.STREAMINGLLM:
        return methods.streamingllm_keep(mcfg, ch, b, state.count, shapes.prefill_capacity), None
    k_budget = budgets.dynamic_keep_budget(mcfg, state.count, is_post_tsp)
    if precomputed is not None:
        raw, selectable, win_idx, win_valid = precomputed
    else:
        raw, selectable = _window_scores(q_win, k, win_idx, win_valid, state, mcfg.window_size,
                                         cfg.softmax_scale)
    ks = methods.score_based_keep(
        m, mcfg, cfg, raw, selectable, win_idx, win_valid, k_budget, shapes.keep_capacity)
    return ks, (raw, selectable, win_idx, win_valid)


def _gather_cache(k: torch.Tensor, v: torch.Tensor, state: SeqState, keep: methods.KeepSet,
                  kv_int8: bool = False) -> KVCache:
    """Kept K/V/pos/valid of one layer, [b, CH, keep capacity(, d)], in a
    KVCache without the layer axis. A per-query-head cache (SnapKV, H2O) repeats
    each kv head over its query heads first, as the reference does before its
    cache update. With ``kv_int8`` K/V are quantized per (head, slot) after
    the invalid slots are zeroed (an empty slot gets scale 1e-12 / 127)."""
    b, kh, s, d = k.shape
    ch = keep.idx.shape[1]
    if ch != kh:
        k = k.repeat_interleave(ch // kh, dim=1)
        v = v.repeat_interleave(ch // kh, dim=1)
    k_kept = selection.gather_tokens(k, keep.idx)
    v_kept = selection.gather_tokens(v, keep.idx)
    pos_kept = torch.gather(state.positions[:, None, :].expand(b, ch, s), 2, keep.idx)
    mask = keep.valid[..., None]
    k_kept = torch.where(mask, k_kept, 0)
    v_kept = torch.where(mask, v_kept, 0)
    k_sc = v_sc = None
    if kv_int8:
        k_kept, k_sc = quant.quantize_kv(k_kept)
        v_kept, v_sc = quant.quantize_kv(v_kept)
    return KVCache(k=k_kept, v=v_kept, pos=torch.where(keep.valid, pos_kept, 0),
                   valid=keep.valid, k_scale=k_sc, v_scale=v_sc)


def _attend_fused(cfg: ModelConfig, mcfg: MethodConfig, q, k, v, state: SeqState):
    """Attention and the observation-window scores from one flash call ->
    (attn, (raw, selectable, win_idx, win_valid)). The window rows' positions
    are the masking positions (layout indices under a sliding window), -1 on
    rows of a prompt shorter than the window; columns that cannot be selected
    get score 0, as the separate pass gives them."""
    W = mcfg.window_size
    q_win, win_idx, win_valid = _window_rows(q, state, W)
    mpos = _mask_positions(cfg, state)
    qw_pos = torch.where(win_valid, torch.gather(mpos, 1, win_idx), -1)
    attn, raw = flash_prefill.flash_attention(
        q, k, v, mpos, state.count, sliding_window=cfg.sliding_window,
        window_q=q_win, window_q_pos=qw_pos)
    col_in_window = state.positions >= (state.n_orig[:, None] - W)
    selectable = state.valid & ~col_in_window
    raw = torch.where(selectable[:, None, :], raw, 0.0)
    return attn, (raw, selectable, win_idx, win_valid)


class SeqShard(NamedTuple):
    """What a layer of the sequence-sharded segment needs beyond its slice:
    the mesh, the attention callable (``sp_attend_fn``) and the whole
    segment's positions and validity [b, s] (the keep-set is computed on
    the whole sequence)."""

    mesh: Any
    attend: Callable
    positions: torch.Tensor
    valid: torch.Tensor

    def whole(self, state: SeqState) -> SeqState:
        """``state`` with the whole segment's positions and validity (its h
        stays the slice)."""
        return state._replace(positions=self.positions, valid=self.valid)


def sp_attend_fn(cfg: ModelConfig, pcfg, mesh) -> Callable:
    """The sequence-parallel attention of the pre-TSP layers:
    attend(q, k, v, state, shard) -> this rank's [b, H, s/P, d]. 'ring'
    rotates K/V chunks around the seq group and merges partials by their row
    statistics; 'ulysses' reshards sequence to heads, runs the causal kernel
    over the whole sequence and reshards back. Both mask by the original
    positions, as the JAX package's SP attention does (the pre-TSP layout's
    positions are its layout indices)."""
    if pcfg.sp_mode == "ring":
        def attend(q, k, v, state: SeqState, shard: SeqShard):
            return ra.ring_flash_attention(q, k, v, state.positions, state.count, mesh,
                                           cfg.sliding_window)
    elif pcfg.sp_mode == "ulysses":
        def attend(q, k, v, state: SeqState, shard: SeqShard):
            return ra.ulysses_attention(q, k, v, shard.positions, state.count, mesh,
                                        cfg.sliding_window)
    else:
        raise ValueError(f"unknown sp_mode {pcfg.sp_mode}")
    return attend


def _sp_window_rows(q: torch.Tensor, whole: SeqState, window_size: int, mesh):
    """The observation-window rows (``_window_rows``) of a sequence-sharded
    q [b, H, s/P, d]: each rank takes the rows it holds, the seq group
    gathers them, and each row comes from its owner (the rows of a window
    that ends mid-slice lie on two ranks) -> (q_win [b, H, W, d], win_idx,
    win_valid), the same on every rank."""
    win_idx, win_valid = selection.window_indices(
        whole.count - window_size, window_size, whole.count)
    b, h, s_loc, d = q.shape
    guards.in_bounds("observation-window rows", win_idx, s_loc * mesh.seq)
    local = torch.clamp(win_idx - mesh.seq_index * s_loc, 0, s_loc - 1)
    mine = torch.gather(q, 2, local[:, None, :, None].expand(b, h, window_size, d))
    every = comm.all_gather(mine[None], mesh.seq_group, dim=0)  # [P, b, H, W, d]
    owner = (win_idx // s_loc)[None, :, None, :, None].expand(1, b, h, window_size, d)
    return torch.gather(every, 0, owner)[0], win_idx, win_valid


def _sp_keep_set(cfg, mcfg, shapes, state: SeqState, q, k, v, is_post_tsp: bool,
                 shard: SeqShard):
    """The keep-set of a sequence-sharded layer, the same on every rank of
    the seq group: K and V gathered whole, the window rows from their owners
    (H2O: the column sums of every rank's rows, folded in rank order) ->
    (keep, score context, k, v, whole state) for ``_gather_cache`` and TSP."""
    mesh = shard.mesh
    g = mesh.seq_group
    k_all = comm.all_gather(k, g, dim=2)
    v_all = comm.all_gather(v, g, dim=2)
    whole = shard.whole(state)
    q_win = win_idx = win_valid = precomputed = None
    if mcfg.method == Method.H2O:
        W = mcfg.window_size
        mine = att.h2o_scores(q, k_all, whole.valid, whole.n_orig, W,
                              row_offset=mesh.seq_index * q.shape[2])
        raw = comm.all_sum(mine, g)
        selectable = whole.valid & ~(whole.positions >= whole.n_orig[:, None] - W)
        win_idx, win_valid = selection.window_indices(whole.count - W, W, whole.count)
        precomputed = (raw, selectable, win_idx, win_valid)
    elif mcfg.method not in (Method.FULLKV, Method.STREAMINGLLM):
        q_win, win_idx, win_valid = _sp_window_rows(q, whole, mcfg.window_size, mesh)
    keep, ctx = keep_from_window(cfg, mcfg, shapes, whole, q_win, win_idx, win_valid, k_all,
                                 is_post_tsp, precomputed)
    return keep, ctx, k_all, v_all, whole


def _sp_last_hidden(h: torch.Tensor, count: torch.Tensor, mesh) -> torch.Tensor:
    """The hidden state [b, 1, D] of each example's last valid token from a
    sequence-sharded h [b, s/P, D]: the owner's row, on every rank."""
    b, s_loc, dm = h.shape
    last = torch.clamp(count.long() - 1, min=0)
    local = torch.clamp(last - mesh.seq_index * s_loc, 0, s_loc - 1)
    mine = selection.gather_tokens(h, local[:, None])  # [b, 1, D]
    every = comm.all_gather(mine, mesh.seq_group, dim=1)  # [b, P, D]
    return torch.gather(every, 1, (last // s_loc)[:, None, None].expand(b, 1, dm))


def make_layer_fn(
    cfg: ModelConfig,
    mcfg: MethodConfig,
    shapes: PrefillShapes,
    is_post_tsp: bool,
    want_tsp: bool = False,
    ecfg: Optional[EngineConfig] = None,
    shard: Optional[SeqShard] = None,
    tp=None,
) -> Callable:
    """The per-layer prefill body: layer_fn(state, lp, l) -> (new_state,
    cache_layer, tsp_set or None) for layer ``l``. With ``shard`` the state holds this
    rank's slice of a sequence-sharded segment (its count and n_orig are the
    whole sequence's); the cache layer and the TSP set are the whole
    sequence's. Under tensor parallelism ``cfg`` is the rank's
    (``pipeline.Part.cfg``) and ``tp`` its model group."""
    ecfg = ecfg or EngineConfig()
    # the flash call also scores the observation window when asked, for the
    # methods that score it, as in the JAX package (H2O scores every row);
    # not in a sequence-sharded segment, where the kernel sees one slice
    fused = (ecfg.fuse_window_scores and shard is None
             and mcfg.method in (Method.FASTKV, Method.SNAPKV))

    def layer_fn(state: SeqState, lp: Dict[str, torch.Tensor], l: int):
        def attend(q, k, v):
            if shard is not None:
                return shard.attend(q, k, v, state, shard), None
            if fused:
                return _attend_fused(cfg, mcfg, q, k, v, state)
            return _attend(cfg, q, k, v, state), None

        h, precomputed, q, k, ck, cv = family.prefill_layer(
            lp, cfg, state.h, state.positions, attend, l,
            mlp_chunk=ecfg.mlp_chunk_for(state.h.shape[1]), tp=tp, valid=state.valid)
        if shard is not None:
            keep, score_ctx, k_all, v_all, whole = _sp_keep_set(
                cfg, mcfg, shapes, state, q, ck, cv, is_post_tsp, shard)
            cache_layer = _gather_cache(k_all, v_all, whole, keep, ecfg.kv_int8)
        else:
            with profiling.span("prefill.select", device=True, layer=l):
                keep, score_ctx = _keep_set_for_layer(cfg, mcfg, shapes, state, q, k,
                                                      is_post_tsp, precomputed)
                cache_layer = _gather_cache(ck, cv, state, keep, ecfg.kv_int8)
        tsp_out = None
        if want_tsp:
            raw, selectable, win_idx, win_valid = score_ctx
            tsp_budget = budgets.dynamic_tsp_budget(mcfg, state.count)
            tsp_out = methods.fastkv_tsp_set(
                mcfg, cfg, raw, selectable, win_idx, win_valid,
                tsp_budget, shapes.tsp_capacity, tp)
        return state._replace(h=h), cache_layer, tsp_out

    return layer_fn


def tsp_gather(state: SeqState, tsp: methods.TspSet) -> SeqState:
    """Between-segment token gather: hidden states AND position ids by the
    sorted TSP indices; later layers re-derive RoPE from the original positions."""
    h = selection.gather_tokens(state.h, tsp.idx)
    pos = torch.gather(state.positions, 1, tsp.idx)
    pos = torch.where(tsp.valid, pos, 0)
    h = torch.where(tsp.valid[:, :, None], h, 0)
    count = tsp.valid.sum(dim=-1).to(torch.int32)
    return SeqState(h=h, positions=pos, valid=tsp.valid, count=count, n_orig=state.n_orig)


class StackedCache:
    """Receives each layer's kept parts (a KVCache without the layer axis) and
    writes them in place, field by field, into one stacked buffer, made at
    the first layer with the kept extent plus the decode headroom (as the JAX
    package sizes its padded per-layer cache arrays), so the layers' results
    are never concatenated."""

    def __init__(self, num_layers: int, decode_capacity: int):
        self.num_layers = num_layers
        self.decode_capacity = decode_capacity
        self.cache: Optional[KVCache] = None

    def __call__(self, l: int, parts: KVCache) -> None:
        b, ch, cap, d = parts.k.shape
        if self.cache is None:
            self.cache = empty_cache(self.num_layers, b, ch, cap + self.decode_capacity, d,
                                     dtype=parts.k.dtype, device=parts.k.device,
                                     kv_int8=parts.k_scale is not None, v_dim=parts.v.shape[-1])
        for name, src in parts.fields():
            getattr(self.cache, name)[l, :, :, :cap] = src


def run_segment(part: pipeline.Part, layer_fn: Callable, state: Optional[SeqState],
                params: Dict[str, Any], lo: int, hi: int, store: Callable) -> Optional[SeqState]:
    """Layers [lo, hi) through ``layer_fn`` on the stages that hold them
    (``pipeline.run_layers``); each layer's cache parts go to ``store(i,
    parts)`` at the stage's index i = l - part.lo. Returns the state after
    the last layer on the stage that holds it (None on the others)."""
    layer_params = family.of(part.cfg).layer_params

    def body(st: SeqState, l: int) -> SeqState:
        guards.at(f"prefill layer {l}")
        st, parts, _ = layer_fn(st, layer_params(params, l - part.lo), l)
        store(l - part.lo, parts)
        return st

    return pipeline.run_layers(part, lo, hi, state, body, SeqState)


def last_token_logits(params: Dict[str, Any], cfg: ModelConfig, state: SeqState,
                      tp=None) -> torch.Tensor:
    """The LM head over the last valid token of each example -> [b, V] float32."""
    last_idx = torch.clamp(state.count - 1, min=0)[:, None]
    guards.at("the LM head")
    return head_logits(params, cfg, selection.gather_tokens(state.h, last_idx), tp)


def head_logits(params: Dict[str, Any], cfg: ModelConfig, h_last: torch.Tensor,
                tp=None) -> torch.Tensor:
    """The LM head over h_last [b, 1, D] -> [b, V] float32."""
    logits = llama.unembed(params, cfg, h_last, tp)[:, 0, :]
    guards.finite("logits", logits)
    return logits


def prefill(
    params: Dict[str, Any],
    cfg: ModelConfig,
    mcfg: MethodConfig,
    shapes: PrefillShapes,
    tokens: torch.Tensor,  # [b, bucket] right-padded
    n_true: torch.Tensor,  # [b] int32
    ecfg: Optional[EngineConfig] = None,  # fuse_window_scores, kv_int8; PyramidInfer's
    # capacity_align
    pcfg=None,  # ParallelConfig: sp_mode 'ring'/'ulysses' with seq > 1 shards the
    # sequence of the pre-TSP segment over the mesh's seq group
    mesh=None,  # parallel.sharding.Mesh: needed with sequence parallelism; its model
    # and pipe axes split the heads and the layers (the params are this rank's shard)
) -> Tuple[torch.Tensor, KVCache]:
    """Run the full prefill; returns (last-token logits [b, V] float32, cache).
    ``cfg`` is the whole model's. Over a mesh every rank of a data replica
    passes the same tokens (the rows of its replica) and gets the same
    logits; the cache is the rank's: the whole sequence's kept entries, its
    model rank's cache heads, its stage's layers."""
    if mcfg.method == Method.PYRAMIDINFER:
        from fastkv_tpu_torch.engine import pyramid

        return pyramid.prefill(params, cfg, mcfg, ecfg or EngineConfig(), shapes, tokens, n_true,
                               mesh=mesh)
    sp = pcfg is not None and pcfg.sp_mode != "none" and pcfg.seq > 1
    b, s = tokens.shape
    if s != shapes.bucket:
        raise ValueError(f"tokens length {s} != bucket {shapes.bucket}")
    part = pipeline.part(cfg, mesh)
    lcfg, tp = part.cfg, part.tp
    dev = tokens.device
    positions = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
    valid = positions < n_true[:, None]
    shard = None
    if sp:
        if mesh is None:
            raise ValueError("sequence-parallel prefill needs the mesh")
        if s % mesh.seq:
            raise ValueError(f"bucket {s} does not split over {mesh.seq} seq ranks")
        shard = SeqShard(mesh, sp_attend_fn(lcfg, pcfg, mesh), positions, valid)
        lo = mesh.seq_index * (s // mesh.seq)
        sl = slice(lo, lo + s // mesh.seq)
        tokens, positions, valid = tokens[:, sl], positions[:, sl], valid[:, sl]
    state = None
    if part.stage == 0:
        state = SeqState(h=llama.embed(params, lcfg, tokens), positions=positions, valid=valid,
                         count=n_true, n_orig=n_true)
    L = cfg.num_layers
    store = StackedCache(part.num_layers, shapes.decode_capacity)
    kw = dict(ecfg=ecfg, tp=tp)
    if mcfg.method == Method.FASTKV:
        t = mcfg.tsp_idx
        if not 0 <= t < L:
            raise ValueError(f"tsp_idx {t} is not a layer of a {L}-layer model")
        fn_a = make_layer_fn(lcfg, mcfg, shapes, is_post_tsp=False, shard=shard, **kw)
        fn_t = make_layer_fn(lcfg, mcfg, shapes, is_post_tsp=False, want_tsp=True, shard=shard,
                             **kw)

        def fn_t_gather(st: SeqState, lp, l: int):
            """The TSP layer, then the token gather: the stage that holds it
            hands the reduced sequence on."""
            st, parts, tsp = fn_t(st, lp, l)
            if shard is not None:  # the post-TSP segment runs whole on every rank
                st = shard.whole(st)._replace(h=comm.all_gather(st.h, mesh.seq_group, dim=1))
            return tsp_gather(st, tsp), parts, None

        fn_b = make_layer_fn(lcfg, mcfg, shapes, is_post_tsp=True, **kw)
        with profiling.span("prefill.segment_a", device=True, rows=shapes.bucket):
            state = run_segment(part, fn_a, state, params, 0, t, store)
        with profiling.span("prefill.tsp", device=True, tsp_capacity=shapes.tsp_capacity):
            state = run_segment(part, fn_t_gather, state, params, t, t + 1, store)
        with profiling.span("prefill.segment_b", device=True, rows=shapes.tsp_capacity):
            state = run_segment(part, fn_b, state, params, t + 1, L, store)
            logits = None if state is None else last_token_logits(params, lcfg, state, tp)
    else:
        fn = make_layer_fn(lcfg, mcfg, shapes, is_post_tsp=False, shard=shard, **kw)
        with profiling.span("prefill.layers", device=True):
            state = run_segment(part, fn, state, params, 0, L, store)
            logits = None
            if state is not None and shard is not None:
                guards.at("the LM head")
                logits = head_logits(params, lcfg, _sp_last_hidden(state.h, n_true, mesh), tp)
            elif state is not None:
                logits = last_token_logits(params, lcfg, state, tp)
    [logits] = part.share(part.pipe - 1, None if logits is None else [logits], dev)
    return logits, store.cache
