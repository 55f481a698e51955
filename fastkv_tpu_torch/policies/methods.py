"""Per-method eviction policies over (scores, layout, budgets).

Port of the score-based, StreamingLLM and FullKV parts of
``fastkv_tpu.policies.methods`` (GemFilter's selection is
``engine.gemfilter``). Each policy answers: *which prompt-token
indices does each cache head keep?* The keep-set covers the full kept cache
(selected tokens plus the observation window), so the engine's job is one
gather of K/V/positions.

  * fastkv: pooled window scores, summed over GQA groups per kv head, top-k
    per kv head; the TSP token set is the top-k of the kv-head-summed scores
    plus the window, sorted by position;
  * snapkv: pooled window scores per *query* head, top-k per query head; the
    cache stores repeated kv heads, one per query head;
  * h2o: as snapkv, but on the accumulated attention mass of every query row
    (``ops.attention.h2o_scores``), unpooled;
  * streamingllm: positional, attention sinks plus the recent window, per kv
    head (no scores);
  * fullkv: keep everything.
PyramidInfer's per-layer selection is ``engine.pyramid``'s.

Under tensor parallelism ``cfg`` is a rank's (``parallel.pipeline.Part``):
its heads, whose keep-sets need no other rank's scores (FastKV's group sum
stays inside one kv head's query group, SnapKV and H2O select per query
head). TSP's sum over every kv head is the one cross-head sum: the pooled
per-kv-head scores are gathered over the model group and summed as one
device sums them, so TSP's set does not depend on the mesh.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fastkv_tpu_torch.core.config import Method, MethodConfig, ModelConfig
from fastkv_tpu_torch.ops.attention import pool_scores
from fastkv_tpu_torch.parallel import comm
from fastkv_tpu_torch.policies import selection


class KeepSet(NamedTuple):
    """Kept prompt-token indices per cache head. idx/valid: [b, ch, capacity]."""

    idx: torch.Tensor
    valid: torch.Tensor


class TspSet(NamedTuple):
    """Position-sorted surviving token indices at the TSP layer. [b, tsp_capacity]."""

    idx: torch.Tensor
    valid: torch.Tensor


def cache_heads(method: Method, cfg: ModelConfig) -> int:
    """How many head rows the compressed cache stores for this method."""
    if method in (Method.SNAPKV, Method.H2O):
        return cfg.num_heads  # the reference stores repeated heads for these
    return cfg.num_kv_heads


def score_based_keep(
    method: Method,
    mcfg: MethodConfig,
    cfg: ModelConfig,
    raw_scores: torch.Tensor,  # [b, num_heads, s] float32 window scores
    selectable: torch.Tensor,  # [b, s] bool: non-window & valid columns
    window_idx: torch.Tensor,  # [b, W] observation-window indices
    window_valid: torch.Tensor,  # [b, W]
    k_budget: torch.Tensor,  # [b] non-window keep budget
    keep_capacity: int,  # static capacity for the non-window part
) -> KeepSet:
    """snapkv/h2o/fastkv keep-set: top-k of scores plus the window verbatim."""
    if method == Method.H2O:
        pooled = raw_scores  # H2O applies no pooling
    else:
        pooled = pool_scores(raw_scores, selectable, mcfg.kernel_size, mcfg.pooling)
    if method == Method.FASTKV:
        pooled = selection.group_sum(pooled, cfg.num_kv_groups)
    top_idx, top_valid = selection.topk_select(pooled, selectable, k_budget, keep_capacity)
    b, ch, _ = top_idx.shape
    w = window_idx.shape[-1]
    win_idx = window_idx[:, None, :].expand(b, ch, w)
    win_valid = window_valid[:, None, :].expand(b, ch, w)
    return KeepSet(torch.cat([top_idx, win_idx], dim=-1), torch.cat([top_valid, win_valid], dim=-1))


def fastkv_tsp_set(
    mcfg: MethodConfig,
    cfg: ModelConfig,
    raw_scores: torch.Tensor,  # [b, num_heads, s]
    selectable: torch.Tensor,
    window_idx: torch.Tensor,  # [b, W]
    window_valid: torch.Tensor,
    tsp_budget: torch.Tensor,  # [b] non-window TSP budget
    tsp_capacity: int,
    tp=None,  # the model group: raw_scores holds this rank's heads
) -> TspSet:
    """TSP surviving set = topk(kv-head-summed pooled scores) ∪ window, sorted
    by position."""
    pooled = pool_scores(raw_scores, selectable, mcfg.kernel_size, mcfg.pooling)
    per_kv = selection.group_sum(pooled, cfg.num_kv_groups)
    if tp is not None:  # every kv head's, in the model's head order
        per_kv = comm.all_gather(per_kv, tp, dim=1)
    summed = per_kv.sum(dim=1, keepdim=True)  # [b, 1, s]
    top_idx, top_valid = selection.topk_select(summed, selectable, tsp_budget, tsp_capacity)
    b, s = selectable.shape
    # union as a max-scatter on an int mask: an index that appears as a real
    # pick and as an invalid filler slot (index 0) stays kept
    keep = torch.zeros((b, s), dtype=torch.int32, device=selectable.device)
    keep.scatter_reduce_(1, top_idx[:, 0, :], top_valid[:, 0, :].to(torch.int32), reduce="amax")
    keep.scatter_reduce_(1, window_idx.long(), window_valid.to(torch.int32), reduce="amax")
    idx, valid = selection.sorted_union_indices(keep.bool(), tsp_capacity)
    return TspSet(idx, valid)


def streamingllm_keep(
    mcfg: MethodConfig,
    num_cache_heads: int,
    batch: int,
    n_true: torch.Tensor,  # [b] true segment length
    capacity: int,  # static total capacity
) -> KeepSet:
    """Sinks + recent window, closed form (no scores).

    Proportional: cap = int(n * retain), sinks = the first 4 tokens, the rest
    of cap the most recent ones. Constant: cap = max_capacity_prompt, sinks =
    cap - window_size. When n <= cap everything is kept."""
    dev = n_true.device
    n_true = n_true.to(torch.int32)
    if mcfg.eviction_mode == "proportional":
        cap_dyn = torch.floor(n_true.to(torch.float32) * mcfg.retain_rate).to(torch.int32)
        n_sink = torch.full((batch,), 4, dtype=torch.int32, device=dev)
    else:
        cap_dyn = torch.full((batch,), mcfg.max_capacity_prompt, dtype=torch.int32, device=dev)
        n_sink = torch.full((batch,), mcfg.max_capacity_prompt - mcfg.window_size,
                            dtype=torch.int32, device=dev)
    keep_all = n_true <= cap_dyn
    cap_eff = torch.where(keep_all, n_true, cap_dyn)[:, None]  # [b, 1]
    sink_eff = torch.where(keep_all, n_true, n_sink)[:, None]
    rank = torch.arange(capacity, dtype=torch.int32, device=dev)[None, :]
    # rank < sinks: the leading positions; else the recent tail n - cap + rank
    idx = torch.where(rank < sink_eff, rank, n_true[:, None] - cap_eff + rank)
    valid = rank < cap_eff
    idx = torch.where(valid, idx, 0).long()
    shape = (batch, num_cache_heads, capacity)
    return KeepSet(idx[:, None, :].expand(shape), valid[:, None, :].expand(shape))


def fullkv_keep(
    num_cache_heads: int, batch: int, seq: int, n_true: torch.Tensor
) -> KeepSet:
    """Identity keep-set (capacity = padded seq)."""
    rank = torch.arange(seq, device=n_true.device)[None, None, :]
    idx = rank.expand(batch, num_cache_heads, seq)
    valid = (rank < n_true[:, None, None]).expand(idx.shape)
    return KeepSet(torch.where(valid, idx, 0), valid)
