"""GemFilter: two-pass generation.

Port of ``fastkv_tpu.engine.gemfilter``. The reference's semantics:

  * pass 1 (``select_tokens``): run layers [0, filter_idx) over the whole
    prompt; at the filter layer score every prompt token by the dot product
    of the last valid query row with its key, summed over all query heads
    (each kv head's keys serve its group), avg-pool the scores with kernel 5,
    take the top-k and gather those tokens, sorted by position, from the
    input ids;
  * pass 2: a FullKV prefill of the reduced prompt at the static extent
    ``filter_capacity`` with fresh positions 0..new_count-1 (it is a new,
    shorter prompt), then greedy decode from its cache (``Engine.generate``,
    the Scheduler's admission).

Pass 1 keeps no cache and needs no attention output at the filter layer,
only its q and k (its attention call computes nothing). Every layer before
it attends through the flash kernel's causal square (the model's window, if any).

Over a mesh (``select_tokens(mesh=)``) a rank runs its ``parallel.pipeline.
Part``: pass 1's layers on their stages, its heads; the filter layer's sum
over all heads gathers every kv head's scores over the model group and sums
them as one device does, and the stage that holds the filter layer gives the
selection to every stage.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from fastkv_tpu_torch.core.config import (
    EngineConfig,
    Method,
    MethodConfig,
    ModelConfig,
    round_up,
)
from fastkv_tpu_torch.engine.prefill import PrefillShapes, plan_shapes
from fastkv_tpu_torch.models import family, llama
from fastkv_tpu_torch.ops import flash_prefill
from fastkv_tpu_torch.ops.attention import pool_scores
from fastkv_tpu_torch.parallel import comm, pipeline
from fastkv_tpu_torch.policies import selection
from fastkv_tpu_torch.utils import guards

# the reference's avg-pool width for the filter scores, whatever kernel_size says
POOL_KERNEL = 5


def filter_capacity(mcfg: MethodConfig, bucket: int, align: int = 128) -> int:
    """Static extent of the reduced pass-2 prompt."""
    if mcfg.eviction_mode == "proportional":
        cap = int(bucket * mcfg.retain_rate)
    else:
        cap = mcfg.max_capacity_prompt
    return min(round_up(max(cap, align), align), bucket)


def pass2_config(mcfg: MethodConfig) -> MethodConfig:
    """The method config pass 2 and decode run under: FullKV's."""
    return dataclasses.replace(mcfg, method=Method.FULLKV)


def pass2_shapes(cfg: ModelConfig, mcfg: MethodConfig, ecfg: EngineConfig,
                 bucket: int) -> PrefillShapes:
    """Pass 2's prefill and cache plan for a prompt of ``bucket``: FullKV's at
    the bucket's filter capacity."""
    cap = filter_capacity(mcfg, bucket, ecfg.capacity_align)
    return plan_shapes(cfg, pass2_config(mcfg), ecfg, cap)


def select_tokens(
    params: Dict[str, Any],
    cfg: ModelConfig,
    mcfg: MethodConfig,
    ecfg: EngineConfig,  # mlp_chunk
    tokens: torch.Tensor,  # [b, bucket] right-padded
    n_true: torch.Tensor,  # [b] int32
    capacity: int,
    mesh=None,  # parallel.sharding.Mesh: the params are this rank's shard
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pass 1 -> (new_tokens [b, capacity] int32, right-padded with 0;
    new_count [b] int32; sel_idx [b, capacity], the kept prompt indices,
    ascending, 0 past new_count)."""
    fi = mcfg.filter_idx
    if not 0 <= fi < cfg.num_layers:
        raise ValueError(f"filter_idx {fi} is not a layer of a {cfg.num_layers}-layer model")
    part = pipeline.part(cfg, mesh)
    lcfg, tp = part.cfg, part.tp
    b, s = tokens.shape
    dev = tokens.device
    positions = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(b, s)
    valid = positions < n_true[:, None]

    def attend(q, k, v):
        return flash_prefill.flash_attention(q, k, v, positions, n_true,
                                             sliding_window=cfg.sliding_window), None

    def layer(st, l):
        guards.at(f"GemFilter pass 1 layer {l}")
        h, _, q, k, _, _ = family.prefill_layer(
            family.of(cfg).layer_params(params, l - part.lo), lcfg, st[0], positions,
            (lambda q, k, v: (None, None)) if l == fi else attend, l,
            mlp_chunk=ecfg.mlp_chunk_for(s), tp=tp)
        return select(q, k) if l == fi else (h,)

    def select(q, k):
        """(new_tokens, new_count, sel_idx) from the filter layer's last
        query row."""
        last = torch.clamp(n_true - 1, min=0).long()
        q_last = q[torch.arange(b, device=dev), :, last]  # [b, H, d]
        qg = q_last.reshape(b, lcfg.num_kv_heads, lcfg.num_kv_groups, lcfg.head_dim)
        scores = torch.einsum("bkgd,bksd->bks", qg.to(torch.float32), k.to(torch.float32))
        if tp is not None:  # every kv head's, in the model's head order
            scores = comm.all_gather(scores, tp, dim=1)
        scores = scores.sum(dim=1, keepdim=True)  # [b, 1, s], summed over all heads
        # invalid columns behave like torch's zero padding
        pooled = pool_scores(scores, valid, POOL_KERNEL, "avgpool")

        if mcfg.eviction_mode == "proportional":
            k_budget = torch.floor(n_true.to(torch.float32) * mcfg.retain_rate).to(torch.int32)
        else:
            k_budget = torch.full_like(n_true, mcfg.max_capacity_prompt)
        k_budget = torch.minimum(k_budget, n_true)
        top_idx, top_valid = selection.topk_select(pooled, valid, k_budget, capacity)
        keep = torch.zeros((b, s), dtype=torch.int32, device=dev)
        keep.scatter_reduce_(1, top_idx[:, 0, :], top_valid[:, 0, :].to(torch.int32),
                             reduce="amax")
        sel_idx, sel_valid = selection.sorted_union_indices(keep.bool(), capacity)
        new_tokens = torch.where(sel_valid, torch.gather(tokens, 1, sel_idx), 0)
        return new_tokens, sel_valid.sum(dim=-1).to(torch.int32), sel_idx

    h0 = (llama.embed(params, cfg, tokens),) if part.stage == 0 else None
    out = pipeline.run_layers(part, 0, fi + 1, h0, layer)
    new_tokens, new_count, sel_idx = part.share(part.stage_of(fi), out, dev)
    return new_tokens, new_count, sel_idx
