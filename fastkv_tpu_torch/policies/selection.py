"""Token-selection primitives shared by the eviction policies.

Port of ``fastkv_tpu.policies.selection``. Top-k always runs at the *static*
capacity; the per-example budget only drives a rank-validity mask, so the
selection is exact for any true length.
"""

from __future__ import annotations

from typing import Tuple

import torch

from fastkv_tpu_torch.utils import guards

BIG_INDEX = 2**30


def topk_select(
    scores: torch.Tensor,
    selectable: torch.Tensor,
    k_budget: torch.Tensor,
    capacity: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k selection with a per-example budget under a static capacity.

    scores:      [b, ch, s] float32 (higher = keep)
    selectable:  [b, s] bool: columns eligible for selection (non-window, valid)
    k_budget:    [b] int: how many of the top-capacity picks are real
    capacity:    static int >= max(k_budget)

    Returns (indices [b, ch, capacity] int64, valid [b, ch, capacity] bool).
    Indices of invalid slots are 0; callers must apply ``valid``.

    Ties go to the lower index, as ``lax.top_k`` orders them: the first
    ``capacity`` entries of a *stable* descending sort. ``torch.topk`` orders
    ties differently, and maxpool plateaus make ties at the boundary common.
    """
    masked = torch.where(selectable[:, None, :], scores, float("-inf"))
    idx = torch.sort(masked, dim=-1, descending=True, stable=True).indices[..., :capacity]
    rank = torch.arange(capacity, device=scores.device)[None, None, :]
    n_selectable = selectable.sum(dim=-1)
    k_eff = torch.minimum(k_budget.to(n_selectable.dtype), n_selectable)[:, None, None]
    valid = (rank < k_eff).expand(idx.shape)
    return torch.where(valid, idx, 0), valid


def group_sum(scores: torch.Tensor, num_groups: int) -> torch.Tensor:
    """Sum per-query-head scores into per-kv-head scores (query head h maps to
    kv head h // num_groups). scores [b, H, s] -> [b, H // num_groups, s]."""
    b, h, s = scores.shape
    return scores.reshape(b, h // num_groups, num_groups, s).sum(dim=2)


def sorted_union_indices(
    select_mask: torch.Tensor, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Boolean keep-mask [b, s] -> position-sorted indices [b, capacity].

    Selected indices come out ascending; invalid slots point at 0 with
    valid=False (selected columns sort before the 2^30 sentinel).
    """
    s = select_mask.shape[-1]
    iota = torch.arange(s, device=select_mask.device)[None, :]
    keyed = torch.where(select_mask, iota, BIG_INDEX)
    srt = torch.sort(keyed, dim=-1).values[:, :capacity]
    valid = srt < BIG_INDEX
    return torch.where(valid, srt, 0), valid


def gather_tokens(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather along the sequence axis.

    x [b, s, D] / [b, s] / [b, ch, s, d]; idx [b, k] / [b, k] / [b, ch, k].
    """
    guards.in_bounds("gather", idx, x.shape[2 if x.dim() == 4 else 1])
    idx = idx.long()
    if x.dim() == 3 and idx.dim() == 2:
        return torch.gather(x, 1, idx[:, :, None].expand(-1, -1, x.shape[2]))
    if x.dim() == 2 and idx.dim() == 2:
        return torch.gather(x, 1, idx)
    if x.dim() == 4 and idx.dim() == 3:
        return torch.gather(x, 2, idx[..., None].expand(-1, -1, -1, x.shape[3]))
    raise ValueError(f"unsupported gather ranks {tuple(x.shape)} / {tuple(idx.shape)}")


def window_indices(
    window_start: torch.Tensor, window_size: int, n_valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of the observation window [start, start + W), start clamped at 0.

    Returns (idx [b, W] int64, valid [b, W]); slots past n_valid are invalid.
    """
    w = torch.arange(window_size, device=window_start.device)[None, :]
    idx = torch.clamp(window_start, min=0)[:, None].long() + w
    valid = idx < n_valid[:, None]
    return torch.where(valid, idx, 0), valid
