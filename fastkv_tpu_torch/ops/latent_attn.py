"""Decode attention over a latent (MLA) cache, in plain PyTorch.

DeepSeek-V2's multi-head latent attention caches, per token and layer, one
row: the RMS-normed latent ``c`` [R] and the roped key ``k_pe`` [r] that
every query head shares. Head h's key is [c @ W_UK[h], k_pe] and its value
c @ W_UV[h], where ``kv_b`` = [W_UK | W_UV] per head maps the latent to the
nope key part (n) and the value (v). A decode step need not expand the
cache: with q = [q_nope, q_pe],

    score_j = (q_nope . (c_j W_UK[h]) + q_pe . k_pe_j) * scale
            = ((W_UK[h] q_nope) . c_j + q_pe . k_pe_j) * scale
    out     = sum_j p_j (c_j W_UV[h]) = (sum_j p_j c_j) W_UV[h],

so the query is taken into the latent once (``absorbed``), scored against
the cache rows as they are, and the weighted latent is taken out through
W_UV: 2 (R + r) + 2 R FLOPs a live slot and head instead of expanding
every slot to 2 (n + r) + 2 v values a head. ``expanded`` is the same
attention with every cached row taken through ``kv_b`` first, the form the
absorbed one is held to.

Both run inside the decode step's CUDA graph: static shapes, the mask
``valid`` [b, C] (or [b, 1, C]), logits and softmax in float32, a row that
sees no slot gives 0. The products take the cache's dtype (bf16 on the
card, with float32 sums); the scores are cast to float32 before the mask
and the softmax, the probabilities back to the cache's dtype before P @ c.
No hand kernel: what a step costs here is measured first.
"""

from __future__ import annotations

import torch

from fastkv_tpu_torch.ops.attention import NEG_INF


def _softmax(logits: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Masked float32 softmax over the last axis; 0 in a row with no slot.
    logits [b, H, C] float32, valid [b, C]."""
    logits = logits.masked_fill(~valid[:, None, :], NEG_INF)
    p = torch.softmax(logits, dim=-1)
    return torch.where(valid.any(dim=-1)[:, None, None], p, 0.0)


def _mask(valid: torch.Tensor) -> torch.Tensor:
    return valid[:, 0] if valid.dim() == 3 else valid


def absorbed(
    q: torch.Tensor,  # [b, H, 1, n + r]: the nope part, then the roped part
    latent: torch.Tensor,  # [b, 1, C, R] the cache's normed latents
    k_pe: torch.Tensor,  # [b, 1, C, r] the cache's roped shared keys
    valid: torch.Tensor,  # [b, C] or [b, 1, C]
    w_kv_b: torch.Tensor,  # [R, H * (n + v)]
    v_dim: int,
    scale: float,
) -> torch.Tensor:
    """Absorbed latent attention -> [b, H, 1, v] in q's dtype."""
    b, H, _, qk = q.shape
    R, r = latent.shape[-1], k_pe.shape[-1]
    n = qk - r
    w = w_kv_b.view(R, H, n + v_dim)
    # per head, W_UK[h] [n, R] and W_UV[h] [R, v] as strided views of kv_b
    # (batched over the heads, no copy of the weights)
    w_uk, w_uv = w[..., :n].permute(1, 2, 0), w[..., n:].permute(1, 0, 2)
    q_nope, q_pe = q[:, :, 0, :n], q[:, :, 0, n:]  # [b, H, n], [b, H, r]
    q_lat = torch.matmul(q_nope.transpose(0, 1), w_uk).transpose(0, 1)  # [b, H, R]
    c, kp = latent[:, 0], k_pe[:, 0]  # [b, C, R], [b, C, r]
    logits = (torch.matmul(q_lat, c.transpose(1, 2)).float()
              + torch.matmul(q_pe, kp.transpose(1, 2)).float()) * scale  # [b, H, C]
    p = _softmax(logits, _mask(valid))
    o_lat = torch.matmul(p.to(c.dtype), c)  # [b, H, R]
    out = torch.matmul(o_lat.transpose(0, 1), w_uv).transpose(0, 1)  # [b, H, v]
    return out[:, :, None].to(q.dtype)


def expanded(q, latent, k_pe, valid, w_kv_b, v_dim: int, scale: float) -> torch.Tensor:
    """The same attention with every cached row expanded through ``kv_b``
    to its heads' keys and values first -> [b, H, 1, v]."""
    b, H, _, qk = q.shape
    R, r = latent.shape[-1], k_pe.shape[-1]
    n = qk - r
    C = latent.shape[2]
    kv = (latent[:, 0] @ w_kv_b).view(b, C, H, n + v_dim).transpose(1, 2)  # [b, H, C, n + v]
    k = torch.cat([kv[..., :n], k_pe.expand(b, H, C, r)], dim=-1)
    logits = torch.matmul(q[:, :, 0, None], k.transpose(-1, -2))[:, :, 0].float() * scale
    p = _softmax(logits, _mask(valid))
    out = torch.matmul(p.to(kv.dtype)[:, :, None], kv[..., n:])  # [b, H, 1, v]
    return out.to(q.dtype)
