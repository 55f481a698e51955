"""Plain attention ops and score pooling.

Port of the reference paths of ``fastkv_tpu.ops.attention``. These are the
plain PyTorch versions that the hand-written kernels
(``fastkv_tpu_torch.ops.flash_prefill``, ``fastkv_tpu_torch.ops.decode_attn``)
are held against; on the CPU the kernels' wrappers run them.

Conventions:
  q:   [b, num_heads, s_q, d]
  k,v: [b, cache_heads, s_k, d]   cache_heads divides num_heads
  positions: original token position ids (TSP keeps original positions)
  logits and softmax in float32; probabilities are cast to V's dtype before P.V
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _grouped_qk(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """QK^T with GQA grouping. Returns [b, num_heads, s_q, s_k] float32 logits."""
    b, h, sq, d = q.shape
    kh = k.shape[1]
    qg = q.reshape(b, kh, h // kh, sq, d).to(torch.float32)
    logits = torch.matmul(qg, k.to(torch.float32)[:, :, None].transpose(-1, -2))
    return logits.reshape(b, h, sq, k.shape[2])


def _grouped_pv(p: torch.Tensor, v: torch.Tensor, out_dtype) -> torch.Tensor:
    """probs @ V with GQA grouping. p: [b, h, s_q, s_k] float32 -> [b, h, s_q, d]."""
    b, h, sq, sk = p.shape
    kh = v.shape[1]
    pg = p.reshape(b, kh, h // kh, sq, sk).to(v.dtype).to(torch.float32)
    out = torch.matmul(pg, v.to(torch.float32)[:, :, None])
    return out.reshape(b, h, sq, v.shape[3]).to(out_dtype)


def masked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Softmax attention with an explicit boolean mask [b, 1|h, s_q, s_k].

    True = attend. float32 softmax. Rows that are fully masked give zeros.
    ``scale`` multiplies the logits (default d^-0.5); v may be narrower
    than q and k.
    """
    logits = _grouped_qk(q, k) * (q.shape[-1] ** -0.5 if scale is None else scale)
    logits = logits.masked_fill(~mask, NEG_INF)
    m = torch.amax(logits, dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    p = e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    p = torch.where(mask.any(dim=-1, keepdim=True), p, 0.0)
    return _grouped_pv(p, v, q.dtype)


def causal_mask_from_positions(
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    k_valid: torch.Tensor,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Causal + validity (+ sliding window) mask from original position ids.

    q_pos: [b, s_q]; k_pos: [b, s_k]; k_valid: [b, s_k] bool -> [b, 1, s_q, s_k].
    Token-selected sequences carry original (non-contiguous) position ids, so
    causality is defined on positions, not indices.
    """
    qp = q_pos[:, :, None]
    kp = k_pos[:, None, :]
    mask = (kp <= qp) & k_valid[:, None, :]
    if sliding_window is not None:
        mask = mask & (kp > qp - sliding_window)
    return mask[:, None]


def h2o_scores(
    q: torch.Tensor,
    k: torch.Tensor,
    k_valid: torch.Tensor,
    n_true: torch.Tensor,
    window_size: int,
    row_block: int = 2048,
    row_offset: int = 0,
) -> torch.Tensor:
    """H2O accumulated attention mass over row blocks, O(row_block * s) memory.

    The reference's semantics: the whole s x s QK^T is softmaxed with only the
    window-corner mask (a column later than its row is masked only when both
    lie in the last ``window_size`` of the true length; every other row is
    softmaxed over all columns, non-causally), then each column is summed
    over all rows. Invalid (bucket-padding) columns never receive mass, rows
    past the true length contribute 0, and the window and invalid columns of
    the result are 0. Positions are layout indices (H2O runs no TSP).

    One block's float32 logits [b, H, row_block, s] are the only large
    temporary: scaling, masking, the softmax and the row mask run in place.
    The JAX package's pad to 16384 columns at s = 8192 (a TPU schedule
    workaround with equal results) is left out.

    q [b, H, s, d], k [b, KH, s, d], k_valid [b, s], n_true [b] ->
    scores [b, H, s] float32. Under sequence parallelism q holds a rank's
    rows from ``row_offset`` on (k every key): the masks take each row's
    absolute index, and the result is that rank's share of the column sums.
    """
    b, h, sq, d = q.shape
    sk = k.shape[2]
    dev = q.device
    n = n_true.to(torch.int64)[:, None]  # [b, 1]
    col = torch.arange(sk, device=dev)[None, :]
    col_in_window = col >= n - window_size  # [b, sk]
    acc = torch.zeros((b, h, sk), dtype=torch.float32, device=dev)
    for r0 in range(0, sq, row_block):
        rows = row_offset + torch.arange(r0, min(r0 + row_block, sq), device=dev)[None, :]
        logits = _grouped_qk(q[:, :, r0:r0 + row_block], k).mul_(d ** -0.5)  # [b, h, rb, sk]
        row_in_window = rows >= n - window_size  # [b, rb]
        illegal = (row_in_window[:, :, None] & col_in_window[:, None, :]
                   & (col[:, None, :] > rows[:, :, None]))
        logits.masked_fill_((illegal | ~k_valid[:, None, :])[:, None], NEG_INF)
        logits.sub_(torch.amax(logits, dim=-1, keepdim=True)).exp_()
        logits.div_(torch.clamp(logits.sum(dim=-1, keepdim=True), min=1e-30))
        logits.masked_fill_(~(rows < n)[:, None, :, None], 0.0)
        acc.add_(logits.sum(dim=-2))
        del logits  # else it lives on while the next block's logits are made
    col_keep = k_valid & ~col_in_window
    return acc.masked_fill_(~col_keep[:, None, :], 0.0)


def chunked_causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    k_valid: torch.Tensor,
    sliding_window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal attention over query blocks: O(s * q_block) memory for the logits."""
    b, h, sq, d = q.shape
    # cap the float32 logits block [b, h, q_block, s_k] near 512 MB
    budget = 512 * 1024 * 1024 // (max(b * h * k.shape[2], 1) * 4)
    q_block = max(128, min(1024, budget))
    outs = []
    for i in range(0, sq, q_block):
        mask = causal_mask_from_positions(
            q_pos[:, i:i + q_block], k_pos, k_valid, sliding_window)
        outs.append(masked_attention(q[:, :, i:i + q_block], k, v, mask, scale))
    return torch.cat(outs, dim=2)


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    valid: torch.Tensor,
    q_pos: Optional[torch.Tensor] = None,
    k_pos: Optional[torch.Tensor] = None,
    sliding_window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-token attention over the compressed cache.

    q: [b, H, 1, d]; k_cache/v_cache: [b, CH, C, d]; valid: [b, C] or [b, CH, C].
    Every valid cache entry precedes the query. A row with no visible slot
    gives 0. Under ``sliding_window`` W a slot is also visible only if
    ``k_pos > q_pos - W`` (q_pos [b], k_pos [b, CH, C] int32). An int8 cache
    comes with ``k_scale``/``v_scale`` [b, CH, C] float32: K's scales multiply
    the logit columns, V's the softmax probabilities (before they are cast to
    q's dtype), as the JAX package folds them, so no dequantized copy exists.
    """
    b, H, _, d = q.shape
    ch = k_cache.shape[1]
    if valid.dim() == 2:
        valid = valid[:, None, :]
    mask = valid
    if sliding_window is not None:
        if q_pos is None or k_pos is None:
            raise ValueError("decode_attention: sliding_window needs q_pos and k_pos")
        mask = mask & (k_pos > (q_pos[:, None, None] - sliding_window))
    qg = q.reshape(b, ch, H // ch, d).to(torch.float32)
    kf = k_cache.to(q.dtype).to(torch.float32)
    logits = torch.matmul(qg, kf.transpose(-1, -2)) * (d ** -0.5)
    if k_scale is not None:
        logits = logits * k_scale[:, :, None, :]
    logits = logits.masked_fill(~mask[:, :, None, :], NEG_INF)
    p = torch.softmax(logits, dim=-1)
    p = torch.where(mask.any(dim=-1)[:, :, None, None], p, 0.0)
    if v_scale is not None:
        p = p * v_scale[:, :, None, :]
    out = torch.matmul(p.to(q.dtype).to(torch.float32), v_cache.to(q.dtype).to(torch.float32))
    return out.reshape(b, H, 1, d).to(q.dtype)


def pool_scores(
    scores: torch.Tensor, valid: torch.Tensor, kernel_size: int, pooling: str
) -> torch.Tensor:
    """1-D pooling over the key axis with stride 1 and padding kernel_size//2.

    avgpool divides by kernel_size always (``count_include_pad=True``, zero
    padding); maxpool pads with -inf. ``valid`` masks bucket-padding columns so
    they behave exactly like the out-of-range padding.
    scores: [b, h, s] float32; valid: [b, s] bool. Invalid outputs are NOT masked.
    """
    v = valid[:, None, :]
    pad = kernel_size // 2
    if pooling == "avgpool":
        x = torch.where(v, scores, 0.0)
        return F.avg_pool1d(x, kernel_size, stride=1, padding=pad, count_include_pad=True)
    if pooling == "maxpool":
        x = torch.where(v, scores, float("-inf"))
        return F.max_pool1d(x, kernel_size, stride=1, padding=pad)
    raise ValueError(f"pooling {pooling!r} not supported")
