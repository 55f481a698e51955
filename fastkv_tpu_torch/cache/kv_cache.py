"""Static-shape compressed KV cache.

Port of ``fastkv_tpu.cache.kv_cache``. Layout, stacked across layers exactly
as in the JAX package:

    k, v   : [L, b, CH, C_total, d]   CH = cache heads (kv heads for FastKV/FullKV)
             DeepSeek-V2 (MLA): CH = 1, k the normed latents [.., R], v the
             roped shared keys [.., r]: R + r values a token, no second copy
    pos    : [L, b, CH, C_total] int32  original position ids of cached tokens
    valid  : [L, b, CH, C_total] bool   slot validity
    k_scale, v_scale : [L, b, CH, C_total] float32, with an int8 k/v
                                        (``EngineConfig.kv_int8``); else None

    C_total = prefill_capacity + decode_capacity.

Prefill writes its keep-set into slots [0, prefill_capacity) of each layer;
rank-masked slots stay invalid. Decode writes token t at the static slot
prefill_capacity + t. Both write into the one buffer in place, so neither
prefill's per-layer results nor a decode step ever copy the cache.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

Slot = Union[int, torch.Tensor]  # one slot for every example, or a [b] tensor of one each


class KVCache(NamedTuple):
    """The stacked cache; prefill also hands one layer's parts around in it,
    without the leading L axis."""

    k: torch.Tensor  # [L, b, CH, C_total, d] (int8 when quantized)
    v: torch.Tensor  # [L, b, CH, C_total, d]
    pos: torch.Tensor  # [L, b, CH, C_total] int32
    valid: torch.Tensor  # [L, b, CH, C_total] bool
    # int8 mode: per-(head, slot) absmax scales (core.quant.quantize_kv)
    k_scale: Optional[torch.Tensor] = None  # [L, b, CH, C_total] float32
    v_scale: Optional[torch.Tensor] = None

    def fields(self):
        """(name, tensor) of every field that is set."""
        return [(n, t) for n, t in zip(self._fields, self) if t is not None]


def empty_cache(
    num_layers: int,
    batch: int,
    cache_heads: int,
    capacity: int,
    head_dim: int,
    dtype=torch.bfloat16,
    device="cuda",
    kv_int8: bool = False,
    v_dim: Optional[int] = None,
) -> KVCache:
    """A zeroed cache; with ``kv_int8`` K/V are int8 (``dtype`` is ignored)
    and the scale planes exist. ``v_dim``: v's width where it is not
    ``head_dim`` (MLA's rope key)."""
    shape = (num_layers, batch, cache_heads, capacity, head_dim)
    if kv_int8:
        dtype = torch.int8

    def plane(dt):
        return torch.zeros(shape[:-1], dtype=dt, device=device)

    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape[:-1] + (v_dim or head_dim,), dtype=dtype, device=device),
        pos=plane(torch.int32),
        valid=plane(torch.bool),
        k_scale=plane(torch.float32) if kv_int8 else None,
        v_scale=plane(torch.float32) if kv_int8 else None,
    )


def write_slot(dst: torch.Tensor, src, slot: Slot, rows: Optional[torch.Tensor] = None) -> None:
    """dst [b, CH, C, ...] <- src [b, CH, ...] at cache slot ``slot``: an int
    for every example, or a [b] tensor of one slot per example. The per-example
    write indexes a [b, C, CH, ...] view with two adjacent index tensors, so the
    indexed axes stay where they are (indices split by a slice would move them
    to the front): ``rows``, arange(b), made here unless the caller passes it."""
    if isinstance(slot, int):
        dst[:, :, slot] = src
    else:
        if rows is None:
            rows = torch.arange(dst.shape[0], device=dst.device)
        dst.transpose(1, 2)[rows, slot] = src
