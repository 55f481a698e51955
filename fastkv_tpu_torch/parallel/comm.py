"""The collectives of the mesh, written out.

The JAX package leaves its collectives to XLA's partitioner; here each one is
a ``torch.distributed`` call on a process group of ``parallel.sharding``:

  * ``ring_shift``: each rank sends tensors to the next rank of its group and
    receives the previous rank's (ring attention's K/V rotation), as one
    batch of point-to-point operations (blocking sends in a ring deadlock);
  * ``all_gather``: every rank's tensor, concatenated along a dim in the
    group's rank order;
  * ``all_to_all``: a tensor split along one dim, piece j to rank j, the
    received pieces concatenated along another dim (Ulysses' resharding);
  * ``all_sum``: the sum of every rank's tensor (tensor parallelism's
    row-parallel products), as an all-gather of the partials and a fold in
    the group's rank order, so every rank holds bit-identical sums (an
    all-reduce may add in another order on each rank, and ranks that pick
    tokens from sums that differ in the last bit drift apart);
  * ``send`` / ``recv``: tensors from one rank to another (the pipeline's
    hand-off between stages), and ``broadcast``: tensors from one rank to
    every rank of a group; each carries a header with the tensors' dtypes
    and shapes, so the receivers need not know them.

One transport carries them. Under NCCL it passes device tensors as they are.
Under gloo, which has no CUDA point-to-point, gather or all-to-all, a CUDA
tensor is staged through pinned host memory for the wire and copied back
onto its device: only the bytes travel through the host; every operation on
them stays on the device. That is what lets two ranks share one card (NCCL
refuses two ranks on one device), and it is how the CPU tests run (CPU
tensors go over gloo directly). Tensors travel as their bytes (a uint8
view), so every dtype and bool goes over every backend.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

# the dtypes a header can name, by index
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.int32, torch.int64, torch.bool,
           torch.int8, torch.uint8)
_HEADER = 64  # int64 slots: the tensor count, then per tensor its dtype, rank and dims


def _staged(group, t: torch.Tensor) -> bool:
    return t.device.type == "cuda" and dist.get_backend(group) != dist.Backend.NCCL


def _wire(group, t: torch.Tensor) -> torch.Tensor:
    """t's bytes, flat, on the device the group's backend sends from."""
    flat = t.contiguous().reshape(-1).view(torch.uint8)
    if not _staged(group, t):
        return flat
    host = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
    host.copy_(flat)  # synchronous: the bytes are on the host before the send
    return host


def _buffer(group, like: torch.Tensor, numel_bytes: int) -> torch.Tensor:
    if _staged(group, like):
        return torch.empty((numel_bytes,), dtype=torch.uint8, pin_memory=True)
    return torch.empty((numel_bytes,), dtype=torch.uint8, device=like.device)


def _unwire(buf: torch.Tensor, like: torch.Tensor, shape) -> torch.Tensor:
    """A tensor of ``like``'s dtype and device and the given shape from bytes."""
    return buf.to(like.device).view(like.dtype).reshape(shape)


def ring_shift(tensors: Sequence[torch.Tensor], group, ranks: Sequence[int],
               index: int) -> List[torch.Tensor]:
    """Send each tensor to rank ``ranks[index + 1]`` (cyclically) and receive
    the same-shaped tensors of ``ranks[index - 1]``. ``ranks`` are the global
    ranks of ``group`` in order, ``index`` this rank's place among them."""
    p = len(ranks)
    if p == 1:
        return list(tensors)
    nxt, prv = ranks[(index + 1) % p], ranks[(index - 1) % p]
    sends = [_wire(group, t) for t in tensors]
    recvs = [_buffer(group, t, s.numel()) for t, s in zip(tensors, sends)]
    ops = []
    for s, r in zip(sends, recvs):
        ops.append(dist.P2POp(dist.isend, s, nxt, group))
        ops.append(dist.P2POp(dist.irecv, r, prv, group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [_unwire(r, t, t.shape) for r, t in zip(recvs, tensors)]


def all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``t`` (same shape on each), concatenated along ``dim`` in
    the group's rank order."""
    p = dist.get_world_size(group)
    if p == 1:
        return t
    send = _wire(group, t)
    bufs = [_buffer(group, t, send.numel()) for _ in range(p)]
    dist.all_gather(bufs, send, group=group)
    return torch.cat([_unwire(b, t, t.shape) for b in bufs], dim=dim)


def all_to_all(t: torch.Tensor, group, ranks: Sequence[int], index: int, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """Split ``t`` into len(ranks) equal pieces along ``split_dim``, send
    piece j to ``ranks[j]``, and concatenate the pieces received (in rank
    order) along ``concat_dim``."""
    p = len(ranks)
    if p == 1:
        return t
    if t.shape[split_dim] % p:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(t.shape)} does not split "
                         f"{p} ways")
    pieces = list(torch.chunk(t, p, dim=split_dim))
    shape = pieces[0].shape
    sends = [_wire(group, x) for x in pieces]
    recvs = [_buffer(group, pieces[0], sends[0].numel()) for _ in range(p)]
    recvs[index] = sends[index]
    ops = []
    for j, peer in enumerate(ranks):
        if j != index:
            ops.append(dist.P2POp(dist.isend, sends[j], peer, group))
            ops.append(dist.P2POp(dist.irecv, recvs[j], peer, group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return torch.cat([_unwire(r, t, shape) for r in recvs], dim=concat_dim)


def all_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t`` (same shape on each), folded in the
    group's rank order in float32 and returned in ``t``'s dtype: the same
    bits on every rank."""
    p = dist.get_world_size(group)
    if p == 1:
        return t
    parts = all_gather(t[None], group, dim=0)
    acc = parts[0].to(torch.float32)
    for j in range(1, p):
        acc = acc + parts[j]
    return acc.to(t.dtype)


def _header(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    head = [len(tensors)]
    for t in tensors:
        head += [_DTYPES.index(t.dtype), t.dim(), *t.shape]
    if len(head) > _HEADER:
        raise ValueError(f"{len(tensors)} tensors of ranks {[t.dim() for t in tensors]} "
                         f"overflow the {_HEADER}-slot header")
    return torch.tensor(head + [0] * (_HEADER - len(head)), dtype=torch.int64)


def _specs(head: torch.Tensor):
    vals, specs, i = head.tolist(), [], 1
    for _ in range(vals[0]):
        dtype, ndim = _DTYPES[vals[i]], vals[i + 1]
        specs.append((dtype, tuple(vals[i + 2:i + 2 + ndim])))
        i += 2 + ndim
    return specs


def _on(group, t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on the device a group's backend sends from."""
    if dist.get_backend(group) == dist.Backend.NCCL:
        return t.to(device)
    return t


def _like(dtype, device) -> torch.Tensor:
    """An empty tensor that stands for a received one's dtype and device."""
    return torch.empty((0,), dtype=dtype, device=device)


def send(tensors: Sequence[torch.Tensor], dst: int, group) -> None:
    """Send ``tensors`` to global rank ``dst`` of ``group`` (``recv`` takes
    them), header first."""
    dev = tensors[0].device
    dist.send(_on(group, _header(tensors), dev), dst, group)
    for t in tensors:
        dist.send(_wire(group, t), dst, group)


def recv(src: int, group, device) -> List[torch.Tensor]:
    """The tensors global rank ``src`` sent (``send``), on ``device``."""
    head = _on(group, torch.empty(_HEADER, dtype=torch.int64), device)
    dist.recv(head, src, group)
    out = []
    for dtype, shape in _specs(head.cpu()):
        like = _like(dtype, device)
        buf = _buffer(group, like, math.prod(shape) * dtype.itemsize)
        dist.recv(buf, src, group)
        out.append(_unwire(buf, like, shape))
    return out


def broadcast(tensors: Optional[Sequence[torch.Tensor]], src: int, group,
              device) -> List[torch.Tensor]:
    """``tensors`` of global rank ``src`` on every rank of ``group`` (the
    others pass None), on ``device``."""
    mine = tensors is not None
    head = _header(tensors) if mine else torch.empty(_HEADER, dtype=torch.int64)
    head = _on(group, head, device)
    dist.broadcast(head, src, group)
    if mine:
        for t in tensors:
            dist.broadcast(_wire(group, t), src, group)
        return list(tensors)
    out = []
    for dtype, shape in _specs(head.cpu()):
        like = _like(dtype, device)
        buf = _buffer(group, like, math.prod(shape) * dtype.itemsize)
        dist.broadcast(buf, src, group)
        out.append(_unwire(buf, like, shape))
    return out
