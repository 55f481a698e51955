"""The collectives of sequence-parallel prefill, written out.

The JAX package leaves its collectives to XLA's partitioner; here each one is
a ``torch.distributed`` call on a process group of ``parallel.sharding``:

  * ``ring_shift``: each rank sends tensors to the next rank of its group and
    receives the previous rank's (ring attention's K/V rotation), as one
    batch of point-to-point operations (blocking sends in a ring deadlock);
  * ``all_gather``: every rank's tensor, concatenated along a dim in the
    group's rank order;
  * ``all_to_all``: a tensor split along one dim, piece j to rank j, the
    received pieces concatenated along another dim (Ulysses' resharding).

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

from typing import List, Sequence

import torch
import torch.distributed as dist


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
