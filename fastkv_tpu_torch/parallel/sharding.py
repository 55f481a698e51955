"""The mesh of sequence-parallel prefill: ``data`` x ``seq`` over the ranks of
an initialised process group.

Port of ``fastkv_tpu/parallel/sharding.py::make_mesh`` for the axes the port
runs. The JAX package reshapes its devices to (data, model, seq, pipe,
expert); with model = pipe = expert = 1 that puts global rank
``d * seq + s`` at data replica d and sequence place s, and so does this
mesh. Each data replica is one ``seq`` group (its ranks in sequence order:
rank s of it holds the s-th slice of the prompt); the ranks at one sequence
place across the replicas form a ``data`` group, over which the Engine
gathers the replicas' tokens. Nothing is implicit: every collective names
one of these groups (``parallel.comm``).

Each rank's device is explicit: ``cuda:<rank % cards>`` by default on a
machine with cards, or what the caller passes (``cpu`` in the tests; one
card shared by every rank under gloo in the smoke run). The tensor- and
pipeline-parallel specs (``param_pspecs``, ``cache_pspec``,
``shard_params``) are not ported yet (``core.config.PARALLEL_TODO``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from fastkv_tpu_torch.core.config import ParallelConfig
from fastkv_tpu_torch.core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on the data x seq mesh and the groups it talks over."""

    pcfg: ParallelConfig
    rank: int  # global rank
    device: torch.device
    data_index: int  # which data replica
    seq_index: int  # which slice of the sequence
    seq_group: object  # the ranks of this replica, in sequence order
    seq_ranks: Tuple[int, ...]
    data_group: object  # the ranks at this sequence place, one per replica
    data_ranks: Tuple[int, ...]

    @property
    def seq(self) -> int:
        return self.pcfg.seq

    @property
    def data(self) -> int:
        return self.pcfg.data

    def batch_rows(self, b: int) -> slice:
        """The rows of a batch of ``b`` that this rank's data replica runs."""
        if b % self.data:
            raise ValueError(f"batch {b} does not split over {self.data} data replicas")
        n = b // self.data
        return slice(self.data_index * n, (self.data_index + 1) * n)


def make_mesh(pcfg: ParallelConfig, device: Optional[object] = None) -> Mesh:
    """The mesh over the ranks of the default process group, whose size must
    be ``pcfg.num_devices``. Every rank calls it, in the same order as any
    other group creation (``dist.new_group`` is collective)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed process group")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != pcfg.num_devices:
        raise ValueError(f"the process group has {world} ranks, the mesh {pcfg.num_devices}")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run the mesh on "
                               "the CPU")
        device = f"cuda:{rank % torch.cuda.device_count()}"
    dev = resolve_device(device)
    d_idx, s_idx = divmod(rank, pcfg.seq)
    seq_group = data_group = None
    seq_ranks = data_ranks = ()
    for d in range(pcfg.data):  # every rank creates every group, in one order
        ranks = tuple(d * pcfg.seq + s for s in range(pcfg.seq))
        g = dist.new_group(list(ranks))
        if d == d_idx:
            seq_group, seq_ranks = g, ranks
    for s in range(pcfg.seq):
        ranks = tuple(d * pcfg.seq + s for d in range(pcfg.data))
        g = dist.new_group(list(ranks))
        if s == s_idx:
            data_group, data_ranks = g, ranks
    return Mesh(pcfg, rank, dev, d_idx, s_idx, seq_group, seq_ranks, data_group, data_ranks)
