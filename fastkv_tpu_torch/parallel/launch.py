"""Run a function on every rank of a process group of local processes.

``run_world(fn, world_size, workdir, args)`` spawns ``world_size``
processes; each joins one process group through a ``FileStore`` in
``workdir`` (a fresh directory: no port is claimed, so concurrent worlds do
not collide), calls ``fn(rank, world_size, *args)`` and leaves the group.
A rank that raises makes ``run_world`` raise, after the others are stopped.
The tests run worlds of CPU ranks over gloo; the smoke run on the card runs
ranks that share one card over gloo (``parallel.comm`` stages their tensors).
``fn`` must be importable by name (a module-level function), since the
processes are spawned, not forked.
"""

from __future__ import annotations

import os
import socket
from typing import Callable, Sequence

import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, fn: Callable, world_size: int, store_path: str, backend: str,
               args: Sequence) -> None:
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)
    try:
        fn(rank, world_size, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_world(fn: Callable, world_size: int, workdir: str, args: Sequence = (),
              backend: str = "gloo") -> None:
    # gloo finds its interface from the host name, which a machine without a
    # network may not resolve; the ranks are local, so the loopback serves
    if "GLOO_SOCKET_IFNAME" not in os.environ and any(
            name == "lo" for _, name in socket.if_nameindex()):
        os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    os.makedirs(workdir, exist_ok=True)
    store_path = os.path.join(workdir, "store")
    if os.path.exists(store_path):
        raise FileExistsError(f"{store_path} exists: give every world a fresh directory")
    mp.spawn(_rank_main, args=(fn, world_size, store_path, backend, tuple(args)),
             nprocs=world_size, join=True)
