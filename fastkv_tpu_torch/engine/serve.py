"""Serving front door over Scheduler replicas, and the multi-process entry.

Port of ``fastkv_tpu.engine.serve``:

  * ``FrontDoor``: requests go to the least-loaded of N ``Scheduler``
    replicas; each replica drains its queue on a thread of its own.
  * Failure detection and re-admission: a replica whose drain raises (a
    kernel that fails to build or launch, out of memory, an injected fault)
    is marked dead and keeps its error in ``_Replica.error``; its unfinished
    requests, queued and in flight, are re-admitted to the survivors, each at
    most ``max_readmissions`` times. Re-admission runs the request again from
    its prompt: the compressed cache is a function of the prompt, so greedy
    decoding gives the same tokens. A drain that outlasts
    ``drain_timeout_s`` marks its replica wedged (``TimeoutError``), and a
    drain round that finishes none of its requests marks it dead.
  * ``init_distributed``: ``torch.distributed.init_process_group`` for a run
    of several processes, each of which builds its own replicas (and may
    pull work from one ``engine.dispatch.Coordinator``).

Replica threads and the card. Each replica launches on its thread's current
CUDA stream, which is the device's default stream unless the caller sets
another: every replica's kernels then run in one stream order, and the
decode kernel's per-(device, stream) arrival counters
(``ops.decode_attn._arrival_counters``) are never used by two calls at once.
A caller who gives a replica a stream of its own gives it its own counters
with it; a CUDA graph is never replayed from another thread. The threads
release the GIL inside the kernels' and ATen's calls, so one replica's host
work can overlap another's device work. ``local_front_door`` builds every
replica over one params dict: one copy of the weights on the card.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from fastkv_tpu_torch.engine.scheduler import Request, Scheduler


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
) -> Dict[str, int]:
    """Join this process to a ``torch.distributed`` group (nothing to do for a
    single process without a coordinator, or when a group exists already).

    ``coordinator_address`` is an init method (``tcp://host:port`` or
    ``file:///path``; a bare ``host:port`` means tcp); with none and
    ``WORLD_SIZE`` > 1 in the environment, the group comes from the
    environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``). The backend is
    NCCL for ``device="cuda"`` and gloo for ``device="cpu"``. Returns
    {process_index, process_count, local_device_count, global_device_count}."""
    dev = torch.device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if coordinator_address is not None or (num_processes or 1) > 1:
            addr = coordinator_address
            if addr is None:
                raise ValueError("num_processes > 1 needs a coordinator_address")
            if "://" not in addr:
                addr = f"tcp://{addr}"
            dist.init_process_group(
                backend, init_method=addr,
                world_size=num_processes if num_processes is not None else -1,
                rank=process_id if process_id is not None else -1)
        elif int(os.environ.get("WORLD_SIZE", "1")) > 1:
            dist.init_process_group(backend, init_method="env://")
    local = torch.cuda.device_count() if dev.type == "cuda" else 1
    if not dist.is_initialized():
        return {"process_index": 0, "process_count": 1, "local_device_count": local,
                "global_device_count": local}
    total = torch.tensor([local], dtype=torch.int64)
    if dist.get_backend() == dist.Backend.NCCL:
        total = total.to(dev)
    dist.all_reduce(total)
    return {"process_index": dist.get_rank(), "process_count": dist.get_world_size(),
            "local_device_count": local, "global_device_count": int(total.item())}


@dataclasses.dataclass
class _Ticket:
    """The front door's view of one submitted request."""

    ticket_id: int
    prompt: List[int]
    max_new_tokens: int
    eos_ids: Sequence[int]
    replica: Optional[int] = None
    replica_req_id: Optional[int] = None
    result: Optional[Request] = None
    readmissions: int = 0


class _Replica:
    """One Scheduler, its drain and its health."""

    def __init__(self, idx: int, scheduler: Scheduler):
        self.idx = idx
        self.scheduler = scheduler
        self.alive = True
        self.error: Optional[BaseException] = None
        self.assigned: Dict[int, _Ticket] = {}  # replica_req_id -> ticket

    @property
    def load(self) -> int:
        return len(self.assigned)

    def drain(self, fault: Optional[Callable[[int], None]] = None) -> List[Request]:
        """Run the scheduler until empty; a failure marks the replica dead.
        Any exception counts (a failed launch, out of memory, the fault hook):
        the front door re-admits the replica's requests elsewhere."""
        try:
            if fault is not None:
                fault(self.idx)
            return self.scheduler.run()
        except Exception as e:  # noqa: BLE001 - the replica's failure is data here
            self.error = e
            self.alive = False
            return []


class FrontDoor:
    """Data-parallel front door: dispatch requests across Scheduler replicas,
    detect a replica's failure and re-admit its requests to the survivors."""

    def __init__(
        self,
        schedulers: Sequence[Scheduler],
        max_readmissions: int = 2,
        drain_timeout_s: Optional[float] = None,
    ):
        if not schedulers:
            raise ValueError("need at least one scheduler replica")
        self.replicas = [_Replica(i, s) for i, s in enumerate(schedulers)]
        self.max_readmissions = max_readmissions
        # the bound on one drain round: a replica whose drain has not returned
        # by then is declared wedged (a hung device keeps its thread alive
        # without raising) and its requests re-admit to the survivors. None:
        # wait as long as it takes (trusted local replicas)
        self.drain_timeout_s = drain_timeout_s
        self.tickets: List[_Ticket] = []
        self._next = 0

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               eos_ids: Sequence[int] = ()) -> int:
        t = _Ticket(self._next, list(prompt), max_new_tokens, eos_ids)
        self._next += 1
        self.tickets.append(t)
        self._assign(t)
        return t.ticket_id

    def _assign(self, t: _Ticket) -> None:
        live = [r for r in self.replicas if r.alive]
        if not live:
            raise RuntimeError("no live replicas")
        r = min(live, key=lambda r: r.load)
        rid = r.scheduler.submit(t.prompt, t.max_new_tokens, t.eos_ids)
        t.replica, t.replica_req_id = r.idx, rid
        r.assigned[rid] = t

    def run(self, fault: Optional[Callable[[int], None]] = None) -> List[Dict[str, Any]]:
        """Drain every replica, each on its own thread. A dead replica's
        unfinished requests re-admit to the survivors and the drain repeats
        until all complete. ``fault`` is a one-shot fault hook, called with
        the replica's index at the start of the first round's drains (raise
        to simulate losing that replica). Returns one dict per ticket in
        submission order: ``ticket_id``, ``replica``, ``readmissions``,
        ``tokens`` and the request's metrics."""
        pending = True
        while pending:
            results: Dict[int, List[Request]] = {}
            threads = []
            for r in self.replicas:
                if not r.alive or not r.assigned:
                    continue

                def work(r=r, fault=fault):
                    results[r.idx] = r.drain(fault)

                th = threading.Thread(target=work, daemon=True)
                threads.append((th, r))
                th.start()
            deadline = (None if self.drain_timeout_s is None
                        else time.monotonic() + self.drain_timeout_s)
            for th, r in threads:
                th.join(None if deadline is None else max(deadline - time.monotonic(), 0.0))
                if th.is_alive():
                    # wedged: the drain neither returned nor raised in time.
                    # Its requests re-admit below; the stray thread can write
                    # only into this round's results, read once below
                    r.alive = False
                    r.error = TimeoutError(
                        f"replica {r.idx} drain exceeded {self.drain_timeout_s}s (wedged)")
            fault = None  # one-shot

            orphans: List[_Ticket] = []
            for r in self.replicas:
                done = {req.req_id: req for req in results.get(r.idx, [])}
                for rid, t in list(r.assigned.items()):
                    if rid in done:
                        t.result = done[rid]
                        del r.assigned[rid]
                if r.alive and r.idx in results and r.assigned and not done:
                    # a round that finished none of its requests: a live
                    # replica making no progress would spin this loop forever
                    r.alive = False
                if not r.alive and r.assigned:
                    orphans.extend(r.assigned.values())
                    r.assigned.clear()
            for t in orphans:
                if t.readmissions >= self.max_readmissions:
                    raise RuntimeError(
                        f"request {t.ticket_id} exceeded {self.max_readmissions} re-admissions")
                t.readmissions += 1
                self._assign(t)
            pending = any(r.alive and r.assigned for r in self.replicas) or bool(orphans)

        out = []
        for t in self.tickets:
            m = t.result.metrics if t.result else {}
            out.append({"ticket_id": t.ticket_id, "replica": t.replica,
                        "readmissions": t.readmissions,
                        "tokens": list(t.result.tokens) if t.result else None, **m})
        return out


def local_front_door(
    params: Dict[str, Any],
    cfg,
    mcfg,
    ecfg=None,
    n_replicas: int = 1,
    logger=None,  # utils.profiling.PhaseLogger: one JSON line per retired request
    drain_timeout_s: Optional[float] = None,
    **sched_kw,
) -> FrontDoor:
    """A front door over ``n_replicas`` Schedulers in this process, all over
    the one ``params`` dict. ``sched_kw`` goes to each ``Scheduler``
    (``max_batch``, ``bucket``, ``max_new_tokens``, ``device``, ...). In a run
    of several processes, call it on each (after ``init_distributed``) with
    that process's share of the requests, or pull them from a
    ``Coordinator``."""
    scheds = [Scheduler(params, cfg, mcfg, ecfg, logger=logger, **sched_kw)
              for _ in range(n_replicas)]
    return FrontDoor(scheds, drain_timeout_s=drain_timeout_s)
