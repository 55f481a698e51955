"""Request dispatch across processes: a coordinator's queue that workers pull.

Port of ``fastkv_tpu.engine.dispatch``. ``engine.serve.FrontDoor`` spreads
requests over replicas inside one process; this module adds the leg between
processes. One process runs the ``Coordinator``, a TCP server of
newline-delimited JSON; every process (that one too) runs ``serve_worker``,
which drains tickets through its local Scheduler. Only request and response
metadata crosses the socket (prompts and token ids, never tensors), so the
coordinator has no device of its own.

Failures:
  * death: a worker whose connection drops gets its outstanding tickets
    re-queued at once, each at most ``max_readmissions`` times (a poison
    request that kills every worker fails the run instead of cycling);
  * hang: every ticket handed out carries a lease, renewed by the worker's
    polls between scheduler steps. A worker stuck inside a step stops
    polling with its socket open; its leases expire and the tickets go back
    to the queue. Expiries are counted apart from deaths, with their own cap
    of ``4 * (max_readmissions + 1)``, and each expiry doubles that ticket's
    next lease, so a slow but healthy ticket converges. A late result from a
    recovered worker is dropped: the first result wins (greedy re-execution
    gives the same tokens). Each connection renews and re-queues only the
    tickets it still owns.

Streaming: ``serve_worker`` feeds tickets into the Scheduler's step loop
through its ``intake`` hook (``Scheduler._run_loop``), so a ticket that
arrives while others decode joins the running batch through the scheduler's
interleaved (optionally chunked) admission, and each result streams back as
its request retires.

One difference from the JAX package, by design: every send and read inside
the worker's ``intake`` and result reports is guarded against ``OSError``
(and a torn line). A coordinator that goes away mid-run (a reset connection)
marks the worker dead, and ``serve_worker`` returns its served count instead
of raising from inside the scheduler's loop.

Protocol (one JSON object per line, either direction):
  worker -> {"op": "hello", "name": str}
            {"op": "get", "n": int}           heartbeat + ask for <= n tickets
            {"op": "hb"}                      heartbeat only (no work wanted)
            {"op": "result", "items": [...]}  completed tickets
  coord  -> {"op": "work", "items": [{"tid", "prompt", "max_new_tokens",
             "eos_ids"}]}
            {"op": "wait"}                    nothing queued now, poll again
            {"op": "ok"}                      heartbeat ack
            {"op": "done"}                    sealed and fully drained: exit
"""

from __future__ import annotations

import json
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Sequence


def _send(sock: socket.socket, obj: Dict[str, Any]) -> None:
    sock.sendall((json.dumps(obj) + "\n").encode())


class _LineReader:
    def __init__(self, sock: socket.socket):
        self.f = sock.makefile("r", encoding="utf-8")

    def read(self) -> Optional[Dict[str, Any]]:
        line = self.f.readline()
        if not line:
            return None
        return json.loads(line)


class Coordinator:
    """The request queue and result sink of pull-based dispatch."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 max_readmissions: int = 2, lease_s: float = 120.0):
        # lease_s should exceed the longest single step of a worker (one
        # monolithic admission's prefill, plus a first call's kernel build):
        # a worker polls between steps, so a busy one sends nothing inside one
        self.max_readmissions = max_readmissions
        self.lease_s = lease_s
        self._lock = threading.Condition()
        self._queue: List[Dict[str, Any]] = []
        self._outstanding: Dict[int, Dict[str, Any]] = {}  # tid -> ticket
        self._lease: Dict[int, float] = {}  # tid -> monotonic deadline
        self._owner: Dict[int, int] = {}  # tid -> connection id of the holder
        self._lease_scale: Dict[int, float] = {}  # tid -> lease multiplier
        self._results: Dict[int, Dict[str, Any]] = {}
        self._readmits: Dict[int, int] = {}
        self._expiries: Dict[int, int] = {}  # lease expiries per ticket
        self._next = 0
        self._sealed = False
        self._closed = False
        self._failed: Optional[str] = None
        self._srv = socket.create_server((host, port))
        self.address = self._srv.getsockname()  # (host, port)
        self._accept_thread = threading.Thread(target=self._accept, daemon=True)
        self._accept_thread.start()

    # -- host API -------------------------------------------------------------

    def submit(self, prompt: Sequence[int], max_new_tokens: int = 32,
               eos_ids: Sequence[int] = ()) -> int:
        with self._lock:
            if self._sealed:
                raise RuntimeError("coordinator already sealed")
            tid = self._next
            self._next += 1
            self._queue.append({
                "tid": tid, "prompt": list(map(int, prompt)),
                "max_new_tokens": int(max_new_tokens),
                "eos_ids": list(map(int, eos_ids)),
            })
            self._lock.notify_all()
            return tid

    def seal(self) -> None:
        """No more submissions; workers exit once everything is drained."""
        with self._lock:
            self._sealed = True
            self._lock.notify_all()

    def wait_results(self, timeout: float = 300.0) -> List[Dict[str, Any]]:
        """Block until every submitted ticket has a result; returns them in
        submission order. Raises on a ticket past its cap, or on timeout."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while len(self._results) < self._next:
                self._reap_expired_locked()
                if self._failed:
                    raise RuntimeError(self._failed)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"{self._next - len(self._results)} tickets unresolved "
                        f"(queued={len(self._queue)}, outstanding={len(self._outstanding)})")
                self._lock.wait(timeout=min(remaining, 1.0))
            return [self._results[t] for t in range(self._next)]

    def close(self) -> None:
        # closed first: a handler on a still-open connection answers 'done'
        # to its worker's next 'get' instead of 'wait' forever after a
        # wait_results that failed or timed out left the queue non-empty
        with self._lock:
            self._closed = True
            self._lock.notify_all()
        try:
            self._srv.close()
        except OSError:
            pass

    # -- lease bookkeeping (all called under self._lock) ----------------------

    def _renew_locked(self, conn_id: int, assigned: Dict[int, Dict[str, Any]]) -> None:
        """Renew the leases of tickets this connection still owns; forget the
        rest (an expiry may have moved one to another worker, whose lease and
        re-admission counts are not this connection's to touch)."""
        for tid in list(assigned):
            if self._owner.get(tid) != conn_id:
                del assigned[tid]
            elif tid in self._lease:
                self._lease[tid] = (time.monotonic()
                                    + self.lease_s * self._lease_scale.get(tid, 1.0))

    def _requeue_locked(self, tid: int, why: str, expiry: bool = False) -> None:
        """Move an outstanding ticket back to the queue, or fail on its cap.
        ``expiry``: a lease ran out (duplicated work at worst: the next lease
        doubles, under its own cap); otherwise the holder died (counts toward
        ``max_readmissions``, the poison-ticket guard)."""
        it = self._outstanding.pop(tid, None)
        self._lease.pop(tid, None)
        self._owner.pop(tid, None)
        if it is None or tid in self._results:
            return
        if expiry:
            self._lease_scale[tid] = 2.0 * self._lease_scale.get(tid, 1.0)
            n = self._expiries.get(tid, 0) + 1
            self._expiries[tid] = n
            cap = 4 * (self.max_readmissions + 1)
            if n > cap:
                self._failed = f"ticket {tid} exceeded {cap} lease expiries ({why})"
                return
        else:
            n = self._readmits.get(tid, 0) + 1
            if n > self.max_readmissions:
                self._failed = (f"ticket {tid} exceeded {self.max_readmissions} "
                                f"re-admissions ({why})")
                return
            self._readmits[tid] = n
        self._queue.append(it)

    def _reap_expired_locked(self) -> None:
        now = time.monotonic()
        for tid in [t for t, d in self._lease.items() if d < now]:
            self._requeue_locked(tid, "lease expired: worker stopped heartbeating", expiry=True)
        if self._lease or self._queue:
            self._lock.notify_all()

    # -- server side ----------------------------------------------------------

    def _accept(self) -> None:
        while True:
            try:
                conn, _ = self._srv.accept()
            except OSError:  # closed
                return
            threading.Thread(target=self._handle, args=(conn,), daemon=True).start()

    def _handle(self, conn: socket.socket) -> None:
        name = "?"
        assigned: Dict[int, Dict[str, Any]] = {}  # this worker's tickets in flight
        conn_id = id(conn)
        reader = _LineReader(conn)
        try:
            while True:
                msg = reader.read()
                if msg is None:
                    break
                op = msg.get("op")
                if op == "hello":
                    name = msg.get("name", "?")
                elif op == "hb":
                    with self._lock:
                        self._renew_locked(conn_id, assigned)
                        self._reap_expired_locked()
                    _send(conn, {"op": "ok"})
                elif op == "get":
                    with self._lock:
                        self._renew_locked(conn_id, assigned)
                        self._reap_expired_locked()
                        if self._closed or self._failed:
                            # closed, or a poison ticket used up its
                            # re-admissions (wait_results raises it): the
                            # worker exits instead of polling forever
                            _send(conn, {"op": "done"})
                        elif self._queue:
                            items = self._queue[: max(1, int(msg.get("n", 1)))]
                            del self._queue[: len(items)]
                            for it in items:
                                tid = it["tid"]
                                self._outstanding[tid] = it
                                self._lease[tid] = (time.monotonic() + self.lease_s
                                                    * self._lease_scale.get(tid, 1.0))
                                self._owner[tid] = conn_id
                                assigned[tid] = it
                            _send(conn, {"op": "work", "items": items})
                        elif self._sealed and not self._outstanding and (
                                len(self._results) >= self._next):
                            _send(conn, {"op": "done"})
                        else:
                            _send(conn, {"op": "wait"})
                elif op == "result":
                    with self._lock:
                        self._renew_locked(conn_id, assigned)
                        for it in msg["items"]:
                            tid = it["tid"]
                            assigned.pop(tid, None)
                            self._outstanding.pop(tid, None)
                            self._lease.pop(tid, None)
                            self._owner.pop(tid, None)
                            # a re-queued copy may still wait: drop it
                            self._queue = [q for q in self._queue if q["tid"] != tid]
                            if tid in self._results:
                                continue  # the first result wins
                            it["worker"] = name
                            it["readmissions"] = self._readmits.get(tid, 0)
                            it["lease_expiries"] = self._expiries.get(tid, 0)
                            self._results[tid] = it
                        self._lock.notify_all()
        except (OSError, ValueError):  # a dropped connection, a torn line
            pass
        finally:
            conn.close()
            # the worker died or left with tickets in flight: re-admit those it
            # still owns (an expiry may have moved some to another worker)
            with self._lock:
                for tid in assigned:
                    if tid in self._outstanding and self._owner.get(tid) == conn_id:
                        self._requeue_locked(tid, f"worker {name} disconnected")
                self._lock.notify_all()


def serve_worker(
    address,
    scheduler,
    name: str = "worker",
    batch: int = 2,
    poll_s: float = 0.05,
    max_batches: Optional[int] = None,
    hang_s: Optional[float] = None,
) -> int:
    """The streaming pull-run-report loop over one local Scheduler; returns
    the number of tickets it served (results it sent).

    Tickets are pulled and results reported from inside the scheduler's step
    loop (``Scheduler._run_loop``'s intake hook): arrivals join the running
    decode batch through the scheduler's interleaved admission, and each poll
    is the worker's heartbeat, which stops if a step never ends. A lost
    coordinator (``OSError`` on a send or read) marks the worker dead: it
    finishes the requests it holds, reports nothing more and returns.

    Fault hooks for tests: ``max_batches`` makes the worker vanish, holding
    its tickets, after pulling that many work batches (a host's death);
    ``hang_s`` makes it stop heartbeating for that long, holding its first
    batch with the socket open (a wedged device)."""
    sock = socket.create_connection(tuple(address))
    reader = _LineReader(sock)
    served = 0
    state = {"rounds": 0, "done": False, "dead": False, "last_poll": 0.0, "hung": False}
    rid2tid: Dict[int, int] = {}

    def report_finished() -> int:
        """Send the results of retired requests; returns how many were sent."""
        out = []
        while scheduler.finished:
            req = scheduler.finished.pop(0)
            tid = rid2tid.pop(req.req_id, None)
            if tid is None:
                continue
            out.append({"tid": tid, "tokens": list(map(int, req.tokens)),
                        **{k: v for k, v in req.metrics.items() if k != "req_id"}})
        if not out:
            return 0
        try:
            _send(sock, {"op": "result", "items": out})
        except OSError:
            state["dead"] = True
            return 0
        return len(out)

    def exchange(msg: Dict[str, Any]) -> Optional[Dict[str, Any]]:
        """Send one message and read the reply; None if the coordinator is gone
        (end of stream, a reset connection, a torn line)."""
        try:
            _send(sock, msg)
            return reader.read()
        except (OSError, ValueError):
            return None

    def intake() -> bool:
        """Heartbeat, pull and report; runs between scheduler steps."""
        nonlocal served
        if state["done"] or state["dead"]:
            return False
        served += report_finished()
        if state["dead"]:
            return False
        now = time.monotonic()
        busy = bool(scheduler.active.any()) or scheduler._adm is not None
        if busy and now - state["last_poll"] < poll_s:
            return True  # poll at most every poll_s while decoding
        state["last_poll"] = now
        free = scheduler.max_batch - int(scheduler.active.sum()) - len(scheduler.queue)
        want = max(0, min(batch, free)) if scheduler._adm is None else 0
        msg = exchange({"op": "hb"} if want == 0 else {"op": "get", "n": want})
        if msg is None:
            state["dead"] = True
            return False
        if msg["op"] == "done":
            state["done"] = True
            return False
        if msg["op"] in ("ok", "wait"):
            if not busy and msg["op"] == "wait":
                time.sleep(poll_s)
            # busy: nothing more to pull now, keep decoding (the active set
            # keeps _run_loop going); idle: keep polling from inside the loop
            return not busy
        if max_batches is not None and state["rounds"] >= max_batches:
            state["dead"] = True  # injected death: vanish holding the tickets
            return False
        state["rounds"] += 1
        for it in msg["items"]:
            rid = scheduler.submit(it["prompt"], it["max_new_tokens"], tuple(it["eos_ids"]))
            rid2tid[rid] = it["tid"]
        if hang_s is not None and not state["hung"]:
            state["hung"] = True  # injected wedge: hold the tickets, no heartbeat
            time.sleep(hang_s)
        return True

    try:
        try:
            _send(sock, {"op": "hello", "name": name})
        except OSError:
            return served
        while not (state["done"] or state["dead"]):
            scheduler.events.clear()
            # _run_loop swaps out scheduler.finished on return: requests that
            # retired after intake saw done or dead go back, to be reported
            scheduler.finished.extend(scheduler._run_loop(intake=intake))
            served += report_finished()
            if state["done"] or state["dead"]:
                break
            time.sleep(poll_s)
        return served
    finally:
        sock.close()
