"""Port parity for dispatch across workers (``engine/dispatch.py``), against
the JAX package.

Mirrors tests/test_serve.py's dispatch cases on the tiny config (float32,
FastKV at retain 0.3, tsp 0.5, tsp_idx 1, bucket 256) on the CPU: a
``Coordinator`` on the loopback and ``serve_worker`` threads over port
Schedulers must give the JAX ``Scheduler``'s tokens for the same prompts,
with two workers, after a worker dies, after a worker hangs (its leases
expire), and for a ticket that arrives mid-decode (admitted between decode
steps). Also the poison-ticket cap, ``close()`` releasing a polling worker,
the port's one difference by design (a worker whose coordinator resets the
connection mid-run returns its served count instead of raising), and a
two-process run under ``parallel.launch.run_world`` (gloo): the group, an
all-reduce, a front door per rank and dispatch through rank 0's coordinator.

The JAX test's hung worker sleeps 20 s, there to cover the survivor's first
compiles; the port compiles nothing on the CPU, so it sleeps 5 s here. Every thread a test starts is a daemon, joined
with a timeout, and must have ended.
"""

import json
import os
import socket
import struct
import threading
import time

import jax
import numpy as np
import pytest

from fastkv_tpu.core import config as jcfg
from fastkv_tpu.engine.scheduler import Scheduler as JScheduler
from fastkv_tpu.models.llama import init_params as j_init_params
from fastkv_tpu_torch.core import config as tcfg
from fastkv_tpu_torch.engine.dispatch import Coordinator, serve_worker
from fastkv_tpu_torch.engine.scheduler import Scheduler
from fastkv_tpu_torch.models.llama import params_from_numpy
from fastkv_tpu_torch.parallel.launch import run_world
from fastkv_tpu_torch.utils.testing import serve_rank

MKW = dict(eviction_mode="proportional", retain_rate=0.3, tsp_rate=0.5, tsp_idx=1)
EKW = dict(prefill_buckets=(256,), capacity_align=8)
SCHED_KW = dict(max_batch=2, bucket=256)
JOIN_S = 60  # no thread of a test may outlive this
STREAM_BUDGETS = (200, 4)  # the streaming run: a long request, then a short one


def _jax_tokens(sched, prompts, budgets):
    ids = [sched.submit(p, b) for p, b in zip(prompts, budgets)]
    done = {r.req_id: r.tokens for r in sched.run()}
    return [list(map(int, done[i])) for i in ids]


@pytest.fixture(scope="module")
def stack():
    cj, ct = jcfg.ModelConfig.tiny(), tcfg.ModelConfig.tiny()
    pj = j_init_params(cj, seed=0)
    pt = params_from_numpy(ct, jax.tree_util.tree_map(np.asarray, pj), device="cpu")
    mj = jcfg.MethodConfig(method=jcfg.Method.FASTKV, **MKW)
    mt = tcfg.MethodConfig(method=tcfg.Method.FASTKV, **MKW)
    ej, et = jcfg.EngineConfig(use_pallas=False, **EKW), tcfg.EngineConfig(**EKW)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cj.vocab_size, size=int(n)).tolist()
               for n in rng.integers(40, 200, size=6)]
    # the JAX Scheduler's tokens: every prompt at budget 8, and the streaming
    # run's two requests at their budgets
    ref = _jax_tokens(JScheduler(pj, cj, mj, ej, max_new_tokens=8, **SCHED_KW), prompts,
                      [8] * len(prompts))
    stream_ref = _jax_tokens(JScheduler(pj, cj, mj, ej, max_new_tokens=200, **SCHED_KW),
                             prompts[:2], STREAM_BUDGETS)
    return ct, pt, mt, et, prompts, ref, stream_ref


def make_sched(stack, max_new=8):
    ct, pt, mt, et = stack[:4]
    return Scheduler(pt, ct, mt, et, device="cpu", max_new_tokens=max_new, **SCHED_KW)


class Worker:
    """serve_worker on a daemon thread, its return value or exception kept."""

    def __init__(self, address, sched, **kw):
        self.served, self.error = None, None
        self.thread = threading.Thread(target=self._run, args=(address, sched), kwargs=kw,
                                       daemon=True)
        self.thread.start()

    def _run(self, address, sched, **kw):
        try:
            self.served = serve_worker(address, sched, **kw)
        except BaseException as e:  # noqa: BLE001 - kept for the test to raise
            self.error = e

    def join(self):
        self.thread.join(JOIN_S)
        assert not self.thread.is_alive(), "worker thread still running"
        if self.error is not None:
            raise self.error
        return self.served


def test_dispatch_two_workers_matches_jax(stack):
    prompts, ref = stack[4], stack[5]
    coord = Coordinator()
    try:
        tids = [coord.submit(p, 8) for p in prompts]
        coord.seal()
        workers = [Worker(coord.address, make_sched(stack), name=f"w{i}", batch=1)
                   for i in range(2)]
        res = coord.wait_results(timeout=120)
        served = [w.join() for w in workers]
    finally:
        coord.close()
    assert sum(served) == len(prompts)
    assert len({r["worker"] for r in res}) == 2, "both workers must serve"
    for tid, want in zip(tids, ref):
        assert res[tid]["tokens"] == want
        assert res[tid]["readmissions"] == 0 and res[tid]["lease_expiries"] == 0


def test_dispatch_worker_death_readmits(stack):
    """A worker that vanishes holding tickets gets them re-queued; the
    survivor completes them with the JAX tokens."""
    prompts, ref = stack[4], stack[5]
    coord = Coordinator()
    try:
        tids = [coord.submit(p, 8) for p in prompts]
        coord.seal()
        Worker(coord.address, make_sched(stack), name="dying", batch=2, max_batches=0).join()
        ok = Worker(coord.address, make_sched(stack), name="survivor", batch=2)
        res = coord.wait_results(timeout=120)
        assert ok.join() == len(prompts)
    finally:
        coord.close()
    assert any(r["readmissions"] > 0 for r in res), "the death must re-admit"
    assert all(r["worker"] == "survivor" for r in res)
    for tid, want in zip(tids, ref):
        assert res[tid]["tokens"] == want


def test_dispatch_poison_request_capped(stack):
    """A ticket whose workers keep dying is re-admitted at most
    max_readmissions times, then fails the run instead of cycling."""
    coord = Coordinator(max_readmissions=1)
    try:
        coord.submit(stack[4][0], 4)
        coord.seal()
        for i in range(3):  # each worker takes the ticket and vanishes
            Worker(coord.address, make_sched(stack), name=f"dying{i}", batch=1,
                   max_batches=0).join()
        with pytest.raises(RuntimeError, match="re-admissions"):
            coord.wait_results(timeout=30)
    finally:
        coord.close()


def test_dispatch_close_releases_polling_workers(stack):
    """close() releases a worker stuck polling 'wait' (nothing submitted, not
    sealed): its next poll gets 'done'."""
    coord = Coordinator()
    w = Worker(coord.address, make_sched(stack), name="poller", batch=1, poll_s=0.02)
    time.sleep(0.3)  # the worker is in its wait-poll loop
    coord.close()
    assert w.join() == 0


def test_dispatch_hung_worker_lease_readmits(stack):
    """A worker that hangs holding tickets (socket open, no progress) stops
    heartbeating; its leases expire and the tickets complete on a healthy
    worker. Expiries are counted apart from death re-admissions."""
    prompts, ref = stack[4], stack[5]
    coord = Coordinator(lease_s=0.4)  # doubles per expiry
    try:
        tids = [coord.submit(p, 8) for p in prompts]
        coord.seal()
        hung = Worker(coord.address, make_sched(stack), name="hung", batch=2, hang_s=5.0)
        time.sleep(0.3)  # it claims a batch before the survivor connects
        ok = Worker(coord.address, make_sched(stack), name="survivor", batch=2)
        res = coord.wait_results(timeout=120)
        ok.join()
        hung.join()
    finally:
        coord.close()
    assert any(r["lease_expiries"] > 0 for r in res), "a lease must expire"
    assert all(r["readmissions"] == 0 for r in res), res
    assert all(r["worker"] == "survivor" for r in res), [r["worker"] for r in res]
    for tid, want in zip(tids, ref):
        assert res[tid]["tokens"] == want


def test_dispatch_streaming_interleave(stack):
    """A ticket that arrives while another decodes joins the running batch
    between decode steps (the worker's intake runs inside the scheduler's
    loop); both give the JAX tokens at their budgets."""
    prompts, stream_ref = stack[4], stack[6]
    sched = make_sched(stack, max_new=STREAM_BUDGETS[0])
    order = []
    install, step = sched._install, sched._decode_one_step
    # _install runs once per completed admission; _admit runs every idle
    # iteration whatever the queue holds, so it is not counted
    sched._install = lambda *a, **kw: (order.append("A"), install(*a, **kw))[1]
    sched._decode_one_step = lambda: (order.append("D"), step())[1]
    coord = Coordinator()
    try:
        t0 = coord.submit(prompts[0], STREAM_BUDGETS[0])
        w = Worker(coord.address, sched, name="w", batch=1, poll_s=0.01)
        deadline = time.monotonic() + JOIN_S
        while order.count("D") < 3 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert order.count("D") >= 3, order
        t1 = coord.submit(prompts[1], STREAM_BUDGETS[1])
        coord.seal()
        res = coord.wait_results(timeout=120)
        assert w.join() == 2
    finally:
        coord.close()
    trace = "".join(order)
    # the second admission came between decode steps of the first request
    assert "DAD" in trace[trace.index("D"):], trace
    assert trace.count("A") == 2, trace
    assert res[t0]["tokens"] == stream_ref[0]
    assert res[t1]["tokens"] == stream_ref[1]


def test_worker_survives_coordinator_reset(stack):
    """The port's difference by design: a coordinator that resets the
    connection while the worker decodes makes the worker's next read raise
    OSError inside intake(); the worker marks itself dead, finishes what it
    holds and returns its served count, with no exception."""
    prompt = stack[4][0]
    srv = socket.create_server(("127.0.0.1", 0))
    seen = []

    def fake_coordinator():
        conn, _ = srv.accept()
        lines = conn.makefile("r", encoding="utf-8")
        seen.append(json.loads(lines.readline()))  # hello
        seen.append(json.loads(lines.readline()))  # get
        conn.sendall((json.dumps({"op": "work", "items": [
            {"tid": 0, "prompt": prompt, "max_new_tokens": 8, "eos_ids": []}]}) + "\n").encode())
        seen.append(json.loads(lines.readline()))  # the next poll, mid-run
        # reset, not a clean close: the worker's read raises ECONNRESET
        conn.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
        lines.close()
        conn.close()

    fake = threading.Thread(target=fake_coordinator, daemon=True)
    fake.start()
    try:
        sched = make_sched(stack)
        w = Worker(srv.getsockname(), sched, name="w", batch=1, poll_s=0.0)
        served = w.join()
        fake.join(JOIN_S)
        assert not fake.is_alive()
    finally:
        srv.close()
    assert [m["op"] for m in seen[:2]] == ["hello", "get"]
    assert seen[2]["op"] in ("hb", "get", "result"), seen
    assert served == (1 if seen[2]["op"] == "result" else 0)
    assert not sched.active.any() and not sched.queue  # it finished what it held


def test_two_process_serving_smoke(stack, tmp_path):
    """Two processes (gloo, through run_world): init_distributed reports the
    group, an all-reduce sums the ranks, each rank's front door serves its
    share, and rank 0's coordinator feeds workers on both ranks; every token
    equals the JAX Scheduler's."""
    cj, ct = jcfg.ModelConfig.tiny(num_layers=1), tcfg.ModelConfig.tiny(num_layers=1)
    pj = j_init_params(cj, seed=0)
    mkw = dict(MKW, tsp_idx=0)
    ekw = dict(prefill_buckets=(64,), capacity_align=8)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cj.vocab_size, size=30).tolist() for _ in range(4)]
    ref = _jax_tokens(JScheduler(pj, cj, jcfg.MethodConfig(method=jcfg.Method.FASTKV, **mkw),
                                 jcfg.EngineConfig(use_pallas=False, **ekw), max_batch=1,
                                 bucket=64, max_new_tokens=4), prompts, [4] * 4)
    workdir = str(tmp_path / "world")
    run_world(serve_rank, 2, workdir,
              (workdir, ct, jax.tree_util.tree_map(np.asarray, pj),
               tcfg.MethodConfig(method=tcfg.Method.FASTKV, **mkw), tcfg.EngineConfig(**ekw),
               prompts, 4))
    outs = []
    for r in range(2):
        with open(os.path.join(workdir, f"rank{r}.json")) as f:
            outs.append(json.load(f))
    for r, out in enumerate(outs):
        assert out["info"] == {"process_index": r, "process_count": 2,
                               "local_device_count": 1, "global_device_count": 2}
        assert out["sum"] == 3.0
        assert out["front_door"] == ref[r::2]
        assert out["served"] > 0
    assert outs[0]["workers"] == ["p0", "p1"]
    assert outs[0]["served"] + outs[1]["served"] == 4
    assert outs[0]["dispatch"] == ref
