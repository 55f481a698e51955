"""Port parity for the serving front door (``engine/serve.py``), against the
JAX package.

Mirrors tests/test_serve.py on the tiny config (float32, FastKV at retain
0.3, tsp 0.5, tsp_idx 1, bucket 256) on the CPU: the port's ``FrontDoor``
over port Schedulers must give the JAX ``Scheduler``'s tokens for the same
prompts, healthy, after a replica fails, and after a replica wedges. Also the
PhaseLogger's JSON lines (one per retired request, whole lines when threads
share the logger) and ``init_distributed`` in one process. The cross-process
leg (``engine/dispatch.py``) is in tests/test_torch_dispatch.py. The JAX
wedge test's drain timeout is 10 s, there to cover the survivor's first
compiles; the port compiles nothing on the CPU, so it is 4 s here. Every
thread a test starts is a daemon, joined with a timeout, and must have
ended.
"""

import io
import json
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from fastkv_tpu.core import config as jcfg
from fastkv_tpu.engine.scheduler import Scheduler as JScheduler
from fastkv_tpu.models.llama import init_params as j_init_params
from fastkv_tpu_torch.core import config as tcfg
from fastkv_tpu_torch.engine.scheduler import Scheduler
from fastkv_tpu_torch.engine.serve import FrontDoor, init_distributed, local_front_door
from fastkv_tpu_torch.models.llama import params_from_numpy
from fastkv_tpu_torch.utils.profiling import PhaseLogger

MKW = dict(eviction_mode="proportional", retain_rate=0.3, tsp_rate=0.5, tsp_idx=1)
EKW = dict(prefill_buckets=(256,), capacity_align=8)
SCHED_KW = dict(max_batch=2, bucket=256, max_new_tokens=8)
JOIN_S = 60  # no thread of a test may outlive this


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
    # the JAX Scheduler's tokens for every prompt: the reference
    js = JScheduler(pj, cj, mj, ej, **SCHED_KW)
    ids = [js.submit(p, 8) for p in prompts]
    done = {r.req_id: r.tokens for r in js.run()}
    ref = [list(map(int, done[i])) for i in ids]
    return ct, pt, mt, et, prompts, ref


def make_sched(stack):
    ct, pt, mt, et = stack[:4]
    return Scheduler(pt, ct, mt, et, device="cpu", **SCHED_KW)


def test_front_door_two_replicas_matches_jax(stack):
    prompts, ref = stack[4], stack[5]
    fd = FrontDoor([make_sched(stack), make_sched(stack)])
    tids = [fd.submit(p, 8) for p in prompts]
    out = {r["ticket_id"]: r for r in fd.run()}
    assert {out[t]["replica"] for t in tids} == {0, 1}, "both replicas must serve"
    for t, want in zip(tids, ref):
        assert out[t]["tokens"] == want
        assert out[t]["ttft_s"] >= 0 and out[t]["tpot_s"] >= 0
        assert out[t]["readmissions"] == 0


def test_replica_failure_readmits_to_survivor(stack):
    prompts, ref = stack[4], stack[5]
    fd = FrontDoor([make_sched(stack), make_sched(stack)])
    tids = [fd.submit(p, 8) for p in prompts]

    def fault(idx):
        if idx == 0:
            raise RuntimeError("injected replica loss")

    out = {r["ticket_id"]: r for r in fd.run(fault=fault)}
    assert not fd.replicas[0].alive and fd.replicas[1].alive
    assert isinstance(fd.replicas[0].error, RuntimeError)
    assert [t for t in tids if out[t]["readmissions"] > 0], "replica 0's requests re-admit"
    for t, want in zip(tids, ref):
        # a re-admitted request runs again from its prompt: the same tokens
        assert out[t]["tokens"] == want
        assert out[t]["replica"] == 1 or out[t]["readmissions"] == 0


def test_all_replicas_dead_raises(stack):
    fd = FrontDoor([make_sched(stack)])
    fd.submit(stack[4][0], 4)

    def fault(idx):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="no live replicas"):
        fd.run(fault=fault)


def test_readmission_cap(stack):
    """A request whose replicas keep dying is re-admitted at most
    max_readmissions times, then the run raises."""
    def die():
        raise RuntimeError("dies every time")

    scheds = [make_sched(stack) for _ in range(3)]
    for s in scheds:
        s.run = die
    fd = FrontDoor(scheds, max_readmissions=1)
    fd.submit(stack[4][0], 4)
    with pytest.raises(RuntimeError, match="exceeded 1 re-admissions"):
        fd.run()


def test_front_door_wedged_replica_timeout(stack):
    """A replica whose drain never returns (a hung device, no exception) is
    marked wedged by the drain timeout; its requests complete on the
    survivor with the JAX tokens."""
    prompts, ref = stack[4], stack[5]
    release, stuck = threading.Event(), []
    wedged, ok = make_sched(stack), make_sched(stack)

    def hang():
        stuck.append(threading.current_thread())
        release.wait(JOIN_S)
        return []

    wedged.run = hang
    fd = FrontDoor([wedged, ok], drain_timeout_s=4.0)
    tids = [fd.submit(p, 8) for p in prompts]
    try:
        out = {r["ticket_id"]: r for r in fd.run()}
    finally:
        release.set()
    for th in stuck:
        assert th.daemon
        th.join(JOIN_S)
        assert not th.is_alive()
    assert not fd.replicas[0].alive and isinstance(fd.replicas[0].error, TimeoutError)
    assert fd.replicas[1].alive
    assert any(out[t]["readmissions"] > 0 for t in tids)
    for t, want in zip(tids, ref):
        assert out[t]["tokens"] == want


def test_zero_progress_round_marks_replica_dead(stack):
    """A drain round that returns without finishing any of its requests marks
    the replica dead; its requests re-admit to the survivor."""
    prompts, ref = stack[4], stack[5]
    idle, ok = make_sched(stack), make_sched(stack)
    idle.run = lambda: []
    fd = FrontDoor([idle, ok])
    tids = [fd.submit(p, 8) for p in prompts]
    out = {r["ticket_id"]: r for r in fd.run()}
    assert not fd.replicas[0].alive and fd.replicas[0].error is None
    for t, want in zip(tids, ref):
        assert out[t]["tokens"] == want and out[t]["replica"] == 1


def test_front_door_phase_logger_jsonl(stack):
    """One JSON line per retired request through local_front_door's logger,
    its replicas over one params dict."""
    ct, pt, mt, et, prompts, _ = stack
    sio = io.StringIO()
    fd = local_front_door(pt, ct, mt, et, n_replicas=2, logger=PhaseLogger(stream=sio),
                          max_batch=2, bucket=256, max_new_tokens=4, device="cpu")
    assert all(r.scheduler.params is pt for r in fd.replicas)
    for p in prompts[:3]:
        fd.submit(p, 4)
    fd.run()
    recs = [json.loads(line) for line in sio.getvalue().splitlines()]
    done = [r for r in recs if r["phase"] == "request_done"]
    assert len(done) == 3
    for r in done:
        assert {"ts", "req_id", "prompt_len", "new_tokens", "ttft_s", "tpot_s"} <= set(r)
        assert r["new_tokens"] == 4


class _SlowStream(io.StringIO):
    """A stream whose every write yields the interpreter mid-record."""

    def write(self, s):
        n = 0
        for ch in s:
            n += super().write(ch)
            if ch in ',:':
                time.sleep(0)
        return n


def test_phase_logger_threads_write_whole_lines():
    stream = _SlowStream()
    logger = PhaseLogger(stream=stream)
    per_thread = 200

    def work(i):
        for j in range(per_thread):
            logger.log("request_done", thread=i, j=j, pad="x" * 40)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,), daemon=True) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    lines = stream.getvalue().split("\n")
    assert lines[-1] == ""
    recs = [json.loads(line) for line in lines[:-1]]
    assert len(recs) == 4 * per_thread
    for i in range(4):
        assert [r["j"] for r in recs if r["thread"] == i] == list(range(per_thread))


def test_init_distributed_single_process(tmp_path):
    """No group and no coordinator: nothing to do. A coordinator address of a
    one-process world (gloo) joins it; a second call reports the group."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    assert init_distributed(device="cpu") == {
        "process_index": 0, "process_count": 1, "local_device_count": 1,
        "global_device_count": 1}
    try:
        info = init_distributed(f"file://{tmp_path / 'store'}", num_processes=1,
                                process_id=0, device="cpu")
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert info == {"process_index": 0, "process_count": 1, "local_device_count": 1,
                        "global_device_count": 1}
        assert init_distributed(device="cpu") == info
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_entry_points_default_to_the_card(stack):
    """Without device='cpu' the replicas are built for the card, which this
    machine lacks: the Scheduler raises rather than run on the CPU."""
    ct, pt, mt, et = stack[:4]
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        local_front_door(pt, ct, mt, et, n_replicas=2, **SCHED_KW)
