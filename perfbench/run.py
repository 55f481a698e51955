"""The benchmark of ``fastkv_tpu_torch`` on one H100: one cell, one run.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s ``workloads``)
names a configuration (``perfbench/configs/<config>.json``: the model's
published sizes, the method, the plain reference) and a traffic mix
(``perfbench/traffic/<mix>.json``). A run:

  1. prints the card (name, count, power limit) on stderr, and exits 2
     without a result when there is no card or fewer than the cell asks for;
  2. makes the weights on the card from the seed (bf16, a few large calls),
     by the configuration's architecture module (``perfbench/arch/``,
     named by its ``reference``);
  3. builds the program's kernels or loads them from ``build/kernels/`` in
     the checkout;
  4. warms up the shapes the cell's traffic uses (set-up ends here);
  5. drives the traffic for ``--seconds``: a closed loop of
     ``Engine.generate`` calls, or an open loop of arrivals submitted to a
     ``Scheduler`` through its intake hook when they fall due; with
     ``--trace 1`` a bounded stretch runs under ``torch.profiler``: one
     request of the mix's middle prompt size after a closed window, a fixed
     number of loop iterations late in an open one;
  6. reads the peak memory, frees the program, and compares a sample of the
     window's requests with the plain reference (``perfbench.check``);
  7. prints the one result line: the cell's end-to-end metrics (``--trace
     0``) or per-layer metrics (``--trace 1``), each computed by its reader
     ``perfbench/metrics/<name>.py``, and the numbers compared, each beside
     its limit (``perfbench/limits/<cell>.json``), last.

It exits 3 without a result if ``jax``, ``jaxlib``, ``flax`` or the JAX
package is loaded at the end of the run (the window, the check and the
readers all behind it).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import arch, check, traffic, work  # noqa: E402
from perfbench.trace import DeviceTrace, Spans, busy_ns, idle_gaps, top_ops  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "fastkv_tpu")
DRAIN_S = 60.0  # how long past the window an arrived request may take to finish
TRACE_AT = 0.78  # an open window's traced stretch starts at this share of it
TRACE_ITERATIONS = 40  # and lasts this many loop iterations


class Deadline(Exception):
    """The drain ran past ``DRAIN_S``: what has not finished has failed."""


@dataclasses.dataclass
class Record:
    """One request of the window, on the harness's clock (perf_counter s)."""

    index: int
    prompt: List[int]
    asked: int
    start: float  # when it was due (open loop) or called (closed loop)
    first: Optional[float] = None  # the first token reached the host
    end: Optional[float] = None  # the last token reached the host
    times: List[float] = dataclasses.field(default_factory=list)  # every token's
    tokens: List[int] = dataclasses.field(default_factory=list)
    traced: bool = False
    kept: Any = None  # (pos, valid [L, CH, C], prefill slots) of its cache
    decoded: Any = None  # (pos, valid, prefill slots) of its cache after the last step
    tsp: Any = None  # (positions [1, s], idx, valid) of its TSP gather
    req_id: Optional[int] = None
    req: Any = None  # the Scheduler's Request


def process_age_s() -> float:
    """Seconds from the process's start to the top of this module."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        up = float(Path("/proc/uptime").read_text().split()[0])
        age = up - ticks / os.sysconf("SC_CLK_TCK")
        return max(age - (time.perf_counter() - T_START), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def card_line() -> str:
    name = torch.cuda.get_device_name(0)
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = "not read"
    return f"card: {name} x{torch.cuda.device_count()}, power limit {limit}"


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_cell(root: Path, workload: str):
    """(BENCHMARK.json, the cell, its configuration file, its mix) by name."""
    bench = load_json(Path(root) / "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    cconf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return bench, cell, load_json(Path(root) / cconf["file"]), traffic.load(root, cell["traffic"])


def load_metric(root: Path, name: str):
    path = Path(root) / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("perfbench_metric_" + name.replace(".", "_")
                                                  .replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def model_config(conf: dict):
    """The program's ModelConfig and MethodConfig from a configuration file."""
    from fastkv_tpu_torch.core.config import Method, MethodConfig, ModelConfig

    cfg = ModelConfig.from_hf_config(conf["model"], name=conf["name"])
    cfg = dataclasses.replace(cfg, dtype=conf["dtype"])
    meth = dict(conf["method"])
    mcfg = MethodConfig(method=Method(meth.pop("method")), **meth)
    return cfg, mcfg


def weights_of(conf: dict, seed: int, device: str) -> Dict[str, Any]:
    """The configuration's weights from the seed, made by its architecture
    module (``perfbench/arch/<reference>.py``) in the configuration's dtype."""
    return arch.load(conf["reference"]).make_weights(conf["model"], seed, device,
                                                     getattr(torch, conf["dtype"]))


def make_weights(m: dict, seed: int, device: str, dtype: torch.dtype) -> Dict[str, Any]:
    """A Mistral-family model's weights from the seed (``arch.mistral``)."""
    return arch.load(work.DEFAULT_ARCH).make_weights(m, seed, device, dtype)


class Spy:
    """The harness's view into the program's calls: it wraps the entry
    points the window drives (by name, restored by ``close``) to stamp its
    own clock and keep references to the state the check follows (the kept
    positions of each cache, the TSP set); it adds no device work."""

    def __init__(self, spans: Spans):
        from fastkv_tpu_torch.engine import decode, prefill

        self.spans = spans
        self.current: Optional[Record] = None
        self.last_tsp = None
        self._restore = []
        self._patch(prefill, "tsp_gather", self._tsp_gather)
        self._patch(decode, "greedy_generate", self._greedy_generate)

    def _patch(self, obj, name, make):
        orig = getattr(obj, name)
        setattr(obj, name, make(orig))
        self._restore.append((obj, name, orig))

    def _tsp_gather(self, orig):
        def tsp_gather(state, tsp):
            self.last_tsp = (state.positions, tsp.idx, tsp.valid)
            return orig(state, tsp)
        return tsp_gather

    def _greedy_generate(self, orig):
        def greedy_generate(params, cfg, mcfg, shapes, first_logits, cache, *a, **kw):
            rec = self.current
            if rec is not None:  # the prefill ended with a device sync in Engine.generate
                rec.first = time.perf_counter()
                rec.kept = (cache.pos, cache.valid, shapes.prefill_capacity)
                rec.tsp, self.last_tsp = self.last_tsp, None
            with self.spans.span("decode"):
                out, cache = orig(params, cfg, mcfg, shapes, first_logits, cache, *a, **kw)
            if rec is not None:
                rec.decoded = (cache.pos, cache.valid, shapes.prefill_capacity)
            return out, cache
        return greedy_generate

    def close(self):
        for obj, name, orig in reversed(self._restore):
            setattr(obj, name, orig)
        self._restore = []


class Offline:
    """A closed loop of ``Engine.generate`` at batch 1."""

    def __init__(self, weights, cfg, mcfg, mix, seed, device, spans):
        from fastkv_tpu_torch.core.config import EngineConfig
        from fastkv_tpu_torch.engine.generate import Engine

        eng = dict(mix["engine"])
        eng["prefill_buckets"] = tuple(eng["prefill_buckets"])
        self.engine = Engine(weights, cfg, mcfg, EngineConfig(**eng), device=device)
        self.mix, self.seed, self.vocab, self.spans = mix, seed, cfg.vocab_size, spans
        self.spy = Spy(spans)
        self.records: List[Record] = []

    def warmup(self) -> None:
        """One generate at the longest prompt of the mix's bucket: every
        prefill and decode shape of the cell (the cache's decode part is
        aligned, so two new tokens give the same shapes as the mix's)."""
        n = self.mix["prompt"].get("hi", traffic.quantile(self.mix["prompt"], 0.5))
        prompt = np.random.default_rng([self.seed % (1 << 63), 4]).integers(
            0, self.vocab, size=n).tolist()
        self.engine.generate([prompt], max_new_tokens=2)

    def window(self, seconds: float, trace: Optional[DeviceTrace]) -> float:
        """The closed loop for ``seconds``; then, with a trace, requests of
        the mix's middle prompt size under the profiler until one records.
        The traced request runs after the window: the profiler's start and
        stop hold the host for seconds, and the request after a traced one
        took 5.3 s to its first token against 1.28 (Mistral-Nemo-12B, an H100)."""
        t0 = time.perf_counter()
        requests = traffic.closed_requests(self.mix, self.seed, self.vocab)
        for req in requests:
            if time.perf_counter() - t0 >= seconds:
                break
            self._one(req)
        window_s = time.perf_counter() - t0
        if trace is not None:
            k = self.mix["strata"]
            n = traffic.sizes(self.mix["prompt"], k)[k // 2]
            tries = 0
            for req in requests:
                if len(req.prompt) != n:
                    continue
                trace.start()
                self._one(req, traced=True)
                trace.stop()
                tries += 1
                if trace.recorded or tries == 3:  # some stretches record nothing
                    break
        return window_s

    def _one(self, req: traffic.Req, traced: bool = False) -> None:
        rec = Record(req.index, req.prompt, req.new_tokens, time.perf_counter(), traced=traced)
        self.spy.current = rec
        with self.spans.span("generate"):
            out = self.engine.generate([req.prompt], max_new_tokens=req.new_tokens)
        rec.end = time.perf_counter()
        self.spy.current = None
        rec.tokens = out[0]
        self.records.append(rec)
        if rec.first is not None:  # the program's own prefill time beside the harness's
            print(f"request {rec.index}: prompt {len(rec.prompt)}, ttft {rec.first - rec.start:.4f}"
                  f" s (prefill_s {self.engine.last_timing.get('prefill_s', 0.0):.4f}), tpot "
                  f"{1e3 * (rec.end - rec.first) / max(len(rec.tokens) - 1, 1):.3f} ms"
                  f"{', traced' if traced else ''}", file=sys.stderr, flush=True)

    def close(self) -> None:
        self.spy.close()
        self.engine = None


class Served:
    """An open loop into a ``Scheduler``: each arrival is submitted through
    the loop's intake hook once it is due."""

    def __init__(self, weights, cfg, mcfg, mix, seed, device, spans):
        from fastkv_tpu_torch.core.config import EngineConfig
        from fastkv_tpu_torch.engine.scheduler import Scheduler

        eng = dict(mix["engine"])
        if "prefill_buckets" in eng:
            eng["prefill_buckets"] = tuple(eng["prefill_buckets"])
        self.sched = Scheduler(weights, cfg, mcfg, EngineConfig(**eng), device=device,
                               **mix["scheduler"])
        self.mix, self.seed, self.vocab, self.spans = mix, seed, cfg.vocab_size, spans
        self.spy = Spy(spans)
        self.by_id: Dict[int, Record] = {}
        self.records: List[Record] = []
        self.events: List[tuple] = []
        s = self.sched
        install, step = s._install, s._decode_one_step

        def _install(slot, req, n, logits, cache1):
            with spans.span("install"):
                install(slot, req, n, logits, cache1)
            rec = self.by_id.get(req.req_id)
            if rec is not None:
                rec.req = req
                rec.first = time.perf_counter()
                rec.times.append(rec.first)
                rec.kept = (cache1.pos, cache1.valid, cache1.pos.shape[-1])
                rec.tsp, self.spy.last_tsp = self.spy.last_tsp, None

        def _decode_one_step():
            live = [r.req_id for r in s.slot_req if r is not None]
            with spans.span("decode_step"):
                step()
            t = time.perf_counter()
            for rid in live:
                rec = self.by_id.get(rid)
                if rec is not None:
                    rec.times.append(t)

        s._install, s._decode_one_step = _install, _decode_one_step

    def _prompt(self, n: int, stream: int) -> List[int]:
        return np.random.default_rng([self.seed % (1 << 63), 5, stream]).integers(
            0, self.vocab, size=n).tolist()

    def warmup(self) -> None:
        """Every admission bucket once monolithically (an idle admission
        admits all at once), then every bucket the chunk tiles chunk-wise
        while a long request decodes."""
        s = self.sched
        for i, b in enumerate(s.buckets):
            s.submit(self._prompt(b, i), max_new_tokens=4)
        s.run()
        chunk = s.ecfg.prefill_chunk
        runner = self._prompt(s.buckets[0], 100)
        rest = [self._prompt(b, 200 + i) for i, b in enumerate(s.buckets)
                if chunk and b % chunk == 0]
        started = []

        def intake():
            if not started:  # the runner admits alone, while the loop is idle
                s.submit(runner, max_new_tokens=min(64, s.max_new))
                started.append(True)
            elif rest and s.active.any():  # these admit chunk-wise while it decodes
                for p in rest:
                    s.submit(p, max_new_tokens=2)
                rest.clear()
            return bool(rest)

        s._run_loop(intake=intake)
        s.events.clear()

    def window(self, seconds: float, trace: Optional[DeviceTrace]) -> float:
        s = self.sched
        sched_list = traffic.open_schedule(self.mix, self.seed, self.vocab, seconds)
        traced_at = TRACE_AT * seconds
        state = {"next": 0, "iter": 0, "stop": 0, "tries": 0}
        t0 = time.perf_counter()
        self.lateness: List[float] = []
        self.traced_host: List[tuple] = []

        def trace_tick(now):
            """One stretch of ``TRACE_ITERATIONS`` loop iterations under
            the profiler, from ``traced_at`` on (its events are read after
            the window)."""
            if trace is None or state["tries"]:
                return
            if trace.active:
                if state["iter"] >= state["stop"]:
                    trace.stop()
                    self.traced_host.append((state["t"], time.perf_counter()))
                    state["tries"] += 1
            elif now - t0 >= traced_at and now - t0 < seconds:
                state["t"] = now
                trace.start()
                state["stop"] = state["iter"] + TRACE_ITERATIONS

        def intake():
            now = time.perf_counter()
            trace_tick(now)
            state["iter"] += 1
            i = state["next"]
            idle = not (s.queue or s.active.any() or s._adm is not None)
            if idle and i < len(sched_list):  # nothing to do before the next arrival
                wait = t0 + sched_list[i].due_s - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                now = time.perf_counter()
            while i < len(sched_list) and t0 + sched_list[i].due_s <= now:
                req = sched_list[i]
                rid = s.submit(req.prompt, max_new_tokens=req.new_tokens)
                self.lateness.append(now - (t0 + req.due_s))
                rec = Record(req.index, req.prompt, req.new_tokens, t0 + req.due_s, req_id=rid)
                self.by_id[rid] = rec
                self.records.append(rec)
                i += 1
            state["next"] = i
            if now - t0 > seconds + DRAIN_S:
                raise Deadline
            return i < len(sched_list)

        try:
            with self.spans.span("loop"):
                s._run_loop(intake=intake)
        except Deadline:
            pass
        if trace is not None and trace.active:
            trace.stop()
            self.traced_host.append((state["t"], time.perf_counter()))
        for rec in self.records:
            req = rec.req
            if req is not None:
                rec.tokens = list(req.tokens)
                if req.finished_at:
                    rec.end = rec.times[-1]
        self.events = list(s.events)
        return time.perf_counter() - t0

    def close(self) -> None:
        self.spy.close()
        del self.sched._install, self.sched._decode_one_step  # the wrappers' cycle
        self.sched = None


LOOPS = {"closed": Offline, "open": Served}


def follow_of(rec: Record, reference):
    """The program's choices for ``rec``, as the reference follows them."""
    pos, valid, cap = rec.kept
    pos, valid = pos[:, 0, :, :cap].cpu(), valid[:, 0, :, :cap].cpu()
    kept = [[pos[l, c][valid[l, c]].long() for c in range(pos.shape[1])]
            for l in range(pos.shape[0])]
    tsp = None
    if rec.tsp is not None:
        positions, idx, ok = (t.cpu() for t in rec.tsp)
        tsp = torch.gather(positions.long(), 1, idx.long())[0][ok[0]]
    return reference.Follow(kept, tsp)


def sample(records: List[Record], seed: int, k: int) -> List[Record]:
    """The request with the most served tokens (then the longest prompt), and
    k - 1 more drawn from the seed."""
    done = [r for r in records if r.tokens and r.kept is not None]
    if not done:
        return []
    top = max(done, key=lambda r: (len(r.tokens), len(r.prompt)))
    rest = [r for r in done if r is not top]
    order = np.random.default_rng([seed % (1 << 63), 6]).permutation(len(rest))
    return [top] + [rest[i] for i in order[:k - 1]]


def judge(ref, rec: Record, follow, conf: dict) -> Dict[str, float]:
    """The numbers of one request against the reference that followed it;
    where the harness holds the program's cache after the last decode step
    (``Engine.generate``), whether it kept every decoded token."""
    nums = check.judge(ref, rec.tokens, rec.asked, follow.kept, follow.tsp, len(rec.prompt),
                       conf["method"]["window_size"])
    if rec.decoded is not None:
        pos, valid, cap = rec.decoded
        nums["decode_misses"] = check.decode_misses(pos[:, 0].cpu(), valid[:, 0].cpu(), cap,
                                                    len(rec.prompt), len(rec.tokens))
    return nums


def compare(weights, conf: dict, mix: dict, records: List[Record], seed: int,
            log) -> Dict[str, float]:
    """The numbers of the sampled requests, each the worst over them."""
    reference = importlib.import_module(f"perfbench.reference.{conf['reference']}")
    per = []
    for rec in sample(records, seed, mix["check_requests"]):
        t = time.perf_counter()
        follow = follow_of(rec, reference)
        ref = reference.run(weights, conf["model"], conf["method"], rec.prompt, rec.tokens,
                            follow)
        nums = judge(ref, rec, follow, conf)
        del ref
        log(f"check: request {rec.index} (prompt {len(rec.prompt)}, served {len(rec.tokens)}) "
            f"{json.dumps(nums)} in {time.perf_counter() - t:.1f} s")
        per.append(nums)
    return check.worst(per)


def forbidden_loaded() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", log=None) -> dict:
    """One run of one cell -> the result object (not yet printed)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    root = Path(root)
    bench, cell, conf, mix = load_cell(root, workload)
    limits = load_json(root / "perfbench" / "limits" / f"{workload}.json")
    cfg, mcfg = model_config(conf)
    if device == "cuda":
        from fastkv_tpu_torch.kernels import build

        build.build()
        torch.set_num_threads(1)
    weights = weights_of(conf, seed, device)
    spans = Spans()
    client = LOOPS[mix["loop"]](weights, cfg, mcfg, mix, seed, device, spans)
    client.warmup()
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = process_age_s() + time.perf_counter() - T_START
    dtrace = DeviceTrace() if trace and device == "cuda" else None
    window_s = client.window(seconds, dtrace)
    peak = int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0
    records = client.records
    events = getattr(client, "events", [])
    lateness = getattr(client, "lateness", None)
    traced_host = getattr(client, "traced_host", [])
    if lateness:
        log(f"generator lateness: mean {np.mean(lateness) * 1e3:.3f} ms, "
            f"max {np.max(lateness) * 1e3:.3f} ms over {len(lateness)} arrivals")
    client.close()
    del client
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    finished = [r for r in records if r.end is not None and len(r.tokens) == r.asked]
    log(f"window: {window_s:.3f} s, {len(records)} requests, {len(finished)} finished, "
        f"setup {setup_s:.3f} s, peak {peak} B")
    t_ref = time.perf_counter()
    numbers = compare(weights, conf, mix, records, seed, log)
    log(f"reference: {time.perf_counter() - t_ref:.1f} s")
    rec = {"cfg": conf["model"], "method": conf["method"], "arch": conf["reference"],
           "mix": mix, "loop": mix["loop"],
           "requests": records, "events": events, "setup_s": setup_s, "window_s": window_s,
           "trace": dtrace, "spans": spans.items, "seconds": seconds,
           "traced_host": traced_host}
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench[kind]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        value = load_metric(root, m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": False, "attempted": len(records),
              "failed": len(records) - len(finished), "metrics": metrics, "device": dev}
    if dtrace is not None and dtrace.recorded:
        lo, hi = dtrace.window
        dev["busy_s"] = busy_ns(dtrace.device, lo, hi) / 1e9
        dev["window_s"] = (hi - lo) / 1e9
        result["breakdown"] = {"device_ops": top_ops(dtrace.device, lo, hi),
                               "idle_gaps": idle_gaps(dtrace.device, spans.items, lo, hi)}
    ok = check.verdict(numbers, limits) and result["failed"] == 0 and bool(finished)
    result["correct"] = ok
    result["checks"] = {k: {"value": numbers.get(k), "limit": lim} for k, lim in limits.items()}
    for k, v in numbers.items():
        log(f"check {k}: {v!r} (limit {limits.get(k, 'none: not compared')})")
    result["loaded"] = forbidden_loaded()  # read by main, not printed
    return result


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    need = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"needs {need} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    print(card_line(), file=sys.stderr, flush=True)
    result = run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace))
    loaded = result.pop("loaded")
    if loaded:
        print(f"loaded by the end of the run: {', '.join(loaded)}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"{k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
