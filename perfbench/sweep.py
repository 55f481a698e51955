"""The knee of an open-loop cell: the highest arrival rate the program
sustains without a growing backlog, found once by a sweep on the card.

    python3 -m perfbench.sweep --workload <cell> --seed <n> --seconds <s> --rates <r> [<r> ...]

One process: the cell's weights, its warm-up, then for each rate a window of
``--seconds`` of the cell's mix at that rate, each drained before the next.
Per rate one JSON line: arrivals, the mean time to first token of the
first and the last third of the arrivals (a backlog that grows makes the
last third wait longer), the drain (seconds from the window's close to the
last token), and the 50th and 95th percentile of the time to first token
and of the inter-token gaps, and the cell's own end-to-end metrics as its
readers compute them. The knee is the highest rate whose last third waits
no more than 1.5 times its first and whose drain is shorter than its
longest request. To see the spread at each rate, run it again with other
seeds (PERF.md gives the sweep and the rate chosen from it).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np
import torch

from perfbench import run


def summary(records, seconds: float, t0: float) -> dict:
    ttft = [r.first - r.start for r in records if r.first is not None]
    gaps = [b - a for r in records for a, b in zip(r.times, r.times[1:])]
    third = max(len(ttft) // 3, 1)
    ends = [r.end for r in records if r.end is not None]
    return {"arrivals": len(records), "finished": len(ends),
            "ttft_first_third_s": statistics.mean(ttft[:third]) if ttft else None,
            "ttft_last_third_s": statistics.mean(ttft[-third:]) if ttft else None,
            "ttft_p50_s": float(np.percentile(ttft, 50)) if ttft else None,
            "ttft_p95_s": float(np.percentile(ttft, 95)) if ttft else None,
            "itl_p50_ms": 1e3 * float(np.percentile(gaps, 50)) if gaps else None,
            "itl_p95_ms": 1e3 * float(np.percentile(gaps, 95)) if gaps else None,
            "drain_s": (max(ends) - t0 - seconds) if ends else None}


def sweep(root, workload: str, seed: int, seconds: float, rates, device: str, emit) -> None:
    """The sweep's windows in one process; ``emit`` takes each rate's line."""
    bench, _, conf, mix = run.load_cell(root, workload)
    if mix["loop"] != "open":
        raise ValueError("the sweep is for an open-loop cell")
    cfg, mcfg = run.model_config(conf)
    weights = run.weights_of(conf, seed, device)
    drv = run.Served(weights, cfg, mcfg, mix, seed, device, run.Spans())
    drv.warmup()
    readers = {m["name"]: run.load_metric(root, m["name"]) for m in bench["end_to_end"]
               if m["name"] != "setup_s" and workload in m.get("workloads", [workload])}
    for rate in rates:
        drv.mix = dict(mix, rate_per_s=rate)
        drv.records, drv.by_id = [], {}
        drv.sched.events.clear()
        t0 = run.time.perf_counter()
        drv.window(seconds, None)
        rec = {"cfg": conf["model"], "method": conf["method"], "arch": conf["reference"],
               "loop": "open",
               "requests": drv.records, "events": drv.events}
        emit({"rate_per_s": rate, "seed": seed, **summary(drv.records, seconds, t0),
              **{k: m.read(rec) for k, m in readers.items()}})
        drv.sched._run_loop()  # what the drain's deadline left, before the next rate
    drv.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from fastkv_tpu_torch.kernels import build

    build.build()
    torch.set_num_threads(1)
    print(run.card_line(), file=sys.stderr, flush=True)
    try:
        sweep(run.ROOT, args.workload, args.seed, args.seconds, args.rates, "cuda",
              lambda out: print(json.dumps(out), flush=True))
    except ValueError as e:
        print(e, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
