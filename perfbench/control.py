"""The control of a cell's comparison, and the readings its limits are set from.

    python3 -m perfbench.control --workload <cell> --seconds <s> --seeds <n> [<n> ...]
    python3 -m perfbench.control --workload <cell> --seconds <s> --seeds <n> --fault <name>

For each seed, in one process: the cell's weights from the seed, its
warm-up and a window of ``--seconds`` of its own traffic, then, for the
requests the benchmark's check samples, the plain reference in float32
(following the program's kept sets and TSP set, as the check runs it) and
the control: the same reference in float8 (every matrix product's operands
rounded to e4m3, ``reference/<name>.py``) put in the program's place. The
control's tokens are its first choice at each position of the same prompt
and served tokens, its kept sets and TSP set its own top-k at the same
hidden states; the float32 reference judges them as it judges the
program's (``perfbench.check.judge``).

Prints one JSON line per seed on stdout: the program's numbers and the
control's; the lower reading of a number is the largest the program gives
over the seeds, the upper the smallest the control gives.

With ``--fault`` the window runs with that fault of ``perfbench.faults``
planted in the program's decode step, and the line holds the program's
numbers and whether the cell's limits (``perfbench/limits/<cell>.json``)
find the run not correct; no control runs.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import sys
import time
from typing import Dict, List, Optional

import torch

from perfbench import check, faults, run


def control_numbers(weights, conf: dict, rec: run.Record, follow, ref32, reference) -> Dict:
    """The float8 reference in the program's place, judged by ``ref32``."""
    ref8 = reference.run(weights, conf["model"], conf["method"], rec.prompt, rec.tokens, follow,
                         precision="float8")
    n, W = len(rec.prompt), conf["method"]["window_size"]
    win = torch.arange(max(n - W, 0), n)
    kept = [[torch.cat([own.cpu(), win]) for own in lay.own_keep] for lay in ref8.layers]
    tokens = ref8.logits.argmax(dim=-1).tolist()
    tsp = ref8.own_tsp.cpu() if ref8.own_tsp is not None else None
    return check.judge(ref32, tokens, len(tokens), kept, tsp, n, W)


def one_seed(root, workload: str, seed: int, seconds: float, device: str, log,
             fault: Optional[str] = None) -> Dict:
    _, _, conf, mix = run.load_cell(root, workload)
    cfg, mcfg = run.model_config(conf)
    weights = run.weights_of(conf, seed, device)
    client = run.LOOPS[mix["loop"]](weights, cfg, mcfg, mix, seed, device, run.Spans())
    client.warmup()
    with faults.planted(fault) if fault else contextlib.nullcontext():
        client.window(seconds, None)
    records = client.records
    client.close()
    del client
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    reference = importlib.import_module(f"perfbench.reference.{conf['reference']}")
    prog: List[Dict] = []
    ctrl: List[Dict] = []
    for rec in run.sample(records, seed, mix["check_requests"]):
        t = time.perf_counter()
        follow = run.follow_of(rec, reference)
        ref32 = reference.run(weights, conf["model"], conf["method"], rec.prompt, rec.tokens,
                              follow)
        prog.append(run.judge(ref32, rec, follow, conf))
        if not fault:
            ctrl.append(control_numbers(weights, conf, rec, follow, ref32, reference))
        del ref32
        log(f"seed {seed} request {rec.index} (prompt {len(rec.prompt)}, served "
            f"{len(rec.tokens)}): program {json.dumps(prog[-1])} control "
            f"{json.dumps(ctrl[-1]) if ctrl else 'not run'} in {time.perf_counter() - t:.1f} s")
    out = {"workload": workload, "seed": seed, "requests": len(prog),
           "program": check.worst(prog)}
    if fault:
        limits = run.load_json(root / "perfbench" / "limits" / f"{workload}.json")
        out.update(fault=fault, not_correct=not check.verdict(out["program"], limits))
    else:
        out["control"] = check.worst(ctrl)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from fastkv_tpu_torch.kernels import build

    build.build()

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    log(run.card_line())
    for seed in args.seeds:
        out = one_seed(run.ROOT, args.workload, seed, args.seconds, "cuda", log, args.fault)
        print(json.dumps(out), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
