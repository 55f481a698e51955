"""LongBench evaluation: runner + scorer.

Runner protocol matches the reference (reference: eval/run_longbench.py:95-248):
chat-template wrapping except few-shot/code tasks, middle truncation to the
model context cap (keep first half + last half of tokens), greedy decoding with
min_length = context+1, per-example JSONL outputs with identical keys — so the
reference scorer and ours are interchangeable on each other's outputs.

Scorer matches eval/eval_longbench.py:48-196: per-task metric dispatch, max
over gold answers, x100 rounded to 2, metrics.json per task dir and a
methods x datasets results.csv.

Port of ``fastkv_tpu.evals.longbench``: the same runner, records and
scorer (so either package's scorer reads the other's outputs), over the
port's checkpoint loader and Engine on one device (``--device``, cuda by
default; the JAX package's ``--use_pallas`` and ``FASTKV_PLATFORM`` have no
counterpart: the card runs the kernels, the CPU their plain versions). The
tokenizer comes from ``transformers`` (imported in ``main`` only).

CLI:
  python -m fastkv_tpu_torch.evals.longbench run --model_path DIR --method fastkv \
      --datasets narrativeqa,qasper --data_dir data/LongBench \
      --save_dir outputs/results_longbench [method knobs]
  python -m fastkv_tpu_torch.evals.longbench score --results_dir outputs/results_longbench
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys
from typing import Dict, List, Optional

from fastkv_tpu_torch.evals import metrics as M
from fastkv_tpu_torch.evals.longbench_tasks import (
    ENGLISH_TASKS,
    NO_CHAT_TEMPLATE,
    TASK_MAX_GEN,
    TASK_PROMPT,
    base_task,
    model_max_len,
)

METHOD_ORDER = [
    "fullkv", "streamingllm", "h2o", "snapkv", "pyramidinfer", "gemfilter", "fastkv",
]


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------

def score_task(dataset: str, predictions, answers, all_classes) -> float:
    """Mean over examples of max-over-gold metric, x100 (LongBench standard;
    reference: eval/eval_longbench.py:66-75)."""
    total = 0.0
    for pred, golds in zip(predictions, answers):
        pred = pred.lstrip("\n").split("\n")[0] if base_task(dataset) in ("trec", "triviaqa", "samsum", "lsht") else pred
        best = 0.0
        for gt in golds:
            best = max(best, M.DATASET2METRIC[base_task(dataset)](pred, gt, all_classes=all_classes))
        total += best
    return round(100 * total / max(len(predictions), 1), 2)


def score_task_e(dataset: str, predictions, answers, lengths, all_classes) -> Dict[str, float]:
    """LongBench-E: scores bucketed by example length (0-4k / 4-8k / 8k+),
    matching the reference exactly (reference: eval/eval_longbench.py:48-64)."""
    import numpy as np

    buckets: Dict[str, List[float]] = {"0-4k": [], "4-8k": [], "8k+": []}
    for pred, golds, length in zip(predictions, answers, lengths):
        pred = pred.lstrip("\n").split("\n")[0] if base_task(dataset) in ("trec", "triviaqa", "samsum", "lsht") else pred
        best = 0.0
        for gt in golds:
            best = max(best, M.DATASET2METRIC[base_task(dataset)](pred, gt, all_classes=all_classes))
        if length < 4000:
            buckets["0-4k"].append(best)
        elif length < 8000:
            buckets["4-8k"].append(best)
        else:
            buckets["8k+"].append(best)
    return {
        k: (round(100 * float(np.mean(v)), 2) if v else float("nan"))
        for k, v in buckets.items()
    }


def score_results_dir(
    results_dir: str,
    datasets: Optional[List[str]] = None,
    longbench_e: bool = False,
) -> List[List]:
    """Score all methods x datasets. With longbench_e=True, every cell is the
    length-bucketed scorer_e dict (reference --longbench_e flag,
    eval_longbench.py:46,144-145); the standard run additionally emits the
    scorer_e breakdown for 'qasper' like the reference does (:149-150)."""
    datasets = datasets or sorted(
        d for d in os.listdir(results_dir)
        if os.path.isdir(os.path.join(results_dir, d))
    )
    rows = [["dataset"] + datasets]
    for method in METHOD_ORDER:
        row = [method]
        for dataset in datasets:
            path = os.path.join(results_dir, dataset, f"{method}.json")
            if not os.path.exists(path):
                row.append(-1)
                continue
            try:
                preds, answers, lengths, all_classes = [], [], [], None
                with open(path, encoding="utf-8") as f:
                    for line in f:
                        d = json.loads(line)
                        preds.append(d["pred"])
                        answers.append(d["answers"])
                        all_classes = d["all_classes"]
                        if "length" in d and d["length"] is not None:
                            lengths.append(d["length"])
                metrics: Dict[str, object] = {}
                if longbench_e:
                    score = score_task_e(dataset, preds, answers, lengths, all_classes)
                    row.append(json.dumps(score))
                else:
                    score = score_task(dataset, preds, answers, all_classes)
                    row.append(score)
                    if dataset == "qasper" and len(lengths) == len(preds):
                        metrics["qasper_e"] = score_task_e(
                            dataset, preds, answers, lengths, all_classes
                        )
                metrics[dataset] = score
                with open(os.path.join(results_dir, dataset, "metrics.json"), "w") as f:
                    json.dump(metrics, f, ensure_ascii=False, indent=4)
            except Exception as e:
                print(f"scoring {dataset}/{method} failed: {e}", file=sys.stderr)
                row.append(-1)
        rows.append(row)
    with open(os.path.join(results_dir, "results.csv"), "w") as f:
        csv.writer(f).writerows(rows)
    return rows


# ---------------------------------------------------------------------------
# running
# ---------------------------------------------------------------------------

def middle_truncate(ids: List[int], cap: int) -> List[int]:
    """Keep-first-half + keep-last-half token truncation
    (reference: run_longbench.py:201-207). Preserved: affects accuracy parity."""
    if len(ids) <= cap:
        return ids
    half = cap // 2
    return ids[:half] + ids[-half:]


def method_config(args):
    """The MethodConfig of the CLIs' method flags (``add_method_args``)."""
    from fastkv_tpu_torch.core.config import Method, MethodConfig

    return MethodConfig(
        method=Method(args.method),
        window_size=args.window_size,
        kernel_size=args.kernel_size,
        pooling=args.pooling,
        eviction_mode=args.eviction_mode,
        max_capacity_prompt=args.max_capacity_prompts,
        tsp_len=args.tsp_len,
        retain_rate=args.retain_rate,
        tsp_rate=args.tsp_rate,
        tsp_idx=args.tsp_idx,
        filter_idx=args.filter_idx,
    )


def build_engine(args):
    """(Engine over the checkpoint at ``args.model_path`` on ``args.device``,
    its mesh or None). With ``--tp``/``--dp`` above 1 the process joins the
    group its environment names (``engine.serve.init_distributed``: every
    rank runs this CLI) and loads its shard onto ``ParallelConfig(data=dp,
    model=tp)``, as the JAX package's ``build_engine`` does; rank 0 writes
    the outputs (``run_task``)."""
    from fastkv_tpu_torch.core.config import EngineConfig, ParallelConfig
    from fastkv_tpu_torch.core.weights import load_params, model_config_from_dir
    from fastkv_tpu_torch.engine.generate import Engine

    cfg = model_config_from_dir(args.model_path, dtype=args.dtype)
    mesh = None
    if args.tp > 1 or args.dp > 1:
        from fastkv_tpu_torch.engine.serve import init_distributed
        from fastkv_tpu_torch.parallel.sharding import make_mesh

        init_distributed(device=args.device)
        mesh = make_mesh(ParallelConfig(data=args.dp, model=args.tp), args.device)
    params = load_params(args.model_path, cfg, device=args.device, mesh=mesh)
    eng = Engine(params, cfg, method_config(args), EngineConfig(),
                 device=None if mesh is not None else args.device, mesh=mesh)
    return eng, mesh


def run_task(engine, tokenizer, args, dataset: str) -> None:
    data_file = os.path.join(args.data_dir, f"{dataset}.jsonl")
    if not os.path.exists(data_file):
        print(f"skip {dataset}: no data at {data_file}", file=sys.stderr)
        return
    cap = model_max_len(args.model_path, args.method)
    max_gen = TASK_MAX_GEN[base_task(dataset)]
    template = TASK_PROMPT[base_task(dataset)]

    examples = []
    with open(data_file, encoding="utf-8") as f:
        for line in f:
            examples.append(json.loads(line))
    if args.max_num_examples:
        examples = examples[: args.max_num_examples]

    out_dir = os.path.join(args.save_dir, dataset)
    out_path = os.path.join(out_dir, f"{args.method}.json")
    # every rank of a mesh generates; rank 0 writes
    write = engine.mesh is None or engine.mesh.rank == 0
    if write:
        os.makedirs(out_dir, exist_ok=True)

    eos_ids = [tokenizer.eos_token_id]
    extra = tokenizer.convert_tokens_to_ids("<|eot_id|>")
    if isinstance(extra, int) and extra >= 0 and extra != eos_ids[0]:
        eos_ids.append(extra)

    with (open(out_path, "w", encoding="utf-8") if write else open(os.devnull, "w")) as fout:
        for ex in examples:
            prompt = template.format(**ex)
            if base_task(dataset) not in NO_CHAT_TEMPLATE:
                prompt = tokenizer.apply_chat_template(
                    [{"role": "user", "content": prompt}],
                    tokenize=False,
                    add_generation_prompt=True,
                )
            ids = tokenizer(prompt, add_special_tokens=True).input_ids
            ids = middle_truncate(ids, cap)
            gen = engine.generate(
                [ids], max_new_tokens=max_gen, eos_ids=eos_ids, min_new_tokens=1
            )[0]
            pred = tokenizer.decode(gen, skip_special_tokens=True)
            rec = {
                "prompt": prompt,
                "input": ex.get("input"),
                "context": ex.get("context"),
                "answers": ex.get("answers"),
                "pred": pred,
                "length": ex.get("length"),
                "dataset": dataset,
                "language": ex.get("language"),
                "all_classes": ex.get("all_classes"),
                "_id": ex.get("_id"),
            }
            fout.write(json.dumps(rec, ensure_ascii=False) + "\n")
            fout.flush()
    if write:
        print(f"wrote {out_path}", file=sys.stderr)


def add_method_args(p: argparse.ArgumentParser):
    p.add_argument("--method", default="fastkv", choices=METHOD_ORDER)
    p.add_argument("--window_size", type=int, default=8)
    p.add_argument("--kernel_size", type=int, default=7)
    p.add_argument("--pooling", default="maxpool")
    p.add_argument("--eviction_mode", default="proportional")
    p.add_argument("--max_capacity_prompts", type=int, default=512)
    p.add_argument("--tsp_len", type=int, default=2048)
    p.add_argument("--retain_rate", type=float, default=0.1)
    p.add_argument("--tsp_rate", type=float, default=0.2)
    p.add_argument("--tsp_idx", type=int, default=15)
    p.add_argument("--filter_idx", type=int, default=13)
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu (their plain "
                   "versions, for tests)")
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--dp", type=int, default=1)


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)
    runp = sub.add_parser("run")
    runp.add_argument("--model_path", required=True)
    runp.add_argument("--datasets", default=",".join(ENGLISH_TASKS))
    runp.add_argument("--data_dir", default="data/LongBench")
    runp.add_argument("--save_dir", default="outputs/results_longbench")
    runp.add_argument("--max_num_examples", type=int, default=0)
    add_method_args(runp)
    scorep = sub.add_parser("score")
    scorep.add_argument("--results_dir", default="outputs/results_longbench")
    scorep.add_argument("--longbench_e", action="store_true", help="length-bucketed scorer_e (reference eval_longbench.py:46)")
    args = parser.parse_args(argv)

    if args.cmd == "score":
        rows = score_results_dir(args.results_dir, longbench_e=args.longbench_e)
        for row in rows:
            print(",".join(str(x) for x in row))
        return

    from transformers import AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(args.model_path)
    engine, _ = build_engine(args)
    for dataset in args.datasets.split(","):
        run_task(engine, tokenizer, args, dataset.strip())


if __name__ == "__main__":
    main()
