"""RULER evaluation: runner + scorer (11 synthetic tasks at 4K/8K/16K+).

Protocol matches the reference (reference: eval/run_ruler.py:85-190): the raw
`input` field is chat-template wrapped, greedy 64-token generation, middle
truncation beyond the model cap, per-example JSONL with {prompt, input,
answers, pred, length}; scoring is string_match_all percent
(eval/eval_ruler.py:40-72, eval/metrics.py:146-153).

Robustness fix vs the reference (conscious divergence, SURVEY.md §7): vendored
data files may carry `outputs` as a stringified list ("['uuid']"); the
reference would then iterate characters in string_match_all. We literal_eval
such strings into real lists.

Port of ``fastkv_tpu.evals.ruler`` over the port's Engine (``--device``; see
``evals.longbench``); the records and scores are the JAX package's.

CLI:
  python -m fastkv_tpu_torch.evals.ruler run --model_path DIR --context_length 4096 \
      --data_dir data/RULER [--datasets niah_single_1,...]
  python -m fastkv_tpu_torch.evals.ruler score --results_dir outputs/results_ruler
"""

from __future__ import annotations

import argparse
import ast
import csv
import json
import os
import sys
from typing import List

from fastkv_tpu_torch.evals.longbench import METHOD_ORDER, add_method_args, build_engine, middle_truncate
from fastkv_tpu_torch.evals.longbench_tasks import model_max_len
from fastkv_tpu_torch.evals.metrics import string_match_all

RULER_TASKS = [
    "niah_single_1", "niah_single_2", "niah_single_3", "niah_multikey_1",
    "niah_multikey_2", "niah_multikey_3", "niah_multiquery", "niah_multivalue",
    "cwe", "fwe", "vt",
]
TASK_MAX_GEN = {t: 64 for t in RULER_TASKS}


def parse_outputs(raw) -> List[str]:
    if isinstance(raw, list):
        return [str(x) for x in raw]
    if isinstance(raw, str):
        try:
            val = ast.literal_eval(raw)
            if isinstance(val, list):
                return [str(x) for x in val]
        except (ValueError, SyntaxError):
            pass
        return [raw]
    return [str(raw)]


def run_task(engine, tokenizer, args, dataset: str) -> None:
    data_file = os.path.join(args.data_dir, str(args.context_length), f"{dataset}.jsonl")
    if not os.path.exists(data_file):
        print(f"skip {dataset}: no data at {data_file}", file=sys.stderr)
        return
    cap = model_max_len(args.model_path, args.method)
    examples = []
    with open(data_file, encoding="utf-8") as f:
        for line in f:
            examples.append(json.loads(line))
    if args.max_num_examples:
        examples = examples[: args.max_num_examples]

    out_dir = os.path.join(args.save_dir, dataset)
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{args.method}.json")
    eos_ids = [tokenizer.eos_token_id]

    with open(out_path, "w", encoding="utf-8") as fout:
        for ex in examples:
            prompt = tokenizer.apply_chat_template(
                [{"role": "user", "content": ex["input"]}],
                tokenize=False,
                add_generation_prompt=True,
            )
            ids = tokenizer(prompt, add_special_tokens=True).input_ids
            ids = middle_truncate(ids, cap)
            gen = engine.generate(
                [ids], max_new_tokens=TASK_MAX_GEN[dataset],
                eos_ids=eos_ids, min_new_tokens=1,
            )[0]
            pred = tokenizer.decode(gen, skip_special_tokens=True)
            rec = {
                "prompt": prompt,
                "input": ex["input"],
                "answers": parse_outputs(ex["outputs"]),
                "pred": pred,
                "length": ex.get("length"),
            }
            fout.write(json.dumps(rec, ensure_ascii=False) + "\n")
            fout.flush()
    print(f"wrote {out_path}", file=sys.stderr)


def score_results_dir(results_dir: str) -> List[List]:
    rows = [["dataset"] + RULER_TASKS]
    for method in METHOD_ORDER:
        row = [method]
        for dataset in RULER_TASKS:
            path = os.path.join(results_dir, dataset, f"{method}.json")
            if not os.path.exists(path):
                row.append(-1)
                continue
            try:
                preds, answers = [], []
                with open(path, encoding="utf-8") as f:
                    for line in f:
                        d = json.loads(line)
                        preds.append(d["pred"])
                        answers.append(parse_outputs(d["answers"]))
                score = string_match_all(preds, answers)
                row.append(score)
                with open(os.path.join(results_dir, dataset, "metrics.json"), "w") as f:
                    json.dump({dataset: score}, f, ensure_ascii=False, indent=4)
            except Exception as e:
                print(f"scoring {dataset}/{method} failed: {e}", file=sys.stderr)
                row.append(-1)
        rows.append(row)
    with open(os.path.join(results_dir, "results.csv"), "w") as f:
        csv.writer(f).writerows(rows)
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)
    runp = sub.add_parser("run")
    runp.add_argument("--model_path", required=True)
    runp.add_argument("--datasets", default=",".join(RULER_TASKS))
    runp.add_argument("--context_length", type=int, default=4096)
    runp.add_argument("--data_dir", default="data/RULER")
    runp.add_argument("--save_dir", default="outputs/results_ruler")
    runp.add_argument("--max_num_examples", type=int, default=0)
    add_method_args(runp)
    scorep = sub.add_parser("score")
    scorep.add_argument("--results_dir", default="outputs/results_ruler")
    args = parser.parse_args(argv)

    if args.cmd == "score":
        for row in score_results_dir(args.results_dir):
            print(",".join(str(x) for x in row))
        return

    from transformers import AutoTokenizer

    tokenizer = AutoTokenizer.from_pretrained(args.model_path)
    engine, _ = build_engine(args)
    for dataset in args.datasets.split(","):
        run_task(engine, tokenizer, args, dataset.strip())


if __name__ == "__main__":
    main()
