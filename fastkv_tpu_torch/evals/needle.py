"""Needle-in-a-Haystack evaluation.

Protocol matches the reference tester (reference: eval/run_needle_in_haystack.py):
  * haystack = concatenated Paul Graham essays, token-trimmed to the target
    context length minus a 200-token buffer (:58, :358-360)
  * needle inserted at depth% with a backwards sentence-boundary snap on the
    newline token for Llama-3 (:373-383)
  * prompt: "<|im_start|> This is a very long story book: <book> {context}
    </book>.\n Based on the content of the book, Question: {q}\nAnswer:" (:189)
  * greedy 30 new tokens, EOS = {eos, "\n"} (:241-248)
  * score = ROUGE-1 f-measure(needle, response) x 10 (:258-260)
  * per-cell JSON results, resumable by (model, length, depth, version) (:305-325)
  * grid: lengths [16000..128000] x depths round(linspace(0, 100, 10)) (:465-466)

Port of ``fastkv_tpu.evals.needle`` over the port's Engine (``--device``; see
``evals.longbench``). ``run_point`` is one cell, for callers with an engine
and a tokenizer of their own; ``score_response`` needs ``rouge_score``, and
``visualize`` pandas (and matplotlib/seaborn for the png), each imported
when called.

CLI:
  python -m fastkv_tpu_torch.evals.needle run --model_path DIR --method fastkv \
      --haystack_dir data/PaulGrahamEssays \
      --context_lengths 16000 32000 [--depth_percents 0 11 ...]
  python -m fastkv_tpu_torch.evals.needle visualize --save_dir outputs/results_needle
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from datetime import datetime, timezone
from typing import List

import numpy as np

NEEDLE = (
    "\nThe best thing to do in San Francisco is eat a sandwich and sit in "
    "Dolores Park on a sunny day.\n"
)
RETRIEVAL_QUESTION = "The best thing to do in San Francisco is: "
FINAL_CONTEXT_BUFFER = 200
DEFAULT_CONTEXT_LENGTHS = [16000, 32000, 48000, 64000, 80000, 96000, 112000, 128000]
DEFAULT_DEPTHS = np.round(np.linspace(0, 100, num=10, endpoint=True)).astype(int).tolist()
# Llama-3 sentence-boundary token ("\n"); reference :374
PERIOD_TOKENS_LLAMA3 = [13]


def read_haystack(haystack_dir: str, tokenizer, max_tokens: int) -> List[int]:
    """Concatenate essays round-robin until the token budget is covered."""
    text = ""
    files = sorted(glob.glob(os.path.join(haystack_dir, "*.txt")))
    if not files:
        raise FileNotFoundError(f"no .txt essays in {haystack_dir}")
    while len(tokenizer.encode(text, add_special_tokens=False)) < max_tokens:
        for path in files:
            with open(path, encoding="utf-8") as f:
                text += f.read()
        if not text:
            break
    return tokenizer.encode(text, add_special_tokens=False)


def build_context(
    haystack_tokens: List[int],
    tokenizer,
    context_length: int,
    depth_percent: float,
    period_tokens=tuple(PERIOD_TOKENS_LLAMA3),
) -> str:
    tokens_context = haystack_tokens[:context_length]
    needle_tokens = tokenizer.encode(NEEDLE, add_special_tokens=False)
    usable = context_length - FINAL_CONTEXT_BUFFER
    if len(tokens_context) + len(needle_tokens) > usable:
        tokens_context = tokens_context[: usable - len(needle_tokens)]
    if depth_percent == 100:
        new_tokens = tokens_context + needle_tokens
    else:
        insertion = int(len(tokens_context) * depth_percent / 100)
        head = tokens_context[:insertion]
        while head and head[-1] not in period_tokens:
            insertion -= 1
            head = tokens_context[:insertion]
        new_tokens = head + needle_tokens + tokens_context[insertion:]
    return tokenizer.decode(new_tokens, skip_special_tokens=True)


def make_prompt(context: str) -> str:
    return (
        f"<|im_start|> This is a very long story book: <book> {context} </book>.\n"
        f" Based on the content of the book, Question: {RETRIEVAL_QUESTION}\nAnswer:"
    )


def result_filename(model_version: str, context_length: int, depth_percent: float) -> str:
    return f"{model_version.replace('.', '_')}_len_{context_length}_depth_{int(depth_percent * 100)}_results.json"


def result_exists(save_dir: str, model_name: str, context_length: int, depth_percent: float, version=1) -> bool:
    if not os.path.isdir(save_dir):
        return False
    for fn in os.listdir(save_dir):
        if not fn.endswith(".json"):
            continue
        try:
            with open(os.path.join(save_dir, fn)) as f:
                r = json.load(f)
        except Exception:
            continue
        if (
            r.get("context_length") == context_length
            and r.get("depth_percent") == depth_percent
            and r.get("version", 1) == version
            and r.get("model") == model_name
        ):
            return True
    return False


def score_response(response: str) -> float:
    if not response:
        return 0.0
    from fastkv_tpu_torch.evals.metrics import rouge1_f

    # reference uses use_stemmer=True (run_needle_in_haystack.py:21)
    return rouge1_f(response, NEEDLE, use_stemmer=True) * 10


def overlap_score(response: str) -> float:
    """The share of the needle's answer words found in the response, x10
    (the reference's rescoring for its heatmap, eval/visualize.py)."""
    words = "eat a sandwich and sit in Dolores Park on a sunny day".lower().split()
    resp = response.lower()
    return sum(1 for w in words if w in resp) / len(words) * 10


def run_point(engine, tokenizer, haystack: List[int], context_length: int,
              depth_percent: float) -> str:
    """One (length, depth) cell: the needle placed in the haystack, the
    prompt, 30 greedy tokens stopped at EOS or a newline; returns the
    stripped response."""
    nl_id = tokenizer.encode("\n", add_special_tokens=False)[-1]
    eos_ids = [tokenizer.eos_token_id, nl_id]
    context = build_context(haystack, tokenizer, context_length, depth_percent)
    ids = tokenizer(make_prompt(context), add_special_tokens=True).input_ids
    gen = engine.generate([ids], max_new_tokens=30, eos_ids=eos_ids)[0]
    return tokenizer.decode(gen, skip_special_tokens=True).strip()


def run(args, engine=None, tokenizer=None) -> None:
    """The grid of ``args.context_lengths`` x ``args.depth_percents``, each
    cell's record written to ``args.save_dir`` (cells already there are
    skipped). ``engine`` and ``tokenizer`` default to ``build_engine(args)``
    and the checkpoint's ``transformers`` tokenizer."""
    from fastkv_tpu_torch.evals.longbench import build_engine

    if tokenizer is None:
        from transformers import AutoTokenizer

        tokenizer = AutoTokenizer.from_pretrained(args.model_path)
    if engine is None:
        engine, _ = build_engine(args)
    os.makedirs(args.save_dir, exist_ok=True)
    model_name = args.model_path
    model_version = os.path.basename(args.model_path.rstrip("/"))

    haystack = read_haystack(args.haystack_dir, tokenizer, max(args.context_lengths))

    for context_length in args.context_lengths:
        for depth in args.depth_percents:
            if result_exists(args.save_dir, model_name, context_length, float(depth)):
                print(f"skip len={context_length} depth={depth}: exists", file=sys.stderr)
                continue
            t0 = time.time()
            response = run_point(engine, tokenizer, haystack, context_length, depth)
            score = score_response(response)
            rec = {
                "model": model_name,
                "context_length": int(context_length),
                "depth_percent": float(depth),
                "version": 1,
                "needle": NEEDLE,
                "model_response": response,
                "score": score,
                "test_duration_seconds": time.time() - t0,
                "test_timestamp_utc": datetime.now(timezone.utc).strftime("%Y-%m-%d %H:%M:%S%z"),
            }
            path = os.path.join(args.save_dir, result_filename(model_version, context_length, depth))
            with open(path, "w") as f:
                json.dump(rec, f, ensure_ascii=False)
            print(
                f"len={context_length} depth={depth} score={score:.2f} "
                f"resp={response[:60]!r}", file=sys.stderr,
            )


def visualize(save_dir: str, out_png: str = None) -> None:
    """Depth x length heatmap with word-overlap rescoring
    (reference: eval/visualize.py:24-87)."""
    import pandas as pd

    rows = []
    for fn in glob.glob(os.path.join(save_dir, "*_results.json")):
        with open(fn) as f:
            r = json.load(f)
        score = overlap_score(r.get("model_response", ""))
        rows.append(
            {
                "context_length": r["context_length"],
                "depth_percent": r["depth_percent"],
                "score": score,
            }
        )
    if not rows:
        print("no results found", file=sys.stderr)
        return
    df = pd.DataFrame(rows)
    pivot = df.pivot_table(
        index="depth_percent", columns="context_length", values="score", aggfunc="mean"
    )
    print(pivot.to_string())
    print(f"overall mean: {df['score'].mean():.3f}")
    if out_png:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import seaborn as sns

        plt.figure(figsize=(12, 6))
        sns.heatmap(pivot, vmin=0, vmax=10, cmap="RdYlGn", annot=True, fmt=".1f")
        plt.title("Needle in a Haystack")
        plt.xlabel("Context length (tokens)")
        plt.ylabel("Needle depth (%)")
        plt.tight_layout()
        plt.savefig(out_png, dpi=150)
        print(f"wrote {out_png}", file=sys.stderr)


def main(argv=None):
    from fastkv_tpu_torch.evals.longbench import add_method_args

    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)
    runp = sub.add_parser("run")
    runp.add_argument("--model_path", required=True)
    runp.add_argument("--haystack_dir", default="data/PaulGrahamEssays")
    runp.add_argument("--save_dir", default="outputs/results_needle")
    runp.add_argument("--context_lengths", nargs="+", type=int, default=DEFAULT_CONTEXT_LENGTHS)
    runp.add_argument("--depth_percents", nargs="+", type=int, default=DEFAULT_DEPTHS)
    add_method_args(runp)
    vizp = sub.add_parser("visualize")
    vizp.add_argument("--save_dir", default="outputs/results_needle")
    vizp.add_argument("--out_png", default=None)
    args = parser.parse_args(argv)

    if args.cmd == "run":
        run(args)
    else:
        visualize(args.save_dir, args.out_png)


if __name__ == "__main__":
    main()
