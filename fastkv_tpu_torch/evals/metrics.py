"""Accuracy metrics for LongBench / RULER / Needle-in-a-Haystack.

The port's own copy of ``fastkv_tpu_torch.evals.metrics``; ``jieba``, ``rouge`` and
``rouge_score`` are imported only by the metrics that need them.

Re-implements the metric math of the reference (reference: eval/metrics.py:47-153,
itself derived from the public LongBench repo) with one dependency change:
`code_sim_score` uses difflib's SequenceMatcher ratio — identical to
fuzzywuzzy's pure-python fallback (fuzzywuzzy wraps SequenceMatcher when
python-Levenshtein is absent), so scores match the reference's common install.
"""

from __future__ import annotations

import difflib
import re
import string
from collections import Counter
from typing import List


def normalize_answer(s: str) -> str:
    """Lowercase, strip punctuation/articles/extra whitespace (SQuAD-style)."""
    s = s.lower()
    s = "".join(ch for ch in s if ch not in set(string.punctuation))
    s = re.sub(r"\b(a|an|the)\b", " ", s)
    return " ".join(s.split())


_CN_PUNCT = (
    "！？｡。＂＃＄％＆＇（）＊＋，－／：；＜＝＞＠［＼］＾＿｀｛｜｝～｟｠｢｣､、〃》「」"
    "『』【】〔〕〖〗〘〙〚〛〜〝〞〟〰〾〿–—‘’‛“”„‟…‧﹏."
)


def normalize_zh_answer(s: str) -> str:
    s = s.lower()
    punct = set(string.punctuation + _CN_PUNCT)
    s = "".join(ch for ch in s if ch not in punct)
    return "".join(s.split())


def _token_f1(pred_tokens, gt_tokens) -> float:
    common = Counter(pred_tokens) & Counter(gt_tokens)
    num_same = sum(common.values())
    if num_same == 0:
        return 0.0
    precision = num_same / len(pred_tokens)
    recall = num_same / len(gt_tokens)
    return 2 * precision * recall / (precision + recall)


def qa_f1_score(prediction: str, ground_truth: str, **kw) -> float:
    return _token_f1(
        normalize_answer(prediction).split(), normalize_answer(ground_truth).split()
    )


def qa_f1_zh_score(prediction: str, ground_truth: str, **kw) -> float:
    import jieba

    pt = [normalize_zh_answer(t) for t in jieba.cut(prediction, cut_all=False)]
    gt = [normalize_zh_answer(t) for t in jieba.cut(ground_truth, cut_all=False)]
    return _token_f1([t for t in pt if t], [t for t in gt if t])


def rouge_score(prediction: str, ground_truth: str, **kw) -> float:
    from rouge import Rouge

    try:
        scores = Rouge().get_scores([prediction], [ground_truth], avg=True)
    except Exception:
        return 0.0
    return scores["rouge-l"]["f"]


def rouge_zh_score(prediction: str, ground_truth: str, **kw) -> float:
    import jieba

    pred = " ".join(jieba.cut(prediction, cut_all=False))
    gt = " ".join(jieba.cut(ground_truth, cut_all=False))
    return rouge_score(pred, gt)


def rouge1_f(
    prediction: str, ground_truth: str, use_stemmer: bool = False, **kw
) -> float:
    """ROUGE-1 f-measure (needle scoring uses rouge_score package's rouge1
    WITH stemming; reference: eval/run_needle_in_haystack.py:21,257-260)."""
    from rouge_score import rouge_scorer

    scorer = rouge_scorer.RougeScorer(["rouge1"], use_stemmer=use_stemmer)
    return scorer.score(ground_truth, prediction)["rouge1"].fmeasure


def classification_score(prediction: str, ground_truth: str, **kw) -> float:
    all_classes = kw["all_classes"]
    matches = [c for c in all_classes if c in prediction]
    # drop class names that are substrings of the gold label (reference quirk:
    # a single removal pass, not a full filter — preserved for parity)
    for m in list(matches):
        if m in ground_truth and m != ground_truth:
            matches.remove(m)
    if ground_truth in matches:
        return 1.0 / len(matches)
    return 0.0


def retrieval_score(prediction: str, ground_truth: str, **kw) -> float:
    gt_id = re.findall(r"Paragraph (\d+)", ground_truth)[0]
    numbers = re.findall(r"\d+", prediction)
    if not numbers:
        return 0.0
    return sum(1 for n in numbers if n == gt_id) / len(numbers)


def retrieval_zh_score(prediction: str, ground_truth: str, **kw) -> float:
    gt_id = re.findall(r"段落(\d+)", ground_truth)[0]
    numbers = re.findall(r"\d+", prediction)
    if not numbers:
        return 0.0
    return sum(1 for n in numbers if n == gt_id) / len(numbers)


def count_score(prediction: str, ground_truth: str, **kw) -> float:
    numbers = re.findall(r"\d+", prediction)
    if not numbers:
        return 0.0
    return sum(1 for n in numbers if n == str(ground_truth)) / len(numbers)


def code_sim_score(prediction: str, ground_truth: str, **kw) -> float:
    for line in prediction.lstrip("\n").split("\n"):
        if "`" not in line and "#" not in line and "//" not in line:
            prediction = line
            break
    else:
        prediction = ""
    ratio = difflib.SequenceMatcher(None, prediction, ground_truth).ratio()
    return round(100 * ratio) / 100


def string_match_all(preds: List[str], refs: List[List[str]]) -> float:
    """RULER metric: fraction of reference strings contained in the prediction,
    averaged over examples, as a percentage (reference: eval/metrics.py:146-153)."""
    per_example = [
        sum(1.0 if r.lower() in p.lower() else 0.0 for r in ref) / len(ref)
        for p, ref in zip(preds, refs)
    ]
    return round(sum(per_example) / len(per_example) * 100, 2)


# LongBench task -> metric dispatch (reference: eval/eval_longbench.py:18-40)
DATASET2METRIC = {
    "narrativeqa": qa_f1_score,
    "qasper": qa_f1_score,
    "multifieldqa_en": qa_f1_score,
    "multifieldqa_zh": qa_f1_zh_score,
    "hotpotqa": qa_f1_score,
    "2wikimqa": qa_f1_score,
    "musique": qa_f1_score,
    "dureader": rouge_zh_score,
    "gov_report": rouge_score,
    "qmsum": rouge_score,
    "multi_news": rouge_score,
    "vcsum": rouge_zh_score,
    "trec": classification_score,
    "triviaqa": qa_f1_score,
    "samsum": rouge_score,
    "lsht": classification_score,
    "passage_count": count_score,
    "passage_retrieval_en": retrieval_score,
    "passage_retrieval_zh": retrieval_zh_score,
    "lcc": code_sim_score,
    "repobench-p": code_sim_score,
}
