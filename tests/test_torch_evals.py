"""The port's evals against the JAX package's, on one tiny model directory
(weights, tokenizer, chat template), tokenizer and JSONL, as
tests/test_evals.py drives the JAX package.

* LongBench and RULER: ``run_task`` through each package for FastKV and
  FullKV writes records equal field for field (``pred`` included; float32 on
  the CPU, the JAX side without Pallas); ``score_results_dir`` gives the same
  rows and the same ``results.csv``.
* Needle: ``read_haystack`` and ``build_context`` give the same tokens and
  text; one cell through ``run`` and ``run_point``.
* A bank of ``metrics`` cases gives equal floats.
* ``EngineConfig.debug_checks`` as tests/test_guards.py holds the JAX one: a
  clean run passes, a NaN ``wk`` row raises and names the layer.
"""

import argparse
import json
import os

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from fastkv_tpu.evals import longbench as j_longbench
from fastkv_tpu.evals import metrics as j_metrics
from fastkv_tpu.evals import needle as j_needle
from fastkv_tpu.evals import ruler as j_ruler
from fastkv_tpu_torch.core.config import EngineConfig, Method, MethodConfig, ModelConfig
from fastkv_tpu_torch.engine.generate import Engine
from fastkv_tpu_torch.evals import longbench as t_longbench
from fastkv_tpu_torch.evals import metrics as t_metrics
from fastkv_tpu_torch.evals import needle as t_needle
from fastkv_tpu_torch.evals import ruler as t_ruler
from fastkv_tpu_torch.models.llama import init_params
from fastkv_tpu_torch.utils.testing import make_tiny_model_dir

METHODS = ("fastkv", "fullkv")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    return make_tiny_model_dir(str(tmp_path_factory.mktemp("model")))


@pytest.fixture(scope="module")
def tokenizer(model_dir):
    return transformers.AutoTokenizer.from_pretrained(model_dir)


def engine_args(model_dir, save_dir, data_dir, method, **over):
    ns = argparse.Namespace(
        model_path=model_dir, method=method, window_size=4, kernel_size=5,
        pooling="maxpool", eviction_mode="proportional", max_capacity_prompts=64,
        tsp_len=64, retain_rate=0.25, tsp_rate=0.5, tsp_idx=0, filter_idx=0,
        dtype="float32", use_pallas=False, device="cpu", tp=1, dp=1,
        data_dir=data_dir, save_dir=save_dir, max_num_examples=2,
    )
    for k, v in over.items():
        setattr(ns, k, v)
    return ns


def _records(path):
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def engines(model_dir):
    """Each package's engine for each method, built once: LongBench and
    RULER run the same (bucket, new tokens) programs, which the JAX engine
    compiles once."""
    return {(pkg, method): build(engine_args(model_dir, None, None, method))[0]
            for pkg, build in (("jax", j_longbench.build_engine),
                               ("torch", t_longbench.build_engine))
            for method in METHODS}


def _run_both(model_dir, tokenizer, engines, tmp_path, data_dir, dataset, run_task_pair,
              **over):
    """Each package's runner for each method; returns the two results dirs."""
    dirs = {}
    for pkg, run_task in zip(("jax", "torch"), run_task_pair):
        dirs[pkg] = str(tmp_path / f"results_{pkg}")
        for method in METHODS:
            args = engine_args(model_dir, dirs[pkg], str(data_dir), method, **over)
            run_task(engines[pkg, method], tokenizer, args, dataset)
    for method in METHODS:
        j = _records(os.path.join(dirs["jax"], dataset, f"{method}.json"))
        t = _records(os.path.join(dirs["torch"], dataset, f"{method}.json"))
        assert len(t) == 2 and t == j, method
    return dirs


def test_longbench_records_and_scores_equal_jax(model_dir, tokenizer, engines, tmp_path):
    data_dir = tmp_path / "LongBench"
    data_dir.mkdir()
    with open(data_dir / "multifieldqa_en.jsonl", "w") as f:
        for i in range(2):
            f.write(json.dumps({
                "input": "What is the best thing to do?",
                "context": "The quick brown fox jumps over the lazy dog. " * (30 + 7 * i),
                "answers": ["eat a sandwich"], "length": 300, "dataset": "multifieldqa_en",
                "language": "en", "all_classes": None, "_id": f"id{i}"}) + "\n")
    dirs = _run_both(model_dir, tokenizer, engines, tmp_path, data_dir, "multifieldqa_en",
                     (j_longbench.run_task, t_longbench.run_task))
    rows = {pkg: mod.score_results_dir(d, ["multifieldqa_en"])
            for (pkg, d), mod in zip(dirs.items(), (j_longbench, t_longbench))}
    assert rows["torch"] == rows["jax"]
    by_method = {r[0]: r[1] for r in rows["torch"][1:]}
    assert all(isinstance(by_method[m], float) for m in METHODS)
    assert by_method["snapkv"] == -1
    csvs = [open(os.path.join(d, "results.csv")).read() for d in dirs.values()]
    assert csvs[0] == csvs[1]


def test_ruler_records_and_scores_equal_jax(model_dir, tokenizer, engines, tmp_path):
    data_dir = tmp_path / "RULER"
    (data_dir / "4096").mkdir(parents=True)
    with open(data_dir / "4096" / "niah_single_1.jsonl", "w") as f:
        for i in range(2):
            f.write(json.dumps({
                "index": str(i), "input": "A magic number is hidden. " * (20 + i) + " What is it?",
                "outputs": "['42']" if i == 0 else ["42", "17"], "length": "200"}) + "\n")
    dirs = _run_both(model_dir, tokenizer, engines, tmp_path, data_dir, "niah_single_1",
                     (j_ruler.run_task, t_ruler.run_task), context_length=4096)
    rows = {pkg: mod.score_results_dir(d) for (pkg, d), mod in zip(dirs.items(),
                                                                    (j_ruler, t_ruler))}
    assert rows["torch"] == rows["jax"]
    assert isinstance({r[0]: r[1] for r in rows["torch"][1:]}["fastkv"], float)
    csvs = [open(os.path.join(d, "results.csv")).read() for d in dirs.values()]
    assert csvs[0] == csvs[1]


def test_needle_haystack_and_context_equal_jax(model_dir, tokenizer, engines, tmp_path):
    hay = tmp_path / "essays"
    hay.mkdir()
    (hay / "a.txt").write_text("The dog runs in the park.\n" * 120)
    (hay / "b.txt").write_text("Paris is the capital of France.\n" * 80)
    toks = t_needle.read_haystack(str(hay), tokenizer, 600)
    assert toks == j_needle.read_haystack(str(hay), tokenizer, 600)
    for depth in (0, 50, 100):
        ctx = t_needle.build_context(toks, tokenizer, 400, depth)
        assert ctx == j_needle.build_context(toks, tokenizer, 400, depth)
        assert "Dolores Park" in ctx
    assert t_needle.make_prompt("x") == j_needle.make_prompt("x")
    assert t_needle.DEFAULT_DEPTHS == j_needle.DEFAULT_DEPTHS

    save_dir = str(tmp_path / "results")
    args = engine_args(model_dir, save_dir, None, "fastkv", haystack_dir=str(hay),
                       context_lengths=[400], depth_percents=[50])
    engine = engines["torch", "fastkv"]
    t_needle.run(args, engine=engine, tokenizer=tokenizer)
    [fname] = os.listdir(save_dir)
    rec = json.load(open(os.path.join(save_dir, fname)))
    assert fname == t_needle.result_filename(os.path.basename(model_dir), 400, 50)
    assert rec["model_response"] == t_needle.run_point(engine, tokenizer, toks, 400, 50)
    assert rec["score"] == t_needle.score_response(rec["model_response"])
    assert t_needle.result_exists(save_dir, model_dir, 400, 50.0)
    # 9 of the answer's 12 words ("a" twice) are in the response
    assert t_needle.overlap_score("eat a sandwich and sit in Dolores Park") == 10 * 9 / 12


METRIC_CASES = [
    ("qa_f1_score", "eat a sandwich", "eat a sandwich", {}),
    ("qa_f1_score", "the sandwich", "a sandwich!", {}),
    ("qa_f1_score", "Paris, France", "paris", {}),
    ("qa_f1_zh_score", "巴黎是法国的首都", "法国首都巴黎", {}),
    ("rouge_score", "the cat sat on the mat", "the cat sat", {}),
    ("rouge_score", "", "the cat", {}),
    ("rouge_zh_score", "会议讨论了预算", "会议讨论预算问题", {}),
    ("rouge1_f", "eat a sandwich in Dolores Park", "eating sandwiches in the park",
     {"use_stemmer": True}),
    ("classification_score", "Location and Person", "Location",
     {"all_classes": ["Location", "Person", "Loc"]}),
    ("retrieval_score", "Paragraph 7 or 3", "Paragraph 7", {}),
    ("retrieval_zh_score", "段落2", "段落2", {}),
    ("count_score", "there are 4 paragraphs, not 5", "4", {}),
    ("code_sim_score", "# comment\nreturn x + 1", "return x + 2", {}),
]


@pytest.mark.parametrize("name,pred,gt,kw", METRIC_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(METRIC_CASES)])
def test_metrics_equal_jax(name, pred, gt, kw):
    got = getattr(t_metrics, name)(pred, gt, **kw)
    assert isinstance(got, float) and got == getattr(j_metrics, name)(pred, gt, **kw)


def test_string_match_all_and_task_scores_equal_jax():
    preds, refs = ["the answer is 42.", "nope", "17 and 42"], [["42"], ["42"], ["42", "17"]]
    assert t_metrics.string_match_all(preds, refs) == j_metrics.string_match_all(preds, refs)
    for ds in ("trec", "qasper_e", "passage_count"):
        args = (ds, ["\nLocation\nmore", "4"], [["Location"], ["4"]], ["Location", "Person"])
        assert t_longbench.score_task(*args) == j_longbench.score_task(*args)
        got = t_longbench.score_task_e(args[0], args[1], args[2], [3000, 9000], args[3])
        want = j_longbench.score_task_e(args[0], args[1], args[2], [3000, 9000], args[3])
        assert json.dumps(got) == json.dumps(want)  # the empty bucket is NaN in both
    assert t_longbench.middle_truncate(list(range(10)), 4) == [0, 1, 8, 9]


@pytest.mark.parametrize("tp,dp", [(2, 1), (1, 2)])
def test_parallel_flags_run_a_world(model_dir, tokenizer, engines, tmp_path, tp, dp):
    """The LongBench CLI (``main``) with ``--tp 2`` and with ``--dp 2`` as a
    world of 2 ranks (``utils.testing.longbench_rank``; each loads its shard
    through ``load_params(mesh=)``; under ``--dp`` a batch of one runs whole
    on each replica): rank 0 writes the records, equal to the single
    device's."""
    from fastkv_tpu_torch.parallel.launch import run_world
    from fastkv_tpu_torch.utils.testing import longbench_rank

    data_dir = tmp_path / "LongBench"
    data_dir.mkdir()
    with open(data_dir / "multifieldqa_en.jsonl", "w") as f:
        for i in range(2):
            f.write(json.dumps({
                "input": "Where is the fox?", "context": "The lazy dog sleeps. " * (25 + 9 * i),
                "answers": ["asleep"], "length": 200, "dataset": "multifieldqa_en",
                "language": "en", "all_classes": None, "_id": f"tp{i}"}) + "\n")
    one = str(tmp_path / "one")
    t_longbench.run_task(engines["torch", "fastkv"], tokenizer,
                         engine_args(model_dir, one, str(data_dir), "fastkv"), "multifieldqa_en")
    two = str(tmp_path / "two")
    args = engine_args(model_dir, two, str(data_dir), "fastkv", tp=tp, dp=dp)
    flags = ("window_size", "kernel_size", "pooling", "eviction_mode", "max_capacity_prompts",
             "tsp_len", "retain_rate", "tsp_rate", "tsp_idx", "filter_idx", "dtype", "device",
             "tp", "dp", "method", "max_num_examples")
    argv = ["run", "--model_path", model_dir, "--datasets", "multifieldqa_en", "--data_dir",
            str(data_dir), "--save_dir", two]
    for name in flags:
        argv += [f"--{name}", str(getattr(args, name))]
    wd = str(tmp_path / "world")
    run_world(longbench_rank, 2, wd, (wd, argv))
    want = _records(os.path.join(one, "multifieldqa_en", "fastkv.json"))
    assert len(want) == 2
    assert _records(os.path.join(two, "multifieldqa_en", "fastkv.json")) == want


def _guarded_engine(params, cfg, debug):
    mcfg = MethodConfig(method=Method.FASTKV, eviction_mode="proportional",
                        retain_rate=0.3, tsp_rate=0.5, tsp_idx=1)
    ecfg = EngineConfig(prefill_buckets=(256,), max_new_tokens=8, capacity_align=8,
                        debug_checks=debug)
    return Engine(params, cfg, mcfg, ecfg, device="cpu")


def test_debug_checks_pass_a_clean_run():
    cfg = ModelConfig.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, 200).tolist()
    checked = _guarded_engine(params, cfg, True).generate([prompt], 6)
    assert checked == _guarded_engine(params, cfg, False).generate([prompt], 6)
    assert len(checked[0]) == 6


def test_debug_checks_catch_a_nan_weight_row():
    """A NaN K-projection row raises under debug_checks, naming the layer
    (and silently poisons the tokens without it)."""
    cfg = ModelConfig.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    params["layers"]["wk"] = params["layers"]["wk"].clone()
    params["layers"]["wk"][1, :, 3] = float("nan")  # layer 1, one output channel
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, 200).tolist()
    with pytest.raises(FloatingPointError, match="NaN or Inf") as err:
        _guarded_engine(params, cfg, True).generate([prompt], 4)
    assert "layer 1" in str(err.value)
    assert len(_guarded_engine(params, cfg, False).generate([prompt], 4)[0]) == 4


def test_guard_catches_an_out_of_bounds_gather():
    from fastkv_tpu_torch.policies import selection
    from fastkv_tpu_torch.utils import guards

    x = torch.zeros(1, 5, 3)
    with guards.checking():
        guards.at("prefill layer 2")
        with pytest.raises(IndexError, match="prefill layer 2"):
            selection.gather_tokens(x, torch.tensor([[0, 5]]))
    with pytest.raises(RuntimeError):  # unchecked: torch's own error on the CPU
        selection.gather_tokens(x, torch.tensor([[0, 5]]))
