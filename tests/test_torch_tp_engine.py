"""Tensor and pipeline parallelism of the port against the JAX package's
single device, on the CPU.

The port's ranks are processes (spawned) in a gloo world that meets through a
``FileStore`` under ``tmp_path``; one world of each size serves every case of
that size (``utils.testing.mesh_rank_cases``), and each rank holds its shard
of the params (``parallel.sharding.shard_params``).

  * world of 2, model 2: all seven methods' prefill and ``Engine.generate``,
    FastKV with int8 weights, FastKV on a tiny Mistral (``sliding_window``
    48), a Scheduler replica (FastKV, chunked admission) on
    ``tests/test_serve.py``'s stack, and ``load_params(mesh=)``;
  * world of 4: model 4; data 2 x model 2; model 2 x pipe 2 for every method
    (FastKV with its TSP layer the last of stage 0, ``tsp_idx`` 1, and the
    first of stage 1, ``tsp_idx`` 2); seq 2 x model 2 under the ring (FastKV
    and H2O); a Scheduler replica at model 2 x pipe 2; ``load_params`` at
    model 2 x pipe 2.

The reference is the JAX package's single device (``use_pallas=False``) on
``tests/test_sharding.py``'s setup: ``tiny(num_kv_heads=4, num_heads=8,
hidden_size=128, intermediate_size=256)``. Required of every rank: its cache
(positions and validity exactly, K/V within 2e-4) equal to its slice of the
single device's cache (``sharding.cache_pspec``: its data replica's rows, its
model rank's cache heads, its stage's layers; H2O's in position order,
``utils.testing.cache_by_position``), its logits within 2e-4 (float32 sums
split over the ranks: the JAX TP tests' own tolerance) and bit-identical to
every other rank's of its data replica, the greedy tokens equal; int8
weights: logits within 1e-5 and the same argmax (``tests/test_sharding.py``'s
int8 tolerance); the Schedulers' tokens equal to the JAX Scheduler's.
"""

import dataclasses
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastkv_tpu.core import config as jcfg
from fastkv_tpu.core.quant import quantize_params_int8 as j_quantize_int8
from fastkv_tpu.engine import gemfilter as jgem
from fastkv_tpu.engine import prefill as jpm
from fastkv_tpu.engine import pyramid as jpyr
from fastkv_tpu.engine.generate import Engine as JEngine
from fastkv_tpu.engine.scheduler import Scheduler as JScheduler
from fastkv_tpu.models.llama import init_params as j_init_params
from fastkv_tpu.parallel import sharding as jsh
from fastkv_tpu_torch.core import config as tcfg
from fastkv_tpu_torch.core.weights import model_config_from_dir
from fastkv_tpu_torch.models.llama import params_from_numpy
from fastkv_tpu_torch.parallel import sharding as tsh
from fastkv_tpu_torch.parallel.launch import run_world
from fastkv_tpu_torch.utils.testing import cache_by_position, mesh_rank_cases, write_model_dir

ROOT = Path(__file__).resolve().parents[1]
BUCKET, MAX_NEW, GEN = 256, 8, 6
TOL, INT8_TOL = 2e-4, 1e-5
CFG_KW = dict(num_kv_heads=4, num_heads=8, hidden_size=128, intermediate_size=256)
METHOD_KW = dict(eviction_mode="proportional", retain_rate=0.25, tsp_rate=0.5, tsp_idx=1,
                 filter_idx=2)
METHODS = ("fullkv", "fastkv", "snapkv", "h2o", "streamingllm", "gemfilter", "pyramidinfer")
# the serving stack of tests/test_serve.py, chunked
SERVE_KW = dict(eviction_mode="proportional", retain_rate=0.3, tsp_rate=0.5, tsp_idx=1)
SCHED_KW = dict(max_batch=2, bucket=256, max_new_tokens=8)
# unequal budgets: a request that retires early frees its slot while the
# other decodes, and the next admission runs chunk-wise
BUDGETS = (8, 3, 8, 5, 8, 6)

# (world, pcfg kwargs, reference key): a reference key is a method, or
# method:variant for "int8", "mistral" and "tsp2" (tsp_idx 2)
ENGINE_CASES = (
    [(2, dict(model=2), m) for m in METHODS]
    + [(2, dict(model=2), "fastkv:int8"), (2, dict(model=2), "fastkv:mistral")]
    + [(4, dict(model=4), "fastkv"), (4, dict(model=4), "snapkv"),
       (4, dict(data=2, model=2), "fastkv")]
    + [(4, dict(model=2, pipe=2), m) for m in METHODS]
    + [(4, dict(model=2, pipe=2), "fastkv:tsp2"),
       (4, dict(seq=2, model=2, sp_mode="ring"), "fastkv"),
       (4, dict(seq=2, model=2, sp_mode="ring"), "h2o")]
)
SCHED_CASES = ((2, dict(model=2)), (4, dict(model=2, pipe=2)))
LOAD_CASES = ((2, dict(model=2)), (4, dict(model=2, pipe=2)))


def _method(pkg, key):
    method, _, variant = key.partition(":")
    if method == "pyramidinfer":
        # llama_35 with exceed 4: the pyramid shrinks and decode evicts
        path = ROOT / pkg.__name__.split(".")[0] / "configs" / "pyramidinfer" / "llama_35.json"
        return dataclasses.replace(pkg.MethodConfig().with_pyramidinfer_json(str(path)),
                                   pyramid_exceed_length_to_compress=4)
    kw = dict(METHOD_KW, tsp_idx=2) if variant == "tsp2" else METHOD_KW
    return pkg.MethodConfig(method=pkg.Method(method), **kw)


def _jax_run(cj, mj, ej, pj, tokens, n_true, prompts):
    """The JAX single device's last-token logits, cache and greedy tokens."""
    t, n = jnp.asarray(tokens), jnp.asarray(n_true)
    if mj.method == jcfg.Method.GEMFILTER:
        cap = jgem.filter_capacity(mj, BUCKET, ej.capacity_align)
        m2 = dataclasses.replace(mj, method=jcfg.Method.FULLKV)
        shapes = jpm.plan_shapes(cj, m2, ej, cap)
        nt, nn, _ = jax.jit(lambda p, t, n: jgem.select_tokens(p, cj, mj, ej, t, n, cap))(pj, t, n)
        logits, cache = jax.jit(lambda p, t, n: jpm.prefill(p, cj, m2, ej, shapes, t, n))(
            pj, nt, nn)
    elif mj.method == jcfg.Method.PYRAMIDINFER:
        shapes = jpm.plan_shapes(cj, mj, ej, BUCKET)
        logits, cache = jax.jit(lambda p, t, n: jpyr.prefill(p, cj, mj, ej, shapes, t, n))(
            pj, t, n)
    else:
        shapes = jpm.plan_shapes(cj, mj, ej, BUCKET)
        logits, cache = jax.jit(lambda p, t, n: jpm.prefill(p, cj, mj, ej, shapes, t, n))(
            pj, t, n)
    return dict(logits=np.asarray(logits), pos=np.asarray(cache.pos),
                valid=np.asarray(cache.valid), k=np.asarray(cache.k), v=np.asarray(cache.v),
                tokens=JEngine(pj, cj, mj, ej).generate(prompts, GEN))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    cj, ct = jcfg.ModelConfig.tiny(**CFG_KW), tcfg.ModelConfig.tiny(**CFG_KW)
    pj = j_init_params(cj, seed=0)
    params = jax.tree_util.tree_map(np.asarray, pj)
    q_params = jax.tree_util.tree_map(np.asarray, j_quantize_int8(pj))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cj.vocab_size, (2, BUCKET)).astype(np.int32)
    n_true = np.array([230, 180], np.int32)
    prompts = [tokens[i, :n].tolist() for i, n in enumerate(n_true)]
    ej = jcfg.EngineConfig(prefill_buckets=(BUCKET,), max_new_tokens=MAX_NEW,
                           use_pallas=False, capacity_align=8)
    refs = {}
    for key in sorted({c[2] for c in ENGINE_CASES}):
        variant = key.partition(":")[2]
        c = jcfg.ModelConfig.tiny(sliding_window=48, **CFG_KW) if variant == "mistral" else cj
        p = j_quantize_int8(pj) if variant == "int8" else pj
        refs[key] = _jax_run(c, _method(jcfg, key), ej, p, tokens, n_true, prompts)

    # the serving stack: tiny(), FastKV, 64-token chunks at bucket 256
    sj, st = jcfg.ModelConfig.tiny(), tcfg.ModelConfig.tiny()
    s_pj = j_init_params(sj, seed=0)
    srng = np.random.default_rng(3)
    s_prompts = [srng.integers(0, sj.vocab_size, size=int(n)).tolist()
                 for n in srng.integers(40, 200, size=6)]
    js = JScheduler(s_pj, sj, jcfg.MethodConfig(method=jcfg.Method.FASTKV, **SERVE_KW),
                    jcfg.EngineConfig(prefill_buckets=(256,), capacity_align=8, use_pallas=False,
                                      prefill_chunk=64), **SCHED_KW)
    ids = [js.submit(p, n) for p, n in zip(s_prompts, BUDGETS)]
    done = {r.req_id: r.tokens for r in js.run()}
    serve_ref = [list(map(int, done[i])) for i in ids]

    model_dir = str(tmp_path_factory.mktemp("tp_ckpt") / "tiny")
    write_model_dir(ct, params_from_numpy(ct, params, device="cpu"), model_dir,
                    dtype="float32")
    return dict(ct=ct, params=params, q_params=q_params, tokens=tokens, n_true=n_true,
                prompts=prompts, refs=refs, st=st,
                s_params=jax.tree_util.tree_map(np.asarray, s_pj), s_prompts=s_prompts,
                serve_ref=serve_ref, model_dir=model_dir)


def _world_cases(world, su):
    """Every case of one world, in a fixed order: engine, scheduler, load."""
    ct = su["ct"]
    et = tcfg.EngineConfig(prefill_buckets=(BUCKET,), max_new_tokens=MAX_NEW, capacity_align=8)
    cases = []
    for w, kw, key in ENGINE_CASES:
        if w != world:
            continue
        variant = key.partition(":")[2]
        case = dict(pcfg=tcfg.ParallelConfig(**kw), mcfg=_method(tcfg, key), ecfg=et,
                    tokens=su["tokens"], n_true=su["n_true"], prompts=su["prompts"],
                    max_new=GEN)
        if variant == "int8":
            case.update(params=su["q_params"], params_key="int8")
        elif variant == "mistral":
            case.update(cfg=tcfg.ModelConfig.tiny(sliding_window=48, **CFG_KW))
        cases.append(case)
    for w, kw in SCHED_CASES:
        if w == world:
            cases.append(dict(
                kind="scheduler", pcfg=tcfg.ParallelConfig(**kw), cfg=su["st"],
                params=su["s_params"], params_key="serve",
                mcfg=tcfg.MethodConfig(method=tcfg.Method.FASTKV, **SERVE_KW),
                ecfg=tcfg.EngineConfig(prefill_buckets=(256,), capacity_align=8,
                                       prefill_chunk=64),
                sched_kw=SCHED_KW, prompts=su["s_prompts"], budgets=BUDGETS))
    for w, kw in LOAD_CASES:
        if w == world:
            cases.append(dict(kind="load", pcfg=tcfg.ParallelConfig(**kw),
                              cfg=model_config_from_dir(su["model_dir"], dtype="float32"),
                              model_dir=su["model_dir"]))
    return cases


@pytest.fixture(scope="module")
def worlds(setup, tmp_path_factory):
    """{world size: [per rank: [per case of that world: outputs]]}."""
    out = {}
    for world in (2, 4):
        wd = str(tmp_path_factory.mktemp(f"tp_world{world}"))
        run_world(mesh_rank_cases, world, wd,
                  (wd, setup["ct"], setup["params"], _world_cases(world, setup)))
        out[world] = []
        for r in range(world):
            with open(f"{wd}/rank{r}.pkl", "rb") as f:
                out[world].append(pickle.load(f))
    return out


def _index(world, kind, item):
    """The place of a case among its world's outputs (_world_cases' order)."""
    eng = [c for c in ENGINE_CASES if c[0] == world]
    sched = [c for c in SCHED_CASES if c[0] == world]
    load = [c for c in LOAD_CASES if c[0] == world]
    if kind == "engine":
        return eng.index(item)
    if kind == "scheduler":
        return len(eng) + sched.index(item)
    return len(eng) + len(sched) + load.index(item)


def _slice(arr, spec, pcfg, place):
    return arr[tsh.slices(arr.shape, spec, pcfg, place)]


def _case_id(c):
    return f"w{c[0]}-" + "x".join(f"{k}{v}" for k, v in c[1].items()) + f"-{c[2]}"


@pytest.mark.parametrize("case", ENGINE_CASES, ids=[_case_id(c) for c in ENGINE_CASES])
def test_tp_matches_jax_single_device(setup, worlds, case):
    world, kw, key = case
    pcfg = tcfg.ParallelConfig(**kw)
    ref = setup["refs"][key]
    spec = tsh.cache_pspec()
    outs = [ranks[_index(world, "engine", case)] for ranks in worlds[world]]
    int8 = key.endswith(":int8")
    for o in outs:
        place, rows = o["place"], slice(*o["rows"])
        want = {name: _slice(ref[name], getattr(spec, name), pcfg, place)
                for name in ("pos", "valid", "k", "v")}
        got = o
        if key.startswith("h2o"):  # its cache holds kept tokens in score order
            want, got = cache_by_position(want), cache_by_position(o)
        np.testing.assert_array_equal(got["pos"], want["pos"])
        np.testing.assert_array_equal(got["valid"], want["valid"])
        np.testing.assert_allclose(got["k"], want["k"], atol=TOL, rtol=TOL)
        np.testing.assert_allclose(got["v"], want["v"], atol=TOL, rtol=TOL)
        if int8:
            np.testing.assert_allclose(o["logits"], ref["logits"][rows], atol=INT8_TOL)
            np.testing.assert_array_equal(o["logits"].argmax(-1), ref["logits"][rows].argmax(-1))
        else:
            np.testing.assert_allclose(o["logits"], ref["logits"][rows], atol=TOL, rtol=TOL)
        assert o["tokens"] == ref["tokens"]
    # the ranks of a data replica hold the same bits
    for o in outs:
        same = [p for p in outs if p["place"]["data"] == o["place"]["data"]]
        assert all(np.array_equal(o["logits"], p["logits"]) for p in same)


@pytest.mark.parametrize("case", SCHED_CASES, ids=[_case_id(c + ("fastkv_chunk64",))
                                                   for c in SCHED_CASES])
def test_scheduler_replica_matches_jax_scheduler(setup, worlds, case):
    world = case[0]
    outs = [ranks[_index(world, "scheduler", case)] for ranks in worlds[world]]
    for o in outs:
        assert o["tokens"] == setup["serve_ref"]
        assert o["events"] == outs[0]["events"]
    assert "chunk" in outs[0]["events"]  # admissions ran chunk-wise


@pytest.mark.parametrize("case", LOAD_CASES, ids=[_case_id(c + ("load",)) for c in LOAD_CASES])
def test_load_params_reads_each_ranks_slice(setup, worlds, case):
    world, kw = case
    pcfg = tcfg.ParallelConfig(**kw)
    whole = setup["params"]
    specs = tsh.full_param_pspecs(setup["ct"])
    for ranks in worlds[world]:
        o = ranks[_index(world, "load", case)]
        for k, spec in specs.items():
            if k == "layers":
                for lk, lspec in spec.items():
                    np.testing.assert_array_equal(
                        o["leaves"]["layers"][lk],
                        _slice(np.asarray(whole["layers"][lk]), lspec, pcfg, o["place"]))
            else:
                np.testing.assert_array_equal(o["leaves"][k],
                                              _slice(np.asarray(whole[k]), spec, pcfg, o["place"]))


@pytest.mark.parametrize("kw", [dict(model=2, pipe=2), dict(data=2, model=2, seq=2),
                                dict(model=4, pipe=2), dict(data=2, seq=2, pipe=2)])
def test_rank_layout_is_jax_device_order(kw):
    jp = jcfg.ParallelConfig(**kw)
    mesh = jsh.make_mesh(jp, jax.devices("cpu"))
    ids = np.vectorize(lambda d: d.id)(mesh.devices)[..., 0]  # drop the expert stub
    assert mesh.axis_names[:4] == tsh.AXES
    np.testing.assert_array_equal(tsh.rank_grid(tcfg.ParallelConfig(**kw)), ids)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("tie", [False, True])
def test_specs_equal_jax(quantized, tie):
    ct, cj = tcfg.ModelConfig.tiny(**CFG_KW), jcfg.ModelConfig.tiny(**CFG_KW)
    P = jax.sharding.PartitionSpec

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, prefix + k + "."))
            else:
                out[prefix + k] = tuple(v)
        return out

    want = flat(jsh.full_param_pspecs(cj, tie=tie, quantized=quantized))
    assert flat(tsh.full_param_pspecs(ct, tie=tie, quantized=quantized)) == want
    jc, tc = jsh.cache_pspec(quantized), tsh.cache_pspec(quantized)
    for name in tc._fields:
        j, t = getattr(jc, name), getattr(tc, name)
        assert (None if j is None else tuple(j)) == t, name
        assert j is None or isinstance(j, P)


def test_shard_params_mirrors_a_partial_int8_tree():
    """``quantize_params_int8(quantize_embed=False)`` has no embedding or
    head scales; the shard mirrors the tree as it stands (JAX
    ``test_shard_params_partial_quant_tree``)."""
    cj, ct = jcfg.ModelConfig.tiny(**CFG_KW), tcfg.ModelConfig.tiny(**CFG_KW)
    tree = jax.tree_util.tree_map(
        np.asarray, j_quantize_int8(j_init_params(cj, seed=0), quantize_embed=False))
    params = params_from_numpy(ct, tree, device="cpu")
    assert "embed_scale" not in params and "wq_scale" in params["layers"]
    pcfg = tcfg.ParallelConfig(model=2, pipe=2)
    mesh = tsh.Mesh(pcfg, 3, torch.device("cpu"), 0, 0, None, (), None, (), model_index=1,
                    pipe_index=1)
    got = tsh.shard_params(params, mesh, ct)
    assert set(got) == set(params) and set(got["layers"]) == set(params["layers"])
    assert got["layers"]["wq"].shape == (2, 128, 64)  # layers 2-3, query columns 64-127
    assert torch.equal(got["layers"]["wq"], params["layers"]["wq"][2:, :, 64:])
    assert torch.equal(got["layers"]["wq_scale"], params["layers"]["wq_scale"][2:, :, 64:])
    assert torch.equal(got["layers"]["wo_scale"], params["layers"]["wo_scale"][2:])
    assert torch.equal(got["layers"]["w_down"], params["layers"]["w_down"][2:, 128:])
    assert torch.equal(got["lm_head"], params["lm_head"][:, 128:])
    assert got["embed"] is params["embed"]


@pytest.mark.parametrize("kw,field", [
    (dict(num_kv_heads=2, num_heads=8), "num_kv_heads"),
    (dict(num_kv_heads=4, num_heads=6), "num_heads"),
    (dict(intermediate_size=130), "intermediate_size"),
    (dict(vocab_size=258), "vocab_size"),
    (dict(num_layers=3), "num_layers"),
])
def test_parallel_config_refuses_what_does_not_split(kw, field):
    pcfg = tcfg.ParallelConfig(model=4, pipe=2)
    base = dict(CFG_KW, **kw)
    with pytest.raises(ValueError, match=field):
        pcfg.check_model(tcfg.ModelConfig.tiny(**base))
    if field == "vocab_size":  # a tied head is replicated: its vocabulary need not split
        pcfg.check_model(tcfg.ModelConfig.tiny(tie_word_embeddings=True, **base))
    with pytest.raises(ValueError, match="expert"):
        tcfg.ParallelConfig(expert=2)
