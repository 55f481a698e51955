"""Sequence-parallel prefill and Engine.generate of the port against the JAX
package's single-device run, on the CPU.

The port's ranks are processes (``torch.multiprocessing``, spawned) in a gloo
world that meets through a ``FileStore`` under ``tmp_path``, so parallel test
workers never share a port. One world serves several cases
(``utils.testing.mesh_rank_cases``): a world of 2 ranks for ring and Ulysses at
seq 2 (FastKV, FullKV, H2O; SnapKV and StreamingLLM under the ring), a world of
4 for the ring at seq 4 and data 2 x seq 2 (FastKV, FullKV). H2O's scores sum
every row's probabilities over the whole sequence: each rank sums its own
rows, and the partial sums are folded over the seq group. Each rank holds
the prefill of its data replica's rows and the whole batch's greedy tokens.

The reference is the JAX package's single-device prefill and greedy decode
(``use_pallas=False``) on the setup of ``tests/test_sp_engine.py``. Required:
cache positions and validity equal on every rank (the keep-sets, TSP's
included, are the single device's), last-token logits and cache K/V within
2e-4 (float32, the sequence summed in another order: the JAX SP tests' own
tolerance), greedy tokens equal. H2O's cache is compared in position order
(``utils.testing.cache_by_position``).
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fastkv_tpu.core import config as jcfg
from fastkv_tpu.engine import decode as jdec
from fastkv_tpu.engine import prefill as jpm
from fastkv_tpu.models.llama import init_params as j_init_params
from fastkv_tpu_torch.core import config as tcfg
from fastkv_tpu_torch.parallel.launch import run_world
from fastkv_tpu_torch.parallel.sharding import make_mesh
from fastkv_tpu_torch.utils.testing import cache_by_position, mesh_rank_cases
from fastkv_tpu_torch.utils.testing import one_thread_per_module

_one_torch_thread = one_thread_per_module()

BUCKET, MAX_NEW, GEN = 256, 8, 6
TOL = 2e-4
CFG_KW = dict(num_kv_heads=4, num_heads=8, hidden_size=128, intermediate_size=256)
METHOD_KW = dict(eviction_mode="proportional", retain_rate=0.25, tsp_rate=0.5, tsp_idx=1)
# (world, sp_mode, data, seq, method)
CASES = [
    (2, "ring", 1, 2, "fastkv"),
    (2, "ring", 1, 2, "fullkv"),
    (2, "ring", 1, 2, "snapkv"),
    (2, "ring", 1, 2, "streamingllm"),
    (2, "ulysses", 1, 2, "fastkv"),
    (2, "ulysses", 1, 2, "fullkv"),
    (2, "ring", 1, 2, "h2o"),
    (2, "ulysses", 1, 2, "h2o"),
    (4, "ring", 1, 4, "fastkv"),
    (4, "ring", 1, 4, "fullkv"),
    (4, "ring", 2, 2, "fastkv"),
    (4, "ring", 2, 2, "fullkv"),
]


@pytest.fixture(scope="module")
def setup():
    cj = jcfg.ModelConfig.tiny(**CFG_KW)
    ct = tcfg.ModelConfig.tiny(**CFG_KW)
    params = jax.tree_util.tree_map(np.asarray, j_init_params(cj, seed=0))
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cj.vocab_size, (2, BUCKET)).astype(np.int32)
    n_true = np.array([256, 230], np.int32)
    prompts = [tokens[i, :n].tolist() for i, n in enumerate(n_true)]
    ej = jcfg.EngineConfig(prefill_buckets=(BUCKET,), max_new_tokens=MAX_NEW,
                           use_pallas=False, capacity_align=8)
    refs = {}
    for method in sorted({c[-1] for c in CASES}):
        mj = jcfg.MethodConfig(method=jcfg.Method(method), **METHOD_KW)
        shapes = jpm.plan_shapes(cj, mj, ej, BUCKET)
        logits, cache = jax.jit(lambda p, t, n, mj=mj, shapes=shapes: jpm.prefill(
            p, cj, mj, ej, shapes, t, n))(params, jnp.asarray(tokens), jnp.asarray(n_true))
        res, _ = jax.jit(lambda p, fl, c, n, mj=mj, shapes=shapes: jdec.greedy_generate(
            p, cj, mj, shapes, fl, c, n, GEN))(params, logits, cache, jnp.asarray(n_true))
        toks, nums = np.asarray(res.tokens), np.asarray(res.num_generated)
        refs[method] = dict(logits=np.asarray(logits), pos=np.asarray(cache.pos),
                            valid=np.asarray(cache.valid), k=np.asarray(cache.k),
                            v=np.asarray(cache.v),
                            tokens=[toks[i, :nums[i]].tolist() for i in range(len(toks))])
    return ct, params, tokens, n_true, prompts, refs


@pytest.fixture(scope="module")
def worlds(setup, tmp_path_factory):
    """{world size: [per rank: [per case of that world: outputs]]}."""
    ct, params, tokens, n_true, prompts, _ = setup
    et = tcfg.EngineConfig(prefill_buckets=(BUCKET,), max_new_tokens=MAX_NEW, capacity_align=8)
    out = {}
    for world in sorted({c[0] for c in CASES}):
        cases = [dict(pcfg=tcfg.ParallelConfig(data=d, seq=s, sp_mode=mode),
                      mcfg=tcfg.MethodConfig(method=tcfg.Method(m), **METHOD_KW), ecfg=et,
                      tokens=tokens, n_true=n_true, prompts=prompts, max_new=GEN)
                 for w, mode, d, s, m in CASES if w == world]
        wd = str(tmp_path_factory.mktemp(f"sp_world{world}"))
        run_world(mesh_rank_cases, world, wd, (wd, ct, params, cases))
        out[world] = []
        for r in range(world):
            with open(f"{wd}/rank{r}.pkl", "rb") as f:
                out[world].append(pickle.load(f))
    return out


@pytest.mark.parametrize("world,mode,data,seq,method", CASES,
                         ids=[f"{m}-{mode}-d{d}s{s}" for _, mode, d, s, m in CASES])
def test_sp_matches_jax_single_device(setup, worlds, world, mode, data, seq, method):
    ref = setup[-1][method]
    idx = [c for c in CASES if c[0] == world].index((world, mode, data, seq, method))
    for rank, outs in enumerate(worlds[world]):
        o = outs[idx]
        rows = slice(*o["rows"])
        if method == "h2o":  # its cache holds kept tokens in score order
            o = cache_by_position(o)
            ref = cache_by_position(ref)
        assert o["rows"] == ((rank // seq, rank // seq + 1) if data == 2 else (0, 2))
        np.testing.assert_array_equal(o["pos"], ref["pos"][:, rows])
        np.testing.assert_array_equal(o["valid"], ref["valid"][:, rows])
        np.testing.assert_allclose(o["logits"], ref["logits"][rows], atol=TOL, rtol=TOL)
        np.testing.assert_allclose(o["k"], ref["k"][:, rows], atol=TOL, rtol=TOL)
        np.testing.assert_allclose(o["v"], ref["v"][:, rows], atol=TOL, rtol=TOL)
        assert o["tokens"] == ref["tokens"]


def test_parallel_config_mirrors_jax():
    for kw in (dict(), dict(data=2, seq=4, sp_mode="ring"), dict(seq=8, sp_mode="ulysses"),
               dict(model=2, pipe=2), dict(data=2, model=4)):
        assert tcfg.ParallelConfig(**kw).num_devices == jcfg.ParallelConfig(**kw).num_devices
    with pytest.raises(ValueError, match="sp_mode"):
        tcfg.ParallelConfig(seq=2, sp_mode="stripes")


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(tcfg.ParallelConfig(seq=2, sp_mode="ring"), "cpu")
