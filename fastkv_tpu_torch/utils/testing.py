"""Checkpoint fixtures: a complete local HF model directory (config.json,
safetensors, a trained tiny tokenizer with a chat template), so the loader,
the tokenizer, the eval runners and the scorers run offline.

Port of ``fastkv_tpu.utils.testing``; the weights go through the port's own
safetensors writer. ``make_tiny_tokenizer`` needs the ``tokenizers`` and
``transformers`` packages (imported when called). ``write_model_dir`` writes
any params of the port in HF layout, sharded with an index as published
checkpoints are.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from fastkv_tpu_torch.core import weights
from fastkv_tpu_torch.core.config import ModelConfig

@contextlib.contextmanager
def torch_threads(n: int):
    """torch's intra-op threads set to n inside the block, restored after."""
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def one_thread_per_module():
    """An autouse, module-scoped pytest fixture: the module's CPU work runs on
    one intra-op thread, restored after it. The suite runs several workers on
    the machine's cores, where torch's default of a thread a core
    oversubscribes them (a tiny Scheduler run takes 0.2 s alone and 11-18 s
    beside five other workers). Bind it to a module-level name in the test
    module."""
    import pytest

    @pytest.fixture(autouse=True, scope="module")
    def _one_torch_thread():
        with torch_threads(1):
            yield

    return _one_torch_thread


CHAT_TEMPLATE = (
    "{% for message in messages %}<|{{ message['role'] }}|>{{ message['content'] }}"
    "{% endfor %}{% if add_generation_prompt %}<|assistant|>{% endif %}"
)


def make_tiny_tokenizer(out_dir: str, corpus: Optional[list] = None):
    """Train a ~300-token BPE tokenizer and save it in HF-fast format."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers
    from transformers import PreTrainedTokenizerFast

    corpus = corpus or [
        "The quick brown fox jumps over the lazy dog. " * 50,
        "San Francisco is a city. The best thing to do is eat a sandwich. " * 50,
        "Paris is the capital of France. Questions and answers. " * 50,
        "".join(chr(c) for c in range(32, 127)),
        "\n\n\n .,:;!?0123456789",
    ]
    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=384,
        special_tokens=["<unk>", "<s>", "</s>", "<|user|>", "<|assistant|>", "<|im_start|>"],
    )
    tok.train_from_iterator(corpus, trainer)
    fast = PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token="<unk>", bos_token="<s>", eos_token="</s>",
        pad_token="</s>")
    fast.chat_template = CHAT_TEMPLATE
    fast.save_pretrained(out_dir)
    return fast


def make_tiny_model_dir(out_dir: str, seed: int = 0, num_layers: int = 2):
    """Write config.json + model.safetensors for a tiny Llama + tokenizer
    (the same float32 weights, from the same numpy seed, as the JAX
    package's fixture)."""
    os.makedirs(out_dir, exist_ok=True)
    tokenizer = make_tiny_tokenizer(out_dir)
    vocab_size = max(512, tokenizer.vocab_size)
    hf_cfg = {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        "vocab_size": vocab_size,
        "hidden_size": 64,
        "intermediate_size": 128,
        "num_hidden_layers": num_layers,
        "num_attention_heads": 4,
        "num_key_value_heads": 2,
        "head_dim": 16,
        "max_position_embeddings": 131072,
        "rms_norm_eps": 1e-6,
        "rope_theta": 10000.0,
        "tie_word_embeddings": False,
        "torch_dtype": "float32",
    }
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2)

    rng = np.random.default_rng(seed)
    D, F, H, KH, dh = 64, 128, 4, 2, 16

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32) * 0.02

    tensors = {
        "model.embed_tokens.weight": normal(vocab_size, D),
        "model.norm.weight": np.ones((D,), np.float32),
        "lm_head.weight": normal(vocab_size, D),
    }
    for i in range(num_layers):
        p = f"model.layers.{i}."
        tensors[p + "self_attn.q_proj.weight"] = normal(H * dh, D)
        tensors[p + "self_attn.k_proj.weight"] = normal(KH * dh, D)
        tensors[p + "self_attn.v_proj.weight"] = normal(KH * dh, D)
        tensors[p + "self_attn.o_proj.weight"] = normal(D, H * dh)
        tensors[p + "mlp.gate_proj.weight"] = normal(F, D)
        tensors[p + "mlp.up_proj.weight"] = normal(F, D)
        tensors[p + "mlp.down_proj.weight"] = normal(D, F)
        tensors[p + "input_layernorm.weight"] = np.ones((D,), np.float32)
        tensors[p + "post_attention_layernorm.weight"] = np.ones((D,), np.float32)
    weights.save_safetensors({k: torch.from_numpy(v) for k, v in tensors.items()},
                             os.path.join(out_dir, weights.SINGLE_FILE),
                             metadata={"format": "pt"})
    return out_dir


def hf_config(cfg: ModelConfig, dtype: str) -> Dict[str, Any]:
    """An HF ``config.json`` for ``cfg`` (the inverse of ``from_hf_config``)."""
    out = {
        "architectures": ["LlamaForCausalLM"],
        "model_type": "llama",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "head_dim": cfg.head_dim,
        "max_position_embeddings": cfg.max_position_embeddings,
        "rms_norm_eps": cfg.rms_norm_eps,
        "rope_theta": cfg.rope_theta,
        "rope_scaling": None,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "torch_dtype": dtype,
    }
    rs = cfg.rope_scaling
    if rs is not None:
        out["rope_scaling"] = {
            "rope_type": rs.rope_type, "factor": rs.factor,
            "low_freq_factor": rs.low_freq_factor, "high_freq_factor": rs.high_freq_factor,
            "original_max_position_embeddings": rs.original_max_position_embeddings}
    if cfg.sliding_window is not None:
        out["sliding_window"] = cfg.sliding_window
    return out


def write_model_dir(cfg: ModelConfig, params: Dict[str, Any], out_dir: str,
                    shard_bytes: int = 5 * 10**9, dtype=None) -> int:
    """Write ``params`` (the port's layout, any device) as an HF checkpoint:
    config.json and safetensors shards of at most ``shard_bytes`` each, in
    HF's tensor order, with ``model.safetensors.index.json`` (one shard:
    ``model.safetensors`` alone). ``dtype`` casts every tensor (default: each
    keeps its own). One tensor at a time is copied to the host. Returns the
    bytes of tensor data written."""
    from fastkv_tpu_torch.core.device import torch_dtype

    dt = torch_dtype(dtype) if dtype is not None else None
    os.makedirs(out_dir, exist_ok=True)
    tensors = weights.hf_tensors(cfg, params)
    shards: List[Dict[str, torch.Tensor]] = [{}]
    size = 0
    for name, t in tensors.items():
        nbytes = t.numel() * (dt or t.dtype).itemsize
        if shards[-1] and size + nbytes > shard_bytes:
            shards.append({})
            size = 0
        shards[-1][name] = t
        size += nbytes
    n = len(shards)
    files = ([weights.SINGLE_FILE] if n == 1 else
             [f"model-{i + 1:05d}-of-{n:05d}.safetensors" for i in range(n)])
    total = 0
    for fname, shard in zip(files, shards):
        total += weights.save_safetensors(shard, os.path.join(out_dir, fname),
                                          metadata={"format": "pt"}, dtype=dt)
    if n > 1:
        index = {"metadata": {"total_size": total},
                 "weight_map": {name: fname for fname, shard in zip(files, shards)
                                for name in shard}}
        with open(os.path.join(out_dir, weights.INDEX_FILE), "w") as f:
            json.dump(index, f, indent=2)
    name = {torch.bfloat16: "bfloat16", torch.float32: "float32"}.get(
        dt or params["embed"].dtype, "float32")
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(hf_config(cfg, name), f, indent=2)
    return total


def mesh_rank_cases(rank: int, world: int, workdir: str, cfg: ModelConfig, params_np,
                    cases: List[Dict[str, Any]], device: str = "cpu") -> None:
    """The body of one rank of a world over a mesh (``parallel.launch.
    run_world``): for each case its mesh (``pcfg``, made once per pcfg, in
    case order on every rank) and this rank's shard of the params
    (``sharding.shard_params`` of ``params_np``, a numpy tree, or of the
    case's own ``params``, for its own ``cfg`` if it has one), then by the
    case's ``kind``:

      * "engine" (the default): the prefill of this replica's rows of
        ``tokens`` [b, bucket] / ``n_true`` [b] (numpy) as ``Engine.generate``
        runs it (GemFilter: token selection, then pass 2; PyramidInfer: its
        own prefill), then ``Engine.generate`` of every prompt of
        ``prompts`` (``max_new`` tokens) with the kernels' launches during
        it;
      * "scheduler": a Scheduler replica over the mesh (``sched_kw``) that
        serves ``prompts`` with ``budgets``: its tokens and event kinds;
      * "load": ``core.weights.load_params(model_dir, mesh=)``: every leaf.

    Each case's outputs (the rank's place, logits and cache as numpy,
    tokens...) go to ``workdir/rank<r>.pkl``, a list in case order."""
    import pickle

    from fastkv_tpu_torch.core import weights
    from fastkv_tpu_torch.core.config import Method
    from fastkv_tpu_torch.engine import gemfilter
    from fastkv_tpu_torch.engine import prefill as prefill_mod
    from fastkv_tpu_torch.engine.generate import Engine
    from fastkv_tpu_torch.engine.scheduler import Scheduler
    from fastkv_tpu_torch.models.llama import params_from_numpy
    from fastkv_tpu_torch.ops import decode_attn as da
    from fastkv_tpu_torch.ops import flash_prefill as fp
    from fastkv_tpu_torch.parallel.sharding import make_mesh, shard_params

    def counts():
        return dict(flash=fp.launches, aux=fp.aux_launches, full=fp.full_launches,
                    rect=fp.rect_launches, decode=da.launches)

    def numpy_tree(tree):
        return {k: (numpy_tree(v) if isinstance(v, dict) else v.float().cpu().numpy()
                    if v.is_floating_point() else v.cpu().numpy()) for k, v in tree.items()}

    torch.set_num_threads(1)
    meshes, shards, out = {}, {}, []
    for case in cases:
        pcfg = case["pcfg"]
        if pcfg not in meshes:  # every rank makes the same groups in the same order
            meshes[pcfg] = make_mesh(pcfg, device)
        mesh = meshes[pcfg]
        ccfg = case.get("cfg", cfg)
        rec: Dict[str, Any] = dict(place=mesh.place)
        if case.get("kind") == "load":
            rec["leaves"] = numpy_tree(weights.load_params(case["model_dir"], ccfg, mesh=mesh))
            out.append(rec)
            continue
        key = (pcfg, case.get("params_key"))
        if key not in shards:
            whole = params_from_numpy(ccfg, case.get("params", params_np), device=mesh.device)
            shards[key] = shard_params(whole, mesh, ccfg)
        params = shards[key]
        mcfg, ecfg = case["mcfg"], case["ecfg"]
        if case.get("kind") == "scheduler":
            sched = Scheduler(params, ccfg, mcfg, ecfg, mesh=mesh, **case["sched_kw"])
            ids = [sched.submit(p, n) for p, n in zip(case["prompts"], case["budgets"])]
            done = {r.req_id: r.tokens for r in sched.run()}
            rec.update(tokens=[done[i] for i in ids], events=[e[0] for e in sched.events])
            out.append(rec)
            continue
        eng = Engine(params, ccfg, mcfg, ecfg, mesh=mesh)
        bucket = case["tokens"].shape[1]
        shapes = eng.shapes_for(bucket, ecfg.max_new_tokens)
        b = case["tokens"].shape[0]
        rows = mesh.batch_rows(b) if mesh.data > 1 else slice(0, b)
        tokens = torch.from_numpy(case["tokens"][rows]).to(mesh.device)
        n_true = torch.from_numpy(case["n_true"][rows]).to(mesh.device)
        with torch.inference_mode():
            if mcfg.method == Method.GEMFILTER:
                tokens, n_true, _ = gemfilter.select_tokens(params, ccfg, mcfg, ecfg, tokens,
                                                            n_true, shapes.bucket, mesh)
                logits, cache = prefill_mod.prefill(params, ccfg, gemfilter.pass2_config(mcfg),
                                                    shapes, tokens, n_true, ecfg, mesh=mesh)
            else:
                logits, cache = prefill_mod.prefill(params, ccfg, mcfg, shapes, tokens, n_true,
                                                    ecfg, pcfg=pcfg, mesh=mesh)
        before = counts()
        toks = eng.generate(case["prompts"], case["max_new"])
        launches = {k: n - before[k] for k, n in counts().items()}
        rec.update(rows=(rows.start, rows.stop), launches=launches, logits=logits.cpu().numpy(),
                   pos=cache.pos.cpu().numpy(), valid=cache.valid.cpu().numpy(),
                   k=cache.k.float().cpu().numpy(), v=cache.v.float().cpu().numpy(),
                   tokens=toks)
        out.append(rec)
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def serve_rank(rank: int, world: int, workdir: str, cfg: ModelConfig, params_np,
               mcfg, ecfg, prompts: List[List[int]], new: int) -> None:
    """One rank of the two-process serving smoke (run under
    ``parallel.launch.run_world``, gloo, CPU): ``serve.init_distributed``
    reports the group, one all-reduce sums the ranks, a ``local_front_door``
    serves this rank's share of ``prompts`` (every ``world``-th from
    ``rank``), then every prompt is dispatched through rank 0's
    ``Coordinator``, pulled by a ``serve_worker`` on each rank. Rank 0 passes
    the coordinator's bound address through ``workdir/coordinator.json``
    (written whole, then renamed); rank 0's worker starts once rank 1's
    holds a ticket, so both serve. Each rank writes ``workdir/rank<r>.json``:
    the group info, the sum, the front door's tokens and the dispatch's
    results (rank 0) or served count."""
    import time

    import torch.distributed as dist

    from fastkv_tpu_torch.engine.dispatch import Coordinator, serve_worker
    from fastkv_tpu_torch.engine.scheduler import Scheduler
    from fastkv_tpu_torch.engine.serve import init_distributed, local_front_door
    from fastkv_tpu_torch.models.llama import params_from_numpy

    torch.set_num_threads(1)
    info = init_distributed(device="cpu")
    total = torch.tensor([float(rank + 1)])
    dist.all_reduce(total)
    params = params_from_numpy(cfg, params_np, device="cpu")
    kw = dict(max_batch=1, bucket=ecfg.prefill_buckets[-1], max_new_tokens=new, device="cpu")
    fd = local_front_door(params, cfg, mcfg, ecfg, n_replicas=1, **kw)
    for p in prompts[rank::world]:
        fd.submit(p, new)
    out = dict(info=info, sum=float(total.item()),
               front_door=[r["tokens"] for r in fd.run()])

    addr_file = os.path.join(workdir, "coordinator.json")
    sched = Scheduler(params, cfg, mcfg, ecfg, **kw)
    deadline = time.monotonic() + 120
    if rank == 0:
        coord = Coordinator(port=0)
        try:
            tmp = addr_file + ".tmp"
            with open(tmp, "w") as f:
                json.dump(list(coord.address), f)
            os.replace(tmp, addr_file)
            for p in prompts:
                coord.submit(p, new)
            coord.seal()
            while time.monotonic() < deadline:
                with coord._lock:
                    if coord._outstanding or coord._results:
                        break
                time.sleep(0.01)
            out["served"] = serve_worker(coord.address, sched, name="p0", batch=1)
            res = coord.wait_results(timeout=120)
        finally:
            coord.close()
        out["dispatch"] = [r["tokens"] for r in res]
        out["workers"] = sorted({r["worker"] for r in res})
    else:
        while not os.path.exists(addr_file):
            if time.monotonic() > deadline:
                raise TimeoutError("rank 0 wrote no coordinator address")
            time.sleep(0.01)
        with open(addr_file) as f:
            address = tuple(json.load(f))
        out["served"] = serve_worker(address, sched, name=f"p{rank}", batch=1)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def cache_by_position(c: Dict[str, Any]) -> Dict[str, Any]:
    """A cache's pos, valid, and k and v where present (numpy), with each
    head's slots sorted by
    position, invalid slots last (a stable sort keeps their order). H2O keeps
    its tokens in score order, and two kept tokens whose accumulated masses
    are equal to float32 rounding may sit in swapped slots in two runs that
    sum in another order; no attention output can see the difference."""
    order = np.argsort(np.where(c["valid"], c["pos"], np.iinfo(np.int32).max), axis=-1,
                       kind="stable")
    out = dict(c)
    for name in ("k", "v"):
        if name in c:
            out[name] = np.take_along_axis(c[name], order[..., None], -2)
    for name in ("pos", "valid"):
        out[name] = np.take_along_axis(c[name], order, -1)
    return out


def longbench_rank(rank: int, world: int, workdir: str, argv: List[str]) -> None:
    """One rank of the LongBench CLI over a mesh (run under
    ``parallel.launch.run_world``): ``longbench.main(argv)``, whose
    ``--tp``/``--dp`` make ``build_engine`` join the group the process is in
    and load this rank's shard; rank 0 writes the records (``main`` loads
    the model directory's tokenizer: needs ``transformers``)."""
    from fastkv_tpu_torch.evals import longbench

    torch.set_num_threads(1)
    longbench.main(argv)
