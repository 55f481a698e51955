"""The port's checkpoint loading against the safetensors package, the JAX
package's loader and HF transformers.

* The reader (``core.weights.SafetensorsFile``) against ``safetensors`` over
  F32, F16, BF16, I8 and I64, whole tensors and row ranges, ``__metadata__``
  and a multi-shard index; the writer's round trip.
* ``load_params`` equals the JAX ``load_params`` leaf for leaf, exactly, on
  F32 checkpoints (the JAX package's ``make_tiny_model_dir`` and the tracked
  ``artifacts/tiny-llama``), and on a BF16 checkpoint, which the port reads
  as ``safetensors.torch`` does.
* ``ModelConfig.from_hf_config`` equals the JAX one on Llama-3.1, Mistral and
  Nemo config dicts.
* HF ground truth: prefill logits within 2e-3 and FullKV greedy tokens equal
  to ``LlamaForCausalLM``'s, on ``artifacts/tiny-llama`` and on a tiny HF
  Llama with llama3 rope scaling; FastKV tokens equal to the JAX Engine's.
"""

import dataclasses
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from fastkv_tpu_torch.utils.testing import one_thread_per_module

_one_torch_thread = one_thread_per_module()

safetensors_torch = pytest.importorskip("safetensors.torch")
transformers = pytest.importorskip("transformers")

from fastkv_tpu.core import config as jcfg
from fastkv_tpu.core import weights as jweights
from fastkv_tpu.engine.generate import Engine as JEngine
from fastkv_tpu.utils.testing import make_tiny_model_dir as j_make_tiny_model_dir
from fastkv_tpu_torch.core import config as tcfg
from fastkv_tpu_torch.core import weights as tweights
from fastkv_tpu_torch.engine import prefill as tpm
from fastkv_tpu_torch.engine.generate import Engine as TEngine
from fastkv_tpu_torch.models import llama as tllama
from fastkv_tpu_torch.utils import testing as ttesting

TINY_LLAMA = str(Path(__file__).resolve().parents[1] / "artifacts" / "tiny-llama")
DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I8": torch.int8, "I64": torch.int64}


def _tensor(dtype, shape, seed):
    g = torch.Generator().manual_seed(seed)
    if dtype.is_floating_point:
        return torch.randn(shape, generator=g).to(dtype)
    info = torch.iinfo(dtype)
    return torch.randint(max(info.min, -2**40), min(info.max, 2**40), shape, generator=g,
                         dtype=dtype)


def _flat(params):
    out = {k: v for k, v in params.items() if k != "layers"}
    out.update({f"layers.{k}": v for k, v in params["layers"].items()})
    return out


@pytest.mark.parametrize("rows", [None, slice(2, 5), slice(0, 1), slice(6, 7)])
@pytest.mark.parametrize("name", sorted(DTYPES))
def test_reader_matches_safetensors(tmp_path, name, rows):
    tensors = {f"t{i}": _tensor(DTYPES[name], shape, i)
               for i, shape in enumerate([(7, 3), (7, 2, 5), (7,)])}
    tensors["odd"] = _tensor(torch.float32, (3, 1), 9)  # another dtype beside it
    path = str(tmp_path / "x.safetensors")
    safetensors_torch.save_file(tensors, path, metadata={"format": "pt", "note": "x"})
    f = tweights.SafetensorsFile(path)
    assert f.metadata == {"format": "pt", "note": "x"}
    assert set(f.keys()) == set(tensors)
    want = safetensors_torch.load_file(path)
    for k in tensors:
        got = f.read(k, rows if k != "odd" else None)
        ref = want[k] if rows is None or k == "odd" else want[k][rows]
        assert got.dtype == ref.dtype and torch.equal(got, ref), k


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_writer_round_trip(tmp_path, name):
    tensors = {"a": _tensor(DTYPES[name], (5, 4), 1), "b": _tensor(DTYPES[name], (3,), 2),
               "c": _tensor(torch.float32, (2, 2, 2), 3).permute(2, 1, 0)}  # not contiguous
    path = str(tmp_path / "w.safetensors")
    n = tweights.save_safetensors(tensors, path, metadata={"format": "pt"})
    assert n == sum(t.numel() * t.element_size() for t in tensors.values())
    for got in (safetensors_torch.load_file(path),
                {k: tweights.SafetensorsFile(path).read(k) for k in tensors}):
        for k, t in tensors.items():
            assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    cast = str(tmp_path / "cast.safetensors")
    if DTYPES[name].is_floating_point:
        tweights.save_safetensors(tensors, cast, dtype=torch.bfloat16)
        got = safetensors_torch.load_file(cast)
        assert all(torch.equal(got[k], t.to(torch.bfloat16)) for k, t in tensors.items())


def _save_hf_tiny(path, dtype=torch.float32, shard_kb=None, rope_scaling=None, seed=0):
    cfg = tcfg.ModelConfig.tiny()
    hf_cfg = transformers.LlamaConfig(
        vocab_size=cfg.vocab_size, hidden_size=cfg.hidden_size,
        intermediate_size=cfg.intermediate_size, num_hidden_layers=cfg.num_layers,
        num_attention_heads=cfg.num_heads, num_key_value_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta,
        max_position_embeddings=cfg.max_position_embeddings, rope_scaling=rope_scaling,
        tie_word_embeddings=False, attention_bias=False, mlp_bias=False)
    torch.manual_seed(seed)
    model = transformers.LlamaForCausalLM(hf_cfg).eval().to(dtype)
    kw = {"max_shard_size": f"{shard_kb}KB"} if shard_kb else {}
    model.save_pretrained(str(path), safe_serialization=True, **kw)
    return model


def test_multishard_index_reads_every_tensor(tmp_path):
    _save_hf_tiny(tmp_path, shard_kb=200)
    index = json.loads((tmp_path / tweights.INDEX_FILE).read_text())
    files = sorted(set(index["weight_map"].values()))
    assert len(files) > 1
    reader = tweights.ShardReader(str(tmp_path))
    want = {}
    for fname in files:
        want.update(safetensors_torch.load_file(str(tmp_path / fname)))
    assert set(reader.names()) == set(want)
    for name, t in want.items():
        assert torch.equal(reader.read(name), t), name
        assert torch.equal(reader.read(name, slice(1, 3)), t[1:3]), name


@pytest.fixture(scope="module")
def jax_model_dir(tmp_path_factory):
    return j_make_tiny_model_dir(str(tmp_path_factory.mktemp("jmodel")))


@pytest.mark.parametrize("which", ["make_tiny_model_dir", "tiny-llama"])
def test_load_params_equals_jax_on_f32(jax_model_dir, which):
    model_dir = jax_model_dir if which == "make_tiny_model_dir" else TINY_LLAMA
    jc = jweights.model_config_from_dir(model_dir, dtype="float32")
    ref = jax.tree_util.tree_map(np.asarray, jweights.load_params(model_dir, jc))
    tc = tweights.model_config_from_dir(model_dir, dtype="float32")
    got = tweights.load_params(model_dir, tc, device="cpu")
    ref_flat, got_flat = _flat(ref), _flat(got)
    assert set(ref_flat) == set(got_flat)
    for k, leaf in ref_flat.items():
        assert got_flat[k].dtype == torch.float32, k
        np.testing.assert_array_equal(got_flat[k].numpy(), leaf, err_msg=k)


def test_make_tiny_model_dir_writes_the_jax_fixtures_tensors(jax_model_dir, tmp_path):
    ttesting.make_tiny_model_dir(str(tmp_path))
    want = safetensors_torch.load_file(os.path.join(jax_model_dir, "model.safetensors"))
    got = safetensors_torch.load_file(str(tmp_path / "model.safetensors"))
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert json.loads((tmp_path / "config.json").read_text()) == json.loads(
        Path(jax_model_dir, "config.json").read_text())


def test_bf16_checkpoint_reads_as_safetensors_torch(tmp_path):
    model = _save_hf_tiny(tmp_path, dtype=torch.bfloat16)
    cfg = tweights.model_config_from_dir(str(tmp_path), dtype="bfloat16")
    got = tweights.load_params(str(tmp_path), cfg, device="cpu")
    want = tweights.params_from_hf_state_dict(
        cfg, safetensors_torch.load_file(str(tmp_path / "model.safetensors")), device="cpu")
    sd = model.state_dict()
    for k, leaf in _flat(want).items():
        assert torch.equal(_flat(got)[k], leaf), k
    assert got["layers"]["wq"].dtype == torch.bfloat16
    assert got["layers"]["ln_attn"].dtype == torch.float32
    assert torch.equal(got["layers"]["wk"][2], sd["model.layers.2.self_attn.k_proj.weight"].T)
    assert torch.equal(got["lm_head"], sd["lm_head.weight"].T)


def test_jax_loader_reads_bf16_as_the_port(tmp_path):
    """The JAX loader reads BF16 too: its numpy reader (``safe_open(...,
    framework="np")``) raises on BF16 only in an interpreter without
    ``ml_dtypes``, which JAX imports and which gives numpy its bfloat16."""
    _save_hf_tiny(tmp_path, dtype=torch.bfloat16)
    jc = jweights.model_config_from_dir(str(tmp_path), dtype="bfloat16")
    ref = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32),
                                 jweights.load_params(str(tmp_path), jc))
    tc = tweights.model_config_from_dir(str(tmp_path), dtype="bfloat16")
    got = _flat(tweights.load_params(str(tmp_path), tc, device="cpu"))
    for k, leaf in _flat(ref).items():
        np.testing.assert_array_equal(got[k].float().numpy(), leaf, err_msg=k)


def test_write_model_dir_round_trip(tmp_path):
    cfg = tcfg.ModelConfig.tiny()
    params = tllama.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    total = ttesting.write_model_dir(cfg, params, str(tmp_path), shard_bytes=60_000,
                                     dtype="bfloat16")
    index = json.loads((tmp_path / tweights.INDEX_FILE).read_text())
    assert index["metadata"]["total_size"] == total
    assert len(set(index["weight_map"].values())) > 2
    back_cfg = tweights.model_config_from_dir(str(tmp_path), dtype="bfloat16")
    assert dataclasses.replace(back_cfg, name=cfg.name, dtype=cfg.dtype) == cfg
    got = tweights.load_params(str(tmp_path), back_cfg, device="cpu")
    for k, leaf in _flat(params).items():
        want = leaf if tllama.is_norm(k) else leaf.to(torch.bfloat16)
        assert torch.equal(_flat(got)[k], want.to(_flat(got)[k].dtype)), k


def test_load_params_refusals(tmp_path):
    cfg = tcfg.ModelConfig.tiny()
    params = tllama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ttesting.write_model_dir(cfg, params, str(tmp_path))
    with pytest.raises(ValueError, match="shape"):
        tweights.load_params(str(tmp_path), dataclasses.replace(cfg, intermediate_size=96),
                             device="cpu")
    del params["lm_head"]
    tied = str(tmp_path / "tied")
    ttesting.write_model_dir(dataclasses.replace(cfg, tie_word_embeddings=True), params, tied)
    with pytest.raises(ValueError, match="no lm_head"):
        tweights.load_params(tied, cfg, device="cpu")
    got = tweights.load_params(tied, dataclasses.replace(cfg, tie_word_embeddings=True),
                               device="cpu")
    assert "lm_head" not in got


HF_CONFIGS = {
    "llama-3.1-8b": {
        "vocab_size": 128256, "hidden_size": 4096, "intermediate_size": 14336,
        "num_hidden_layers": 32, "num_attention_heads": 32, "num_key_value_heads": 8,
        "rope_theta": 500000.0, "rms_norm_eps": 1e-5, "max_position_embeddings": 131072,
        "tie_word_embeddings": False,
        "rope_scaling": {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                         "high_freq_factor": 4.0,
                         "original_max_position_embeddings": 8192}},
    "ministral-8b": {
        "vocab_size": 131072, "hidden_size": 4096, "intermediate_size": 12288,
        "num_hidden_layers": 36, "num_attention_heads": 32, "num_key_value_heads": 8,
        "head_dim": 128, "rope_theta": 100000000.0, "sliding_window": 32768,
        "max_position_embeddings": 32768, "rms_norm_eps": 1e-5},
    "mistral-nemo-12b": {
        "vocab_size": 131072, "hidden_size": 5120, "intermediate_size": 14336,
        "num_hidden_layers": 40, "num_attention_heads": 32, "num_key_value_heads": 8,
        "head_dim": 128, "rope_theta": 1000000.0, "sliding_window": None,
        "max_position_embeddings": 1024000, "rms_norm_eps": 1e-5},
    "llama-3.2-1b-tied": {
        "vocab_size": 128256, "hidden_size": 2048, "intermediate_size": 8192,
        "num_hidden_layers": 16, "num_attention_heads": 32, "num_key_value_heads": 8,
        "head_dim": 64, "tie_word_embeddings": True,
        "rope_scaling": {"type": "llama3", "factor": 32.0, "low_freq_factor": 1.0,
                         "high_freq_factor": 4.0, "original_max_position_embeddings": 8192}},
}


@pytest.mark.parametrize("name", sorted(HF_CONFIGS))
def test_from_hf_config_equals_jax(name):
    hf = HF_CONFIGS[name]
    got = dataclasses.asdict(tcfg.ModelConfig.from_hf_config(hf, name=name))
    want = dataclasses.asdict(jcfg.ModelConfig.from_hf_config(hf, name=name))
    assert got == {k: want[k] for k in got}
    if name == "llama-3.1-8b":  # the published config is the preset
        assert tcfg.ModelConfig.from_hf_config(hf, name=name) == tcfg.ModelConfig.llama_3_1_8b()


# ---------------------------------------------------------------------------
# HF ground truth
# ---------------------------------------------------------------------------

def _prefill_logits(params, cfg, ids, bucket=128):
    mcfg = tcfg.MethodConfig(method=tcfg.Method.FULLKV)
    ecfg = tcfg.EngineConfig(prefill_buckets=(bucket,), max_new_tokens=16, capacity_align=8)
    shapes = tpm.plan_shapes(cfg, mcfg, ecfg, bucket)
    tokens = torch.zeros((1, bucket), dtype=torch.int32)
    tokens[0, :len(ids)] = torch.tensor(ids, dtype=torch.int32)
    with torch.inference_mode():
        logits, _ = tpm.prefill(params, cfg, mcfg, shapes, tokens,
                                torch.tensor([len(ids)], dtype=torch.int32), ecfg)
    return logits[0].numpy()


@pytest.fixture(scope="module")
def rope_llama_dir(tmp_path_factory):
    path = tmp_path_factory.mktemp("rope_llama")
    _save_hf_tiny(path, rope_scaling={"rope_type": "llama3", "factor": 8.0,
                                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                                      "original_max_position_embeddings": 32}, seed=5)
    return str(path)


@pytest.mark.parametrize("which", ["tiny-llama", "llama3-rope-scaling"])
def test_prefill_and_fullkv_generate_match_hf(which, rope_llama_dir):
    model_dir = TINY_LLAMA if which == "tiny-llama" else rope_llama_dir
    hf = transformers.LlamaForCausalLM.from_pretrained(model_dir, torch_dtype=torch.float32)
    hf.eval()
    cfg = tweights.model_config_from_dir(model_dir, dtype="float32")
    assert (cfg.rope_scaling is not None) == (which != "tiny-llama")
    params = tweights.load_params(model_dir, cfg, device="cpu")
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab_size, size=100).tolist()  # past 32 positions: scaled
    with torch.no_grad():
        hf_logits = hf(torch.tensor([ids])).logits[0, -1].float().numpy()
    np.testing.assert_allclose(_prefill_logits(params, cfg, ids), hf_logits, atol=2e-3, rtol=1e-3)
    eng = TEngine(params, cfg, tcfg.MethodConfig(method=tcfg.Method.FULLKV),
                  tcfg.EngineConfig(prefill_buckets=(128,), max_new_tokens=16, capacity_align=8),
                  device="cpu")
    for n in (40, 100):
        prompt = rng.integers(0, cfg.vocab_size, size=n)
        with torch.no_grad():
            out = hf.generate(torch.tensor(prompt[None]), max_new_tokens=12, do_sample=False,
                              num_beams=1, pad_token_id=0)
        assert eng.generate([prompt.tolist()], 12)[0] == out[0, n:].tolist(), n


def test_fastkv_generate_on_tiny_llama_equals_jax():
    jc = jweights.model_config_from_dir(TINY_LLAMA, dtype="float32")
    jparams = jweights.load_params(TINY_LLAMA, jc)
    tc = tweights.model_config_from_dir(TINY_LLAMA, dtype="float32")
    tparams = tweights.load_params(TINY_LLAMA, tc, device="cpu")
    kw = dict(eviction_mode="proportional", retain_rate=0.3, tsp_rate=0.5, tsp_idx=1)
    j = JEngine(jparams, jc, jcfg.MethodConfig(method=jcfg.Method.FASTKV, **kw),
                jcfg.EngineConfig(prefill_buckets=(256,), max_new_tokens=16, use_pallas=False,
                                  capacity_align=8))
    t = TEngine(tparams, tc, tcfg.MethodConfig(method=tcfg.Method.FASTKV, **kw),
                tcfg.EngineConfig(prefill_buckets=(256,), max_new_tokens=16, capacity_align=8),
                device="cpu")
    rng = np.random.default_rng(4)
    for n in (230, 97):
        prompt = rng.integers(0, tc.vocab_size, size=n).tolist()
        assert t.generate([prompt], 12) == j.generate([prompt], max_new_tokens=12), n
