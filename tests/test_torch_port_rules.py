"""Rules of the PyTorch port that no parity test would catch.

* ``fastkv_tpu_torch`` and ``chip_smoke.py`` import neither JAX nor anything of
  the JAX package (nor its headline script ``bench.py``), nor ``safetensors``,
  and ``transformers`` only inside a CLI's ``main`` or the tokenizer fixture. The check reads the sources' syntax trees: importing the
  modules proves nothing where JAX is already loaded at interpreter start.
* Entry points run on ``cuda`` by default and raise without a card, unless the
  caller asks for the CPU; nothing carries on silently on the CPU.
* On CPU tensors the kernel wrappers take their plain versions and launch
  nothing.
"""

import ast
from pathlib import Path

import pytest
import torch

from fastkv_tpu_torch.core import quant
from fastkv_tpu_torch.core.config import (DeepSeekV2Config, EngineConfig, Method, MethodConfig,
                                          ModelConfig)
from fastkv_tpu_torch.engine.generate import Engine
from fastkv_tpu_torch.engine.scheduler import Scheduler
from fastkv_tpu_torch.models import llama
from fastkv_tpu_torch.ops import decode_attn, decode_prologue, flash_prefill
from fastkv_tpu_torch.utils.testing import one_thread_per_module

_one_torch_thread = one_thread_per_module()

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "fastkv_tpu", "bench")


def _port_sources():
    files = sorted((ROOT / "fastkv_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value).split(".")[0]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    bad = [(str(p.relative_to(ROOT)), mod) for p in _port_sources()
           for mod in _imported_roots(p) if mod in FORBIDDEN]
    assert bad == []


def _imports_by_function(path: Path):
    """(root module, name of the innermost function around the import or None)."""
    tree = ast.parse(path.read_text(), filename=str(path))

    def walk(node, fn):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from walk(child, child.name)
                continue
            if isinstance(child, ast.Import):
                for alias in child.names:
                    yield alias.name.split(".")[0], fn
            elif isinstance(child, ast.ImportFrom) and child.level == 0 and child.module:
                yield child.module.split(".")[0], fn
            yield from walk(child, fn)

    return list(walk(tree, None))


def test_port_reads_checkpoints_without_safetensors_or_transformers():
    """The card's machine has neither package: the port reads and writes
    safetensors itself, and imports ``transformers``/``tokenizers`` only for
    a tokenizer, inside a CLI's ``main``/``run`` or the tokenizer fixture."""
    allowed = {"main", "run", "make_tiny_tokenizer"}
    bad = []
    for p in _port_sources():
        for mod, fn in _imports_by_function(p):
            if mod == "safetensors" or (mod in ("transformers", "tokenizers")
                                        and fn not in allowed):
                bad.append((str(p.relative_to(ROOT)), mod, fn))
    assert bad == []


def test_the_scan_sees_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom fastkv_tpu.core import config\ndef g():\n    import jax.numpy\n")
    assert {"fastkv_tpu", "jax"} <= set(_imported_roots(f))


# the layer math of models.llama that the engine reaches only through
# models.family (its layer functions and layer_params)
LAYER_MATH = ("layer_params", "qkv_proj", "rope_qk", "mlp", "mlp_sum", "attn_out_proj",
              "rms_norm")


def _llama_layer_math(src: str):
    """The names of ``LAYER_MATH`` that a module's source reaches in
    ``fastkv_tpu_torch.models.llama``: as an attribute of a name bound to
    that module, or imported from it."""
    tree = ast.parse(src)
    aliases = set()
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module == "fastkv_tpu_torch.models":
            aliases |= {a.asname or a.name for a in node.names if a.name == "llama"}
        elif isinstance(node, ast.ImportFrom) and node.module == "fastkv_tpu_torch.models.llama":
            found += [a.name for a in node.names if a.name in LAYER_MATH]
        elif isinstance(node, ast.Import):
            aliases |= {a.asname for a in node.names
                        if a.name == "fastkv_tpu_torch.models.llama" and a.asname}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute) and node.attr in LAYER_MATH
                and isinstance(node.value, ast.Name) and node.value.id in aliases):
            found.append(node.attr)
    return found


def test_engine_reaches_layer_math_only_through_the_family_seam():
    """No module of ``fastkv_tpu_torch/engine`` calls the layer math of
    ``models.llama`` (``LAYER_MATH``): a layer runs through
    ``models.family``'s ``prefill_layer`` and ``decode_layer``, whatever the
    family. ``embed`` and ``unembed``, shared by every family, may stay."""
    seen = _llama_layer_math("from fastkv_tpu_torch.models import llama as m\n"
                             "from fastkv_tpu_torch.models.llama import rope_qk\n"
                             "h = m.rms_norm(x, w, 1e-5) + m.embed(p, c, t)\n")
    assert sorted(seen) == ["rms_norm", "rope_qk"]
    files = sorted((ROOT / "fastkv_tpu_torch" / "engine").glob("*.py"))
    assert len(files) >= 9
    bad = [(p.name, name) for p in files for name in _llama_layer_math(p.read_text())]
    assert bad == []


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig.tiny()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        llama.init_params(cfg)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(params, cfg, MethodConfig())
    eng = Engine(params, cfg, MethodConfig(tsp_idx=1), EngineConfig(prefill_buckets=(64,)),
                 device="cpu")
    assert len(eng.generate([[1, 2, 3] * 10], 3)[0]) == 3
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Scheduler(params, cfg, MethodConfig(tsp_idx=1))
    sched = Scheduler(params, cfg, MethodConfig(tsp_idx=1),
                      EngineConfig(prefill_buckets=(256,), prefill_chunk=64), max_batch=2,
                      bucket=256, max_new_tokens=3, device="cpu")
    sched.submit([1, 2, 3] * 10)
    assert [len(r.tokens) for r in sched.run()] == [3]


@pytest.mark.parametrize("method", ["pyramidinfer"])
def test_methods_not_ported_raise(method, monkeypatch):
    """No method is refused as not ported: PyramidInfer, the last of the
    seven, runs through Engine.generate and the Scheduler on the CPU when
    asked, and without a card both raise that CUDA is not available."""
    cfg = ModelConfig.tiny()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    mcfg = MethodConfig(method=Method(method))
    ecfg = EngineConfig(prefill_buckets=(64,), capacity_align=8)
    eng = Engine(params, cfg, mcfg, ecfg, device="cpu")
    assert len(eng.generate([[1, 2, 3] * 10], 3)[0]) == 3
    sched = Scheduler(params, cfg, mcfg, ecfg, max_batch=2, bucket=64, max_new_tokens=3,
                      device="cpu")
    sched.submit([1, 2, 3] * 10)
    assert [len(r.tokens) for r in sched.run()] == [3]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(params, cfg, mcfg, ecfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Scheduler(params, cfg, mcfg, ecfg, bucket=64)


def test_tsp_layer_out_of_range_raises():
    cfg = ModelConfig.tiny()
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = Engine(params, cfg, MethodConfig(tsp_idx=cfg.num_layers),
                 EngineConfig(prefill_buckets=(64,)), device="cpu")
    with pytest.raises(ValueError, match="tsp_idx"):
        eng.generate([[1, 2, 3] * 10], 3)


def test_sliding_window_models_raise():
    """Sliding-window models run; only a window that is not a size raises."""
    cfg = ModelConfig.tiny(sliding_window=0)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="sliding_window"):
        Engine(params, cfg, MethodConfig(), device="cpu")
    q = torch.randn(1, 4, 16, 64)
    pos = torch.arange(16, dtype=torch.int32)[None]
    cnt = torch.tensor([16], dtype=torch.int32)
    with pytest.raises(ValueError, match="sliding_window"):
        flash_prefill.flash_attention(q, q[:, :2], q[:, :2], pos, cnt, sliding_window=0)
    cfg = ModelConfig.tiny(sliding_window=16)
    eng = Engine(params, cfg, MethodConfig(tsp_idx=1), EngineConfig(prefill_buckets=(64,)),
                 device="cpu")
    assert len(eng.generate([[1, 2, 3] * 10], 3)[0]) == 3


def test_wrappers_take_the_plain_version_on_cpu_tensors():
    fp0, da0, dp0 = flash_prefill.launches, decode_attn.launches, decode_prologue.launches
    q = torch.randn(1, 4, 16, 64)
    k = torch.randn(1, 2, 16, 64)
    pos = torch.arange(16, dtype=torch.int32)[None]
    cnt = torch.tensor([12], dtype=torch.int32)
    out = flash_prefill.flash_attention(q, k, k, pos, cnt)
    torch.testing.assert_close(out, flash_prefill.flash_attention_plain(q, k, k, pos, cnt))
    valid = torch.rand(1, 16) < 0.5
    valid[0, 0] = True
    out = decode_attn.decode_attention(q[:, :, :1], k, k, valid)
    torch.testing.assert_close(out, decode_attn.decode_attention_plain(q[:, :, :1], k, k, valid))
    inv_freq = torch.rand(32)
    caches = [torch.zeros(1, 2, 16, 64) for _ in range(4)]
    pos1 = torch.tensor([9], dtype=torch.int32)
    out = decode_prologue.rope_append(q[:, :, :1], k[:, :, :1], k[:, :, 1:2], pos1, inv_freq,
                                      *caches[:2], 5)
    torch.testing.assert_close(out, decode_prologue.rope_append_plain(
        q[:, :, :1], k[:, :, :1], k[:, :, 1:2], pos1, inv_freq, *caches[2:], 5))
    torch.testing.assert_close(caches[:2], caches[2:])
    cfg = DeepSeekV2Config.tiny()
    R, r = cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim
    ql = torch.randn(1, cfg.num_heads, 1, cfg.mla.qk_nope_head_dim + r)
    kv_a, kv_norm = torch.randn(1, 1, R + r), torch.ones(R)
    lat = [torch.zeros(1, 1, 16, w) for w in (R, r, R, r)]
    norm = dict(eps=cfg.rms_norm_eps, mscale=1.0)
    out = decode_prologue.latent_prologue(ql, kv_a, kv_norm, pos1, inv_freq[:r // 2], *lat[:2],
                                          torch.tensor([3]), **norm)
    torch.testing.assert_close(out, decode_prologue.latent_prologue_plain(
        ql, kv_a, kv_norm, pos1, inv_freq[:r // 2], *lat[2:], torch.tensor([3]), **norm))
    torch.testing.assert_close(lat[:2], lat[2:])
    assert (flash_prefill.launches, decode_attn.launches, decode_prologue.launches) == (
        fp0, da0, dp0)


def _counters():
    return (flash_prefill.launches, flash_prefill.scores_launches,
            flash_prefill.finish_launches, decode_attn.launches, decode_attn.int8_launches,
            decode_attn.window_launches)


def test_new_forms_take_the_plain_version_on_cpu_tensors():
    """The fused window scores, the int8 decode and the decode window term
    run their plain versions on CPU tensors and count no launch."""
    before = _counters()
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 16, 64, generator=g)
    k = torch.randn(1, 2, 16, 64, generator=g)
    pos = torch.arange(16, dtype=torch.int32)[None]
    cnt = torch.tensor([12], dtype=torch.int32)
    q_win, qw_pos = q[:, :, 8:12], pos[:, 8:12].contiguous()
    out, scores = flash_prefill.flash_attention(q, k, k, pos, cnt, window_q=q_win,
                                                window_q_pos=qw_pos)
    ref_out, ref_scores = flash_prefill.flash_attention_plain(q, k, k, pos, cnt, window_q=q_win,
                                                              window_q_pos=qw_pos)
    torch.testing.assert_close(out, ref_out)
    torch.testing.assert_close(scores, ref_scores)
    ki, ks = quant.quantize_kv(k)
    valid = torch.ones(1, 2, 16, dtype=torch.bool)
    qd = q[:, :, :1]
    int8 = dict(k_scale=ks, v_scale=ks)
    window = dict(q_pos=torch.tensor([15], dtype=torch.int32),
                  k_pos=pos[:, None].expand(1, 2, 16), sliding_window=4)
    for kw in (int8, window, {**int8, **window}):
        cache = ki if "k_scale" in kw else k
        torch.testing.assert_close(decode_attn.decode_attention(qd, cache, cache, valid, **kw),
                                   decode_attn.decode_attention_plain(qd, cache, cache, valid,
                                                                      **kw))
    assert _counters() == before


def test_kernel_sources_build_from_the_checkout():
    from fastkv_tpu_torch.kernels import build

    for name in build.KERNELS:
        assert (build.CSRC / f"{name}.cu").exists()
        path = build.library_path(name)
        assert path.parent == ROOT / "build" / "kernels"
        assert name in path.name and path.suffix == ".so"
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)


def test_parallel_package_imports_no_jax_and_nothing_of_the_jax_package():
    """The sequence-parallel package is scanned with the rest of the port and
    reaches its collectives only through torch.distributed."""
    files = sorted((ROOT / "fastkv_tpu_torch" / "parallel").glob("*.py"))
    assert {p.name for p in files} >= {"comm.py", "sharding.py", "ring_attention.py",
                                       "launch.py"}
    assert set(files) <= set(_port_sources())
    for p in files:
        assert not set(_imported_roots(p)) & set(FORBIDDEN), p.name


def test_aux_and_full_forms_take_the_plain_version_on_cpu_tensors():
    """The row statistics and the 'full' pattern run their plain versions on
    CPU tensors and count no launch."""
    before = (flash_prefill.launches, flash_prefill.aux_launches, flash_prefill.full_launches)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 4, 16, 64, generator=g)
    k = torch.randn(1, 2, 16, 64, generator=g)
    pos = torch.arange(16, 32, dtype=torch.int32)[None]
    kpos = torch.arange(16, dtype=torch.int32)[None]
    cnt = torch.tensor([12], dtype=torch.int32)
    out, m, l = flash_prefill.flash_attention(q, k, k, pos, cnt, k_positions=kpos,
                                              k_count=cnt, pattern="full", return_aux=True)
    ref = flash_prefill.flash_attention_plain(q, k, k, pos, cnt, k_positions=kpos, k_count=cnt,
                                              return_aux=True)
    for a, b in zip((out, m, l), ref):
        torch.testing.assert_close(a, b)
    assert (flash_prefill.launches, flash_prefill.aux_launches,
            flash_prefill.full_launches) == before
