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
from fastkv_tpu_torch.core.config import EngineConfig, Method, MethodConfig, ModelConfig
from fastkv_tpu_torch.engine.generate import Engine
from fastkv_tpu_torch.engine.scheduler import Scheduler
from fastkv_tpu_torch.models import llama
from fastkv_tpu_torch.ops import decode_attn, flash_prefill
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
    fp0, da0 = flash_prefill.launches, decode_attn.launches
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
    assert (flash_prefill.launches, decode_attn.launches) == (fp0, da0)


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
