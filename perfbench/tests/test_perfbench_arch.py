"""The architecture seam (``perfbench/arch/``): the Mistral family's weights
and work counts equal, bit for bit and number for number, what the harness
computed before the seam (frozen below); a toy second architecture, written
as new files alone, is picked up by the weight path, the work dispatch and
the readers; and outside the architecture modules and the references no
file of the harness reads a key of the model's shape."""

import hashlib
import importlib
import json
import re
import sys
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

import pytest
import torch

from perfbench import arch, run, work
from perfbench.tests import cells
from perfbench.tests.test_perfbench_isolation import top_imports
from perfbench.trace import Interval

PB = cells.REPO / "perfbench"
CONFIGS = {name: json.loads((PB / "configs" / f"{name}.json").read_text())
           for name in ("mistral-nemo-12b", "ministral-8b")}
SHAPE_KEYS = ("head_dim", "num_key_value_heads", "num_attention_heads", "intermediate_size")


# -- the harness before the seam: ``run.make_weights`` and ``work.py``'s shape
# formulas as they stood, frozen


def frozen_make_weights(m, seed, device, dtype):
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    std = m.get("initializer_range", 0.02)
    L, D, F = m["num_hidden_layers"], m["hidden_size"], m["intermediate_size"]
    H, KH, d, V = (m["num_attention_heads"], m["num_key_value_heads"], m["head_dim"],
                   m["vocab_size"])

    def draw(*shape):
        return torch.empty(shape, dtype=dtype, device=device).normal_(0.0, std, generator=gen)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)

    w = {"embed": draw(V, D), "final_norm": ones(D),
         "layers": {"wq": draw(L, D, H * d), "wk": draw(L, D, KH * d), "wv": draw(L, D, KH * d),
                    "wo": draw(L, H * d, D), "w_gate": draw(L, D, F), "w_up": draw(L, D, F),
                    "w_down": draw(L, F, D), "ln_attn": ones(L, D), "ln_mlp": ones(L, D)}}
    if not m.get("tie_word_embeddings", False):
        w["lm_head"] = draw(D, V)
    return w


def frozen_flash_flops(s: int, heads: int, head_dim: int, window: Optional[int] = None) -> int:
    return 4 * head_dim * heads * work.flash_pairs(s, window)


def frozen_layer_params(cfg):
    D, F = cfg["hidden_size"], cfg["intermediate_size"]
    H, KH, d = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    return D * H * d + 2 * D * KH * d + H * d * D + 3 * D * F


def frozen_flash_calls(cfg, method, n):
    H, KH, d = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    W = cfg.get("sliding_window")
    out = []
    for s in work.segment_lengths(cfg, method, n):
        out.append((frozen_flash_flops(s, H, d, W), work.BF16 * d * s * (2 * H + 2 * KH)))
    return out


def frozen_prefill_flops(cfg, method, n):
    P = frozen_layer_params(cfg)
    H, d = cfg["num_attention_heads"], cfg["head_dim"]
    W = cfg.get("sliding_window")
    total = 0
    for s in work.segment_lengths(cfg, method, n):
        total += 2 * P * s + frozen_flash_flops(s, H, d, W)
    return total + 2 * cfg["hidden_size"] * cfg["vocab_size"]


def frozen_decode_attn_bytes(cfg, live, batch=1):
    H, d = cfg["num_attention_heads"], cfg["head_dim"]
    return work.BF16 * d * (2 * H * batch + 2 * int(sum(live)))


def frozen_decode_step_work(cfg, live_per_layer, batch=1):
    L, D, V = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["vocab_size"]
    H, KH, d = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    P = frozen_layer_params(cfg)
    live_sum = int(sum(live_per_layer))
    weights = L * P + D * V
    flops = 2 * weights * batch + 4 * d * (H // KH) * live_sum
    nbytes = work.BF16 * (weights + batch * D) + work.BF16 * 2 * d * live_sum
    return flops, nbytes


# -- weights: bit for bit


SMALL = {"hidden_size": 64, "intermediate_size": 96, "num_hidden_layers": 3,
         "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
         "vocab_size": 200, "sliding_window": 48, "max_position_embeddings": 4096}


def shrunk(conf: dict) -> dict:
    """The configuration with every size of its model cut small, every key kept."""
    m = dict(conf["model"])
    for k, v in SMALL.items():
        if m.get(k) is not None:
            m[k] = v
    assert set(m) == set(conf["model"])
    return dict(conf, model=m)


def leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def assert_bit_identical(got, want):
    got, want = dict(leaves(got)), dict(leaves(want))
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(bits(g), bits(w)), k


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [7, 2**33 + 5])
def test_weights_are_the_frozen_ones(name, seed):
    conf = shrunk(CONFIGS[name])
    dtype = getattr(torch, conf["dtype"])
    want = frozen_make_weights(conf["model"], seed, "cpu", dtype)
    assert_bit_identical(run.weights_of(conf, seed, "cpu"), want)
    assert_bit_identical(run.make_weights(conf["model"], seed, "cpu", dtype), want)
    assert arch.load(conf["reference"]) is arch.load("mistral")


# -- work counts: equal at the published sizes


NS = (1, 8, 4097, 16385, 32768, 36865, 65536)


def methods(conf):
    return {"fastkv": conf["method"], "fullkv": dict(conf["method"], method="fullkv")}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("method", ["fastkv", "fullkv"])
def test_counts_are_the_frozen_ones(name, method):
    conf = CONFIGS[name]
    m, meth, a = conf["model"], methods(conf)[method], conf["reference"]
    ch = m["num_key_value_heads"]
    assert work.cache_rows(m, a) == ch
    assert work.layer_params(m) == frozen_layer_params(m)
    for n in NS:
        assert work.prefill_flops(m, meth, n, a) == frozen_prefill_flops(m, meth, n)
        assert work.flash_calls(m, meth, n, a) == frozen_flash_calls(m, meth, n)
        kept = work.kept_per_layer(m, meth, n)
        for step in (0, 127):
            live = [ch * (k + step + 1) for k in kept]
            for batch in (1, 4):
                assert (work.decode_step_work(m, live, batch, arch=a)
                        == frozen_decode_step_work(m, live, batch))
            for k in kept:
                assert (work.decode_attn_bytes(m, [ch * (k + step + 1)], arch=a)
                        == frozen_decode_attn_bytes(m, [ch * (k + step + 1)]))
            assert (work.decode_attn_bytes(m, live, 4, arch=a)
                    == frozen_decode_attn_bytes(m, live, 4))


# -- the readers: the same arithmetic on the same counts

LO = 10**12
MS = 10**6


def closed_record(conf, n_tokens=(16385, 24576, 32768), new=5):
    """A closed loop's record: untraced requests with their host stamps, one
    traced request, and a trace of its prefill and decode kernels."""
    reqs = []
    for i, n in enumerate(n_tokens):
        t0 = 10.0 * i
        reqs.append(run.Record(i, [0] * n, new, t0, first=t0 + 1.25 + 0.1 * i,
                               end=t0 + 1.25 + 0.1 * i + 0.012 * (new - 1), tokens=[1] * new))
    traced = run.Record(9, [0] * 20000, new, 100.0, first=101.0, end=101.1,
                        tokens=[1] * new, traced=True)
    spans = [Interval("generate", LO, LO + 900 * MS), Interval("decode", LO + 500 * MS,
                                                               LO + 880 * MS)]
    device = ([Interval("flash_prefill_sm90_kernel", LO + (10 + 5 * k) * MS,
                        LO + (13 + 5 * k) * MS) for k in range(40)]
              + [Interval("decode_attn_tc_kernel", LO + 500 * MS + k * 10**5,
                          LO + 500 * MS + k * 10**5 + 30_000) for k in range(40)])
    trace = SimpleNamespace(window=(LO, LO + 10**9), device=device, recorded=True)
    return {"cfg": conf["model"], "method": conf["method"],
            "arch": conf["reference"], "loop": "closed",
            "requests": reqs + [traced], "trace": trace, "spans": spans}


def frozen_readings(rec):
    """The four readers' values as the harness computed them before the seam."""
    cfg, method = rec["cfg"], rec["method"]
    done = [r for r in rec["requests"] if r.first is not None and not r.traced]
    out = {}
    t = sum(r.first - r.start for r in done)
    flops = sum(frozen_prefill_flops(cfg, method, len(r.prompt)) for r in done)
    out["step.mfu.prefill"] = 100.0 * flops / (t * work.PEAK_BF16_FLOPS)
    t = sum(r.end - r.first for r in done)
    ch, least = cfg["num_key_value_heads"], 0.0
    for r in done:
        kept = work.kept_per_layer(cfg, method, len(r.prompt))
        for step in range(len(r.tokens) - 1):
            least += work.least_seconds(*frozen_decode_step_work(
                cfg, [ch * (k + step + 1) for k in kept]))
    out["step.mfu.decode"] = work.share(least, t)
    r = rec["requests"][-1]
    dev = rec["trace"].device
    durs = [i.end - i.start for i in dev if "decode_attn" in i.name]
    kept = work.kept_per_layer(cfg, method, len(r.prompt))
    bounds = [frozen_decode_attn_bytes(cfg, [ch * (k + t + 1)]) / work.PEAK_BYTES
              for t in range(len(r.tokens) - 1) for k in kept]
    out["decode_attn_roofline"] = work.share(sum(bounds) / len(bounds),
                                             sum(durs) / 1e9 / len(durs))
    durs = [i.end - i.start for i in dev if "flash_prefill" in i.name]
    calls = frozen_flash_calls(cfg, method, len(r.prompt))
    bound = sum(work.least_seconds(f, b) for f, b in calls) / len(calls)
    out["flash_prefill_roofline"] = work.share(bound, sum(durs) / 1e9 / len(durs))
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_readers_read_the_frozen_values(name):
    rec = closed_record(CONFIGS[name])
    want = frozen_readings(rec)
    for metric, value in want.items():
        assert value is not None and value > 0
        assert run.load_metric(cells.REPO, metric).read(rec) == value, metric


# -- a second architecture from new files alone

TOY = '''"""A toy architecture: a dense first layer twice as wide as the rest,
then layers of two experts of which a token uses one; a bias on the LM head
that the Mistral family does not have; one latent cache row a token."""

import torch

from perfbench.work import flash_pairs, segment_lengths


def make_weights(m, seed, device, dtype):
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    D, V, L = m["width"], m["vocab_size"], m["num_hidden_layers"]

    def draw(*shape):
        return torch.empty(shape, dtype=dtype, device=device).normal_(0.0, 0.02, generator=gen)

    return {"embed": draw(V, D), "lm_head": draw(D, V), "lm_bias": draw(V),
            "dense": draw(D, 2 * D), "experts": draw(L - 1, 2, D, D)}


def layer_weights(m):
    """Per layer: (weights a token multiplies by, weights a step reads)."""
    D, L = m["width"], m["num_hidden_layers"]
    return [(2 * D * D, 2 * D * D)] + [(D * D, 2 * D * D)] * (L - 1)


def cache_rows(m):
    return 1


def flash_calls(m, method, n):
    return [(4 * m["width"] * flash_pairs(s), 2 * 3 * m["width"] * s)
            for s in segment_lengths(m, method, n)]


def prefill_flops(m, method, n):
    return sum(2 * a * s + f for (a, _), s, (f, _) in
               zip(layer_weights(m), segment_lengths(m, method, n), flash_calls(m, method, n)))


def decode_attn_bytes(m, live, batch=1):
    return 2 * m["width"] * (2 * batch + sum(live))


def decode_step_work(m, live_per_layer, batch=1):
    w = layer_weights(m)
    live = sum(live_per_layer)
    return (2 * batch * sum(a for a, _ in w) + 4 * m["width"] * live,
            2 * sum(b for _, b in w) + 2 * m["width"] * live)
'''

TOY_CONF = {"name": "toy", "source": "a test configuration", "reference": "toy",
            "dtype": "bfloat16",
            "model": {"width": 32, "num_hidden_layers": 5, "vocab_size": 64},
            "method": dict(cells.TINY["method"], tsp_idx=2), "reduced": []}


def tree_digest(root: Path) -> str:
    h = hashlib.sha256()
    for p in sorted(root.rglob("*")):
        if p.is_file() and "__pycache__" not in p.parts:
            h.update(str(p.relative_to(root)).encode() + p.read_bytes())
    return h.hexdigest()


@pytest.fixture
def toy_root(tmp_path, monkeypatch):
    """A checkout's new files: the toy's configuration, its architecture
    module, a cell naming them; ``perfbench.arch`` finds the module where a
    later change would add it, beside ``mistral.py``."""
    before = tree_digest(PB)
    pb = tmp_path / "perfbench"
    for sub in ("arch", "configs", "traffic"):
        (pb / sub).mkdir(parents=True)
    (pb / "arch" / "toy.py").write_text(TOY)
    (pb / "configs" / "toy.json").write_text(json.dumps(TOY_CONF))
    (pb / "traffic" / "t-closed.json").write_text(json.dumps(cells.MIXES["t-closed"]))
    bench = {"configs": [{"name": "toy", "file": "perfbench/configs/toy.json"}],
             "workloads": [{"name": "toy-closed", "config": "toy", "traffic": "t-closed",
                            "chips": 1}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(arch, "__path__", [str(pb / "arch"), *arch.__path__])
    importlib.invalidate_caches()
    yield tmp_path
    sys.modules.pop("perfbench.arch.toy", None)
    assert tree_digest(PB) == before  # no file of the harness was edited


def test_toy_weights_through_the_run_path(toy_root):
    _, _, conf, _ = run.load_cell(toy_root, "toy-closed")
    w = run.weights_of(conf, 2**31 + 3, "cpu")
    assert sorted(w) == ["dense", "embed", "experts", "lm_bias", "lm_head"]
    assert w["experts"].shape == (4, 2, 32, 32) and w["lm_bias"].dtype == torch.bfloat16
    again = run.weights_of(conf, 2**31 + 3, "cpu")
    other = run.weights_of(conf, 2**31 + 4, "cpu")
    assert all(torch.equal(w[k], again[k]) for k in w)
    assert not torch.equal(w["experts"], other["experts"])


def test_toy_counts_through_the_work_dispatch(toy_root):
    toy = arch.load("toy")
    m, meth = TOY_CONF["model"], TOY_CONF["method"]
    assert work.cache_rows(m, "toy") == 1
    for n in (9, 300, 4097):
        assert work.prefill_flops(m, meth, n, "toy") == toy.prefill_flops(m, meth, n)
        assert work.flash_calls(m, meth, n, "toy") == toy.flash_calls(m, meth, n)
    # the dense first layer and the experts: a token multiplies by one expert
    # of each later layer, a step reads both
    f, b = work.decode_step_work(m, [0] * 5, arch="toy")
    assert f == 2 * (2 * 32 * 32 + 4 * 32 * 32) and b == 2 * (5 * 2 * 32 * 32)
    assert work.decode_attn_bytes(m, [10], arch="toy") == 2 * 32 * 12


def test_toy_shares_through_the_readers(toy_root):
    """The readers take the toy's counts by the record's architecture; the
    same record read as a Mistral-family model would not even find its keys."""
    toy = arch.load("toy")
    rec = closed_record(TOY_CONF, n_tokens=(300, 400), new=4)
    done = rec["requests"][:-1]
    got = {name: run.load_metric(cells.REPO, name).read(rec)
           for name in ("step.mfu.prefill", "step.mfu.decode", "decode_attn_roofline",
                        "flash_prefill_roofline")}
    m, meth = TOY_CONF["model"], TOY_CONF["method"]
    t = sum(r.first - r.start for r in done)
    flops = sum(toy.prefill_flops(m, meth, len(r.prompt)) for r in done)
    assert got["step.mfu.prefill"] == 100.0 * flops / (t * work.PEAK_BF16_FLOPS)
    least = 0.0  # in the reader's order: ``sum`` of floats rounds otherwise
    for r in done:
        kept = work.kept_per_layer(m, meth, len(r.prompt))
        for s in range(len(r.tokens) - 1):
            least += work.least_seconds(*toy.decode_step_work(m, [k + s + 1 for k in kept]))
    assert got["step.mfu.decode"] == work.share(least, sum(r.end - r.first for r in done))
    assert got["decode_attn_roofline"] > 0 and got["flash_prefill_roofline"] > 0
    with pytest.raises(KeyError):
        run.load_metric(cells.REPO, "step.mfu.prefill").read(dict(rec, arch="mistral"))


# -- the seam holds: no shape key outside the architecture modules


HARNESS = sorted([p for p in PB.glob("*.py")] + list((PB / "metrics").glob("*.py")))


@pytest.mark.parametrize("path", HARNESS, ids=lambda p: str(p.relative_to(PB)))
def test_no_shape_key_outside_the_architecture_modules(path):
    text = path.read_text()
    found = [k for k in SHAPE_KEYS if re.search(rf"\b{k}\b", text)]
    assert not found, f"{path.name} reads {found}: count it in perfbench/arch/"


@pytest.mark.parametrize("path", sorted((PB / "arch").glob("*.py")), ids=lambda p: p.name)
def test_architecture_imports_nothing_of_the_program(path):
    """The benchmark makes the weights and counts the work itself."""
    assert top_imports(path) <= {"__future__", "importlib", "math", "types", "typing", "torch",
                                 "perfbench"}
