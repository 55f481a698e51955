"""The port's CUDA kernels against their plain versions, on a card.

Marked ``cuda``: without a card every test here skips (the kernels have no
CPU mode). This file imports neither JAX nor the JAX package, so it also runs
where JAX is not installed, without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -m cuda -p no:cacheprovider

Tolerances: the reference is the plain version in float32 on float32 copies of
the same inputs, and each output row is held to its own scale by
``fastkv_tpu_torch.kernels.agreement`` (bf16: rms error <= 1e-2 of the row's
rms, each element <= 2^-5 of max(|ref|, row rms); float32: 1e-4 and 1e-3;
rows that see no key exactly 0).
"""

import pytest
import torch

from fastkv_tpu_torch.engine.decode import window_mask
from fastkv_tpu_torch.kernels import agreement
from fastkv_tpu_torch.ops import decode_attn as tda
from fastkv_tpu_torch.ops import flash_prefill as tfp


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


CASES = [(dtype, d) for dtype in agreement.TOLERANCES for d in tfp.HEAD_DIMS]


def _agrees(out, plain, *args):
    """out against ``plain`` run in float32 on float32 copies of the inputs."""
    ref = plain(*(a.float() if a.is_floating_point() else a for a in args))
    r = agreement.compare(out, ref, agreement.TOLERANCES[out.dtype])
    assert r["ok"], r


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", CASES)
def test_flash_prefill_kernel_matches_plain(cuda_device, dtype, d):
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    q = torch.randn((2, 8, 300, d), generator=gen, device=cuda_device).to(dtype)
    k = torch.randn((2, 2, 300, d), generator=gen, device=cuda_device).to(dtype)
    v = torch.randn((2, 2, 300, d), generator=gen, device=cuda_device).to(dtype)
    pos = torch.arange(300, dtype=torch.int32, device=cuda_device)[None].repeat(2, 1)
    pos[1, 211:] = 0  # post-TSP tail: these rows see only key 0
    cnt = torch.tensor([300, 211], dtype=torch.int32, device=cuda_device)
    before = tfp.launches
    out = tfp.flash_attention(q, k, v, pos, cnt)
    assert tfp.launches == before + 1
    _agrees(out, tfp.flash_attention_plain, q, k, v, pos, cnt)


@pytest.mark.cuda
@pytest.mark.parametrize("scattered", [False, True])
@pytest.mark.parametrize("dtype,d", CASES)
def test_flash_prefill_kernel_window_matches_plain(cuda_device, dtype, d, scattered):
    """Under a sliding window: layout indices (as the engine passes them) with
    a ragged count, or scattered ascending positions with a zero tail (the
    tail rows see key 0 at most), so that the kernel's skip of key tiles below
    the band is held to the plain version on both."""
    gen = torch.Generator(device=cuda_device).manual_seed(d + 7)
    b, s, window = 2, 700, 150
    q = torch.randn((b, 8, s, d), generator=gen, device=cuda_device).to(dtype)
    k = torch.randn((b, 2, s, d), generator=gen, device=cuda_device).to(dtype)
    v = torch.randn((b, 2, s, d), generator=gen, device=cuda_device).to(dtype)
    pos = torch.arange(s, dtype=torch.int32, device=cuda_device)[None].repeat(b, 1)
    cnt = torch.tensor([s, 523], dtype=torch.int32, device=cuda_device)
    if scattered:
        for i in range(b):
            n = int(cnt[i])
            pick = torch.randperm(3 * s, generator=gen, device=cuda_device)[:n].sort().values
            pos[i, :n] = pick.to(torch.int32)
            pos[i, n:] = 0
    before = tfp.launches
    out = tfp.flash_attention(q, k, v, pos, cnt, sliding_window=window)
    assert tfp.launches == before + 1
    _agrees(out, lambda *a: tfp.flash_attention_plain(*a, sliding_window=window),
            q, k, v, pos, cnt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", CASES)
def test_decode_attn_kernel_matches_plain(cuda_device, dtype, d):
    gen = torch.Generator(device=cuda_device).manual_seed(d + 1)
    q = torch.randn((2, 8, 1, d), generator=gen, device=cuda_device).to(dtype)
    kc = torch.randn((2, 2, 777, d), generator=gen, device=cuda_device).to(dtype)
    vc = torch.randn((2, 2, 777, d), generator=gen, device=cuda_device).to(dtype)
    valid = torch.rand((2, 2, 777), generator=gen, device=cuda_device) < 0.5
    valid[1, 1] = False  # a cache head with no valid slot gives 0
    before = tda.launches
    out = tda.decode_attention(q, kc, vc, valid)
    assert tda.launches == before + 1
    _agrees(out, tda.decode_attention_plain, q, kc, vc, valid)
    assert torch.all(out[1, 4:] == 0)
    shared = valid[:, 0]  # one [b, C] mask broadcast over the cache heads
    _agrees(tda.decode_attention(q, kc, vc, shared), tda.decode_attention_plain,
            q, kc, vc, shared)
    cut = window_mask(valid, 100)  # a sliding window's rank cut, per cache head
    _agrees(tda.decode_attention(q, kc, vc, cut), tda.decode_attention_plain, q, kc, vc, cut)


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    q = torch.randn((1, 4, 64, 32), device=cuda_device)
    pos = torch.arange(64, dtype=torch.int32, device=cuda_device)[None]
    cnt = torch.tensor([64], dtype=torch.int32, device=cuda_device)
    with pytest.raises(NotImplementedError, match="head_dim"):
        tfp.flash_attention(q, q[:, :2], q[:, :2], pos, cnt)
    q = torch.randn((1, 4, 64, 64), device=cuda_device)
    with pytest.raises(ValueError, match="sliding_window"):
        tfp.flash_attention(q, q[:, :2], q[:, :2], pos, cnt, sliding_window=0)
    with pytest.raises(TypeError):
        tfp.flash_attention(q.half(), q[:, :2].half(), q[:, :2].half(), pos, cnt)
