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
@pytest.mark.parametrize("window", [None, 90])
@pytest.mark.parametrize("dtype,d", CASES)
def test_flash_prefill_kernel_rect_matches_plain(cuda_device, dtype, d, window):
    """The rectangular form, as chunked admission calls it: a chunk of c = 100
    queries per example at its own offset against a 640-slot key scratch whose
    positions are the slot indices. Example 0 is gated at its key count
    (k_hi = start + c), example 1 below it (k_hi = 610 < k_count = 640 < Sk
    would leak the poisoned slots from 610 on if the gate let them through);
    the window bites on most rows."""
    gen = torch.Generator(device=cuda_device).manual_seed(d + 11)
    b, c, S = 2, 100, 640
    q = torch.randn((b, 8, c, d), generator=gen, device=cuda_device).to(dtype)
    k = torch.randn((b, 2, S, d), generator=gen, device=cuda_device).to(dtype)
    v = torch.randn((b, 2, S, d), generator=gen, device=cuda_device).to(dtype)
    k[1, :, 610:] = 30.0
    v[1, :, 610:] = 60.0
    starts = torch.tensor([200, 540], dtype=torch.int32, device=cuda_device)
    qpos = starts[:, None] + torch.arange(c, dtype=torch.int32, device=cuda_device)[None]
    kpos = torch.arange(S, dtype=torch.int32, device=cuda_device)[None].repeat(b, 1)
    k_count = torch.tensor([300, 640], dtype=torch.int32, device=cuda_device)
    k_hi = torch.tensor([300, 610], dtype=torch.int32, device=cuda_device)
    before, rect_before = tfp.launches, tfp.rect_launches
    out = tfp.flash_attention(q, k, v, qpos, k_count, sliding_window=window,
                              k_positions=kpos, k_count=k_count, k_hi=k_hi)
    assert tfp.launches == before + 1 and tfp.rect_launches == rect_before + 1
    _agrees(out, lambda *a: tfp.flash_attention_plain(
        *a, sliding_window=window, k_positions=kpos, k_count=k_count, k_hi=k_hi),
        q, k, v, qpos, k_count)
    assert out[1].float().abs().max() < 10  # nothing of the poisoned slots


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
    # the rectangular form's arguments
    k = torch.randn((1, 2, 128, 64), device=cuda_device)
    kpos = torch.arange(128, dtype=torch.int32, device=cuda_device)[None]
    with pytest.raises(ValueError, match="k_positions"):
        tfp.flash_attention(q, k, k, pos, cnt)
    with pytest.raises(ValueError, match="k_positions"):
        tfp.flash_attention(q, k, k, pos, cnt, k_positions=kpos[:, :64])
    with pytest.raises(ValueError, match="k_hi"):
        tfp.flash_attention(q, k, k, pos, cnt, k_positions=kpos, k_hi=cnt[None])
    with pytest.raises(ValueError, match="k_count"):
        tfp.flash_attention(q, k, k, pos, cnt, k_positions=kpos, k_count=cnt.repeat(2))
    with pytest.raises(NotImplementedError, match="head_dim"):
        tfp.flash_attention(q[..., :32], k[..., :32], k[..., :32], pos, cnt, k_positions=kpos,
                            k_hi=cnt)
