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

from fastkv_tpu_torch.core import quant
from fastkv_tpu_torch.engine.decode import window_mask
from fastkv_tpu_torch.kernels import agreement
from fastkv_tpu_torch.ops import decode_attn as tda
from fastkv_tpu_torch.ops import flash_prefill as tfp
from fastkv_tpu_torch.policies.selection import window_indices


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


def _qkv_views(gen, b, H, KH, s, d, dtype, device):
    """q [b, H, s, d] and k/v as the transposed views of [b, s, KH, d] that
    ``qkv_proj`` hands the kernel (strides: batch s*KH*d, head d, row KH*d)."""
    q = torch.randn((b, s, H, d), generator=gen, device=device).to(dtype).transpose(1, 2)
    k = torch.randn((b, s, KH, d), generator=gen, device=device).to(dtype).transpose(1, 2)
    v = torch.randn((b, s, KH, d), generator=gen, device=device).to(dtype).transpose(1, 2)
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 127, 128, 129, 300])
@pytest.mark.parametrize("dtype,d", CASES)
def test_flash_prefill_kernel_tile_edges(cuda_device, dtype, d, s):
    """Lengths at the bf16 kernel's 128-row tile edges, a ragged batch of two
    whose second count ends mid-tile (its rows past the count keep their
    layout positions, as prefill passes them)."""
    gen = torch.Generator(device=cuda_device).manual_seed(d + s)
    q, k, v = _qkv_views(gen, 2, 8, 2, s, d, dtype, cuda_device)
    pos = torch.arange(s, dtype=torch.int32, device=cuda_device)[None].repeat(2, 1)
    cnt = torch.tensor([s, max(1, s - 45)], dtype=torch.int32, device=cuda_device)
    out = tfp.flash_attention(q, k, v, pos, cnt)
    _agrees(out, tfp.flash_attention_plain, q, k, v, pos, cnt)


@pytest.mark.cuda
@pytest.mark.parametrize("H,KH", [(8, 8), (8, 2), (10, 2)])
@pytest.mark.parametrize("dtype,d", CASES)
def test_flash_prefill_kernel_group_sizes(cuda_device, dtype, d, H, KH):
    """GQA groups of 1, 4 and 5 query heads per kv head, on the transposed
    k/v views of ``qkv_proj``, with and without a window."""
    gen = torch.Generator(device=cuda_device).manual_seed(d + H + KH)
    s = 300
    q, k, v = _qkv_views(gen, 1, H, KH, s, d, dtype, cuda_device)
    pos = torch.arange(s, dtype=torch.int32, device=cuda_device)[None]
    cnt = torch.tensor([261], dtype=torch.int32, device=cuda_device)
    for window in (None, 100):
        out = tfp.flash_attention(q, k, v, pos, cnt, sliding_window=window)
        _agrees(out, lambda *a: tfp.flash_attention_plain(*a, sliding_window=window),
                q, k, v, pos, cnt)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", CASES)
def test_flash_prefill_kernel_rect_mid_tile_gate(cuda_device, dtype, d):
    """A rectangular chunk that starts mid-tile (300 and 77 are not multiples
    of the 128-key tile) with its gate inside the chunk (k_hi 420 < 300 + 200,
    277 < 77 + 200): keys from the gate on are invisible, poisoned here."""
    gen = torch.Generator(device=cuda_device).manual_seed(d + 13)
    b, c, S = 2, 200, 1024
    q = torch.randn((b, 8, c, d), generator=gen, device=cuda_device).to(dtype)
    k = torch.randn((b, 2, S, d), generator=gen, device=cuda_device).to(dtype)
    v = torch.randn((b, 2, S, d), generator=gen, device=cuda_device).to(dtype)
    k_hi = torch.tensor([420, 277], dtype=torch.int32, device=cuda_device)
    for i in range(b):
        k[i, :, int(k_hi[i]):] = 30.0
        v[i, :, int(k_hi[i]):] = 60.0
    starts = torch.tensor([300, 77], dtype=torch.int32, device=cuda_device)
    qpos = starts[:, None] + torch.arange(c, dtype=torch.int32, device=cuda_device)[None]
    kpos = torch.arange(S, dtype=torch.int32, device=cuda_device)[None].repeat(b, 1)
    k_count = starts + c
    before = tfp.rect_launches
    out = tfp.flash_attention(q, k, v, qpos, k_count, k_positions=kpos, k_count=k_count,
                              k_hi=k_hi)
    assert tfp.rect_launches == before + 1
    _agrees(out, lambda *a: tfp.flash_attention_plain(
        *a, k_positions=kpos, k_count=k_count, k_hi=k_hi), q, k, v, qpos, k_count)
    assert out.float().abs().max() < 10  # nothing of the poisoned slots


@pytest.mark.cuda
def test_flash_prefill_kernel_raises_on_misaligned_tma_operands(cuda_device):
    """The bf16 kernel reads q/k/v through TMA: a base that is not 16-byte
    aligned, or a row stride that is not a multiple of 16 bytes, raises
    (never a copy, never another kernel)."""
    b, H, KH, s, d = 1, 4, 2, 64, 64
    pos = torch.arange(s, dtype=torch.int32, device=cuda_device)[None]
    cnt = torch.tensor([s], dtype=torch.int32, device=cuda_device)
    k = torch.randn((b, KH, s, d), device=cuda_device).bfloat16()
    flat = torch.randn(b * H * s * d + 1, device=cuda_device).bfloat16()
    q_shifted = flat[1:].view(b, H, s, d)  # base 2 bytes past an aligned one
    before = tfp.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfp.flash_attention(q_shifted, k, k, pos, cnt)
    q_padded = torch.randn((b, H, s, d + 4), device=cuda_device).bfloat16()[..., :d]
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        tfp.flash_attention(q_padded, k, k, pos, cnt)
    assert tfp.launches == before


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


def _window_rows(q, pos, cnt, W):
    """The last W valid query rows of each example and their positions (-1 on
    the rows of a prompt shorter than W), as prefill hands them over."""
    idx, ok = window_indices(cnt - W, W, cnt)
    b, h, _, d = q.shape
    q_win = torch.gather(q, 2, idx[:, None, :, None].expand(b, h, W, d))
    return q_win, torch.where(ok, torch.gather(pos, 1, idx), -1).to(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("W,window,scattered", [(8, None, False), (12, 150, False),
                                                (70, None, True), (1, 150, False)])
@pytest.mark.parametrize("dtype,d", CASES)
def test_flash_prefill_kernel_scores_match_plain(cuda_device, dtype, d, W, window, scattered):
    """The fused observation-window scores: the attention output as the
    square form's, and the scores [b, H, s] float32 (rows [b * H, s]) held at
    the float32 limits, since the strip takes the same inputs in float32. A
    ragged batch with one prompt shorter than W; scattered post-TSP positions;
    W = 70 takes two row groups of the kernel's 64; W = 1 and W = 12 under a
    window."""
    gen = torch.Generator(device=cuda_device).manual_seed(d + W)
    b, s = 3, 300
    q = torch.randn((b, 8, s, d), generator=gen, device=cuda_device).to(dtype)
    k = torch.randn((b, 2, s, d), generator=gen, device=cuda_device).to(dtype)
    v = torch.randn((b, 2, s, d), generator=gen, device=cuda_device).to(dtype)
    pos = torch.arange(s, dtype=torch.int32, device=cuda_device)[None].repeat(b, 1)
    cnt = torch.tensor([s, 211, 5], dtype=torch.int32, device=cuda_device)
    if scattered:
        for i in range(b):
            n = int(cnt[i])
            pick = torch.randperm(3 * s, generator=gen, device=cuda_device)[:n].sort().values
            pos[i, :n] = pick.to(torch.int32)
            pos[i, n:] = 0
    q_win, qw_pos = _window_rows(q, pos, cnt, W)
    before = (tfp.launches, tfp.scores_launches, tfp.finish_launches)
    out, scores = tfp.flash_attention(q, k, v, pos, cnt, sliding_window=window, window_q=q_win,
                                      window_q_pos=qw_pos)
    assert (tfp.launches, tfp.scores_launches, tfp.finish_launches) == tuple(
        n + 1 for n in before)
    ref_out, ref_scores = tfp.flash_attention_plain(
        q.float(), k.float(), v.float(), pos, cnt, window, window_q=q_win.float(),
        window_q_pos=qw_pos)
    r = agreement.compare(out, ref_out, agreement.TOLERANCES[dtype])
    assert r["ok"], r
    assert scores.dtype == torch.float32 and scores.shape == (b, 8, s)
    r = agreement.compare(scores, ref_scores, agreement.TOLERANCES[torch.float32])
    assert r["ok"], r
    assert torch.all(scores[1, :, 211:] == 0)  # columns at or past the count


def _int8_cache(kc, vc):
    """An int8 cache and its scales, as prefill and decode store them."""
    ki, ks = quant.quantize_kv(kc)
    vi, vs = quant.quantize_kv(vc)
    return ki, vi, ks, vs


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", CASES)
def test_decode_attn_kernel_int8_matches_plain(cuda_device, dtype, d):
    """An int8 cache: per-slot scales folded into the logits and P, read
    through one layer's view of a stacked [L, b, CH, C] cache (its strides)."""
    gen = torch.Generator(device=cuda_device).manual_seed(d + 3)
    L, b, CH, C = 2, 2, 2, 777
    q = torch.randn((b, 8, 1, d), generator=gen, device=cuda_device).to(dtype)
    kc, vc, ks, vs = _int8_cache(
        torch.randn((L, b, CH, C, d), generator=gen, device=cuda_device),
        torch.randn((L, b, CH, C, d), generator=gen, device=cuda_device))
    valid = torch.rand((L, b, CH, C), generator=gen, device=cuda_device) < 0.5
    valid[1, 1, 1] = False  # a cache head with no valid slot gives 0
    before = (tda.launches, tda.int8_launches)
    out = tda.decode_attention(q, kc[1], vc[1], valid[1], k_scale=ks[1], v_scale=vs[1])
    assert (tda.launches, tda.int8_launches) == tuple(n + 1 for n in before)
    plain = lambda *a: tda.decode_attention_plain(*a, k_scale=ks[1], v_scale=vs[1])  # noqa: E731
    _agrees(out, plain, q, kc[1], vc[1], valid[1])
    assert torch.all(out[1, 4:] == 0)
    shared = valid[1][:, 0]
    _agrees(tda.decode_attention(q, kc[1], vc[1], shared, k_scale=ks[1], v_scale=vs[1]),
            plain, q, kc[1], vc[1], shared)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype,d", CASES)
def test_decode_attn_kernel_window_matches_plain(cuda_device, dtype, d, int8):
    """The kernel's own window term, kpos > qpos - W, over a scattered cache
    (kept prefix of ascending positions, then decode slots), per cache head,
    with and without an int8 cache."""
    gen = torch.Generator(device=cuda_device).manual_seed(d + 5)
    b, CH, C, W = 2, 2, 700, 200
    q = torch.randn((b, 8, 1, d), generator=gen, device=cuda_device).to(dtype)
    kc = torch.randn((b, CH, C, d), generator=gen, device=cuda_device).to(dtype)
    vc = torch.randn((b, CH, C, d), generator=gen, device=cuda_device).to(dtype)
    valid = torch.rand((b, CH, C), generator=gen, device=cuda_device) < 0.7
    k_pos = torch.sort(torch.randint(0, 900, (b, CH, C), generator=gen, device=cuda_device),
                       dim=-1).values.to(torch.int32)
    q_pos = torch.tensor([900, 650], dtype=torch.int32, device=cuda_device)
    scales = {}
    if int8:
        kc, vc, ks, vs = _int8_cache(kc, vc)
        scales = dict(k_scale=ks, v_scale=vs)
    before = (tda.launches, tda.window_launches, tda.int8_launches)
    out = tda.decode_attention(q, kc, vc, valid, q_pos=q_pos, k_pos=k_pos, sliding_window=W,
                               **scales)
    assert (tda.launches, tda.window_launches, tda.int8_launches) == (
        before[0] + 1, before[1] + 1, before[2] + int8)
    _agrees(out, lambda *a: tda.decode_attention_plain(
        *a, q_pos=q_pos, k_pos=k_pos, sliding_window=W, **scales), q, kc, vc, valid)


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
    # the fused scores take the square form only
    q_win, qw_pos = _window_rows(q, pos, cnt, 8)
    with pytest.raises(ValueError, match="square"):
        tfp.flash_attention(q, k, k, pos, cnt, k_positions=kpos, window_q=q_win,
                            window_q_pos=qw_pos)
    # an int8 cache without its scales
    kc = torch.randn((1, 2, 128, 64), device=cuda_device)
    ki, _, ks, _ = _int8_cache(kc, kc)
    valid = torch.ones((1, 128), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        tda.decode_attention(q[:, :, :1], ki, ki, valid)
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        tda.decode_attention(q[:, :, :1], ki, ki, valid, k_scale=ks)


def _decode_cache(gen, b, CH, C, d, dtype, device, frac=0.5):
    k = torch.randn((b, CH, C, d), generator=gen, device=device).to(dtype)
    v = torch.randn((b, CH, C, d), generator=gen, device=device).to(dtype)
    valid = torch.rand((b, CH, C), generator=gen, device=device) < frac
    return k, v, valid


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("C", [1, 63, 777, 8320])
@pytest.mark.parametrize("g", [1, 4, 8, 10])
def test_decode_attn_kernel_groups_and_ragged_cache(cuda_device, g, C, int8):
    """The bf16-q kernel's query groups (1 = SnapKV's per-query-head cache, 10
    past the MMA's 8-row half) against caches of 1, 63 (one ragged tile), 777
    and 8320 slots (several tiles a split, several splits merged), bf16 or
    int8 (whose two walks take alternate tiles: an odd count leaves one walk
    a tile short)."""
    gen = torch.Generator(device=cuda_device).manual_seed(g * 10000 + C)
    q = torch.randn((2, 2 * g, 1, 128), generator=gen, device=cuda_device).bfloat16()
    kc, vc, valid = _decode_cache(gen, 2, 2, C, 128, torch.bfloat16, cuda_device)
    valid[:, :, 0] = True
    scales = {}
    if int8:
        kc, vc, ks, vs = _int8_cache(kc, vc)
        scales = dict(k_scale=ks, v_scale=vs)
    before = tda.launches
    out = tda.decode_attention(q, kc, vc, valid, **scales)
    assert tda.launches == before + 1
    _agrees(out, lambda *a: tda.decode_attention_plain(*a, **scales), q, kc, vc, valid)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("dtype,d", CASES)
def test_decode_attn_kernel_empty_rows_runs_and_masks(cuda_device, dtype, d, int8):
    """A cache head and a whole example with no visible slot write exactly 0;
    runs of fully invalid 64-slot tiles (never read) between visible ones;
    the [b, C] mask broadcast over the cache heads; batch 4 with a mask of
    its own per example, as the Scheduler's decode hands them over."""
    gen = torch.Generator(device=cuda_device).manual_seed(d + 17 + int8)
    b, CH, C = 4, 2, 4000
    q = torch.randn((b, 8, 1, d), generator=gen, device=cuda_device).to(dtype)
    kc, vc, valid = _decode_cache(gen, b, CH, C, d, dtype, cuda_device, frac=0.3)
    valid[0, :, 200:3000] = False  # runs of invalid tiles, a ragged edge inside a tile
    valid[1, 1] = False  # a cache head with none
    valid[2] = False  # an example with none
    valid[3, :, 500:] = False  # a much shorter example
    scales = {}
    if int8:
        kc, vc, ks, vs = _int8_cache(kc, vc)
        scales = dict(k_scale=ks, v_scale=vs)
    plain = lambda *a: tda.decode_attention_plain(*a, **scales)  # noqa: E731
    out = tda.decode_attention(q, kc, vc, valid, **scales)
    _agrees(out, plain, q, kc, vc, valid)
    assert torch.all(out[1, 4:] == 0) and torch.all(out[2] == 0)
    shared = valid[:, 0]
    _agrees(tda.decode_attention(q, kc, vc, shared, **scales), plain, q, kc, vc, shared)


@pytest.mark.cuda
def test_decode_attn_kernel_back_to_back_calls_share_counters(cuda_device):
    """The bf16 kernel's arrival counters are left 0 by each call's merging
    CTA: calls of different split counts back to back on one stream, then
    each output against its plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(23)
    calls = []
    for C in (8320, 777, 41088, 1, 8320, 2000):
        q = torch.randn((1, 32, 1, 128), generator=gen, device=cuda_device).bfloat16()
        kc, vc, valid = _decode_cache(gen, 1, 8, C, 128, torch.bfloat16, cuda_device)
        calls.append((tda.decode_attention(q, kc, vc, valid), q, kc, vc, valid))
    torch.cuda.synchronize()
    for out, *args in calls:
        _agrees(out, tda.decode_attention_plain, *args)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_decode_attn_kernel_graph_replays_between_eager_calls(cuda_device, int8):
    """A CUDA graph of a call keeps the arrival counters of the stream it was
    captured on (``ops.decode_attn._arrival_counters``): replayed on that
    stream in order with eager calls there, replay, eager call, replay, each
    output against its plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(29 + int8)
    kc, vc, valid = _decode_cache(gen, 1, 8, 8320, 128, torch.bfloat16, cuda_device)
    scales = {}
    if int8:
        kc, vc, ks, vs = _int8_cache(kc, vc)
        scales = dict(k_scale=ks, v_scale=vs)
    assert tda.split_plan(1, 8, 4, 8320, torch.cuda.get_device_properties(
        cuda_device).multi_processor_count).splits > 1  # the counters are used
    q = torch.randn((1, 32, 1, 128), generator=gen, device=cuda_device).bfloat16()
    q_eager = torch.randn((1, 32, 1, 128), generator=gen, device=cuda_device).bfloat16()
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        tda.decode_attention(q, kc, vc, valid, **scales)  # built, counters made
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            captured = tda.decode_attention(q, kc, vc, valid, **scales)
        graph.replay()
        first = captured.clone()
        eager = tda.decode_attention(q_eager, kc, vc, valid, **scales)
        graph.replay()
        second = captured.clone()
    torch.cuda.synchronize()
    plain = lambda *a: tda.decode_attention_plain(*a, **scales)  # noqa: E731
    for out, qq in ((first, q), (eager, q_eager), (second, q)):
        _agrees(out, plain, qq, kc, vc, valid)


@pytest.mark.cuda
def test_decode_attn_kernel_raises_on_operands_it_cannot_copy(cuda_device):
    """The bf16 kernel copies K/V rows 16 bytes at a time (cp.async): a base
    that is not 16-byte aligned, or a slot stride that is not a multiple of
    16 bytes, raises without a launch (never a copy, never another kernel)."""
    b, CH, C, d = 1, 2, 64, 64
    q = torch.randn((b, 8, 1, d), device=cuda_device).bfloat16()
    valid = torch.ones((b, C), dtype=torch.bool, device=cuda_device)
    k = torch.randn((b, CH, C, d), device=cuda_device).bfloat16()
    flat = torch.randn(b * CH * C * d + 1, device=cuda_device).bfloat16()
    before = tda.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        tda.decode_attention(q, flat[1:].view(b, CH, C, d), k, valid)
    padded = torch.randn((b, CH, C, d + 4), device=cuda_device).bfloat16()[..., :d]
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        tda.decode_attention(q, k, padded, valid)
    assert tda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gemfilter_pass2_s896", "h2o_cache_CH32", "gemfilter_cache"])
def test_kernels_at_h2o_and_gemfilter_shapes(cuda_device, case):
    """Llama-3.1-8B's shapes on the H2O and GemFilter paths: flash at
    GemFilter's pass-2 bucket (896, seven query tiles, count 819); decode on
    H2O's per-query-head cache at batch 1 (CH = H = 32, C = 1032) and on
    GemFilter's FullKV cache (CH = 8, C = 896 + 128)."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    bf16 = torch.bfloat16
    if case == "gemfilter_pass2_s896":
        q = torch.randn((1, 32, 896, 128), generator=gen, device=cuda_device).to(bf16)
        k = torch.randn((1, 896, 8, 128), generator=gen, device=cuda_device).to(bf16)
        v = torch.randn((1, 896, 8, 128), generator=gen, device=cuda_device).to(bf16)
        k, v = k.transpose(1, 2), v.transpose(1, 2)  # as qkv_proj hands them over
        pos = torch.arange(896, dtype=torch.int32, device=cuda_device)[None]
        cnt = torch.tensor([819], dtype=torch.int32, device=cuda_device)
        _agrees(tfp.flash_attention(q, k, v, pos, cnt), tfp.flash_attention_plain,
                q, k, v, pos, cnt)
        return
    CH, C, kept = (32, 1032, 827) if case == "h2o_cache_CH32" else (8, 1024, 819)
    q = torch.randn((1, 32, 1, 128), generator=gen, device=cuda_device).to(bf16)
    kc = torch.randn((1, CH, C, 128), generator=gen, device=cuda_device).to(bf16)
    vc = torch.randn((1, CH, C, 128), generator=gen, device=cuda_device).to(bf16)
    valid = torch.zeros((1, CH, C), dtype=torch.bool, device=cuda_device)
    for h in range(CH):
        valid[0, h, torch.randperm(C - 128, generator=gen, device=cuda_device)[:kept]] = True
    valid[..., C - 128:C - 97] = True  # 31 decode slots
    before = tda.launches
    out = tda.decode_attention(q, kc, vc, valid)
    assert tda.launches == before + 1
    _agrees(out, tda.decode_attention_plain, q, kc, vc, valid)


def _tiny_params_cpu_and_card(cfg, device):
    """The tiny config's float32 weights, their query and key projections
    scaled by 8 (so that no top-k boundary lies within float32 rounding of
    the card's and the CPU's orders of summation), on the CPU and on the
    card."""
    from fastkv_tpu_torch.models.llama import init_params

    p_cpu = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    for name in ("wq", "wk"):
        p_cpu["layers"][name] = p_cpu["layers"][name] * 8.0
    p_gpu = {k: v.to(device) for k, v in p_cpu.items() if k != "layers"}
    p_gpu["layers"] = {k: v.to(device) for k, v in p_cpu["layers"].items()}
    return p_cpu, p_gpu


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 48])
@pytest.mark.parametrize("method", ["h2o", "gemfilter"])
def test_h2o_and_gemfilter_on_the_card_match_the_cpu(cuda_device, method, window):
    """Engine.generate and the Scheduler (prefill_chunk 64: both admit
    whole) in float32 on the card against the port on the CPU: tokens and
    events equal, and the kernels launched on the card."""
    import numpy as np

    from fastkv_tpu_torch.core.config import EngineConfig, Method, MethodConfig, ModelConfig
    from fastkv_tpu_torch.engine.generate import Engine
    from fastkv_tpu_torch.engine.scheduler import Scheduler

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig.tiny(head_dim=64, sliding_window=window)
    p_cpu, p_gpu = _tiny_params_cpu_and_card(cfg, cuda_device)
    mcfg = MethodConfig(method=Method(method), eviction_mode="proportional", retain_rate=0.3,
                        filter_idx=1)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (300, 181, 457)]
    ecfg = EngineConfig(prefill_buckets=(512,), capacity_align=8)
    want = Engine(p_cpu, cfg, mcfg, ecfg, device="cpu").generate(prompts, 16)
    before = (tfp.launches, tda.launches)
    got = Engine(p_gpu, cfg, mcfg, ecfg).generate(prompts, 16)
    assert got == want
    flash = cfg.num_layers + (1 if method == "gemfilter" else 0)  # filter_idx layers of pass 1
    assert (tfp.launches - before[0], tda.launches - before[1]) == (flash, cfg.num_layers * 15)

    ecfg = EngineConfig(prefill_buckets=(256,), capacity_align=8, prefill_chunk=64)
    reqs = [(rng.integers(0, cfg.vocab_size, n).tolist(), b)
            for n, b in ((230, 24), (201, 6), (140, 12))]

    def serve(params, device):
        sched = Scheduler(params, cfg, mcfg, ecfg, max_batch=2, bucket=256, max_new_tokens=24,
                          device=device)
        for prompt, budget in reqs:
            sched.submit(prompt, budget)
        toks = {r.req_id: r.tokens for r in sched.run()}
        return toks, [e if e[0] != "decode" else ("decode",) for e in sched.events]

    want, got = serve(p_cpu, "cpu"), serve(p_gpu, "cuda")
    assert got == want
    assert not [e for e in got[1] if e[0] in ("chunk", "finish")]


@pytest.mark.cuda
@pytest.mark.parametrize("s,count", [(2048, 1939), (256, 247), (5376, 5301)])
def test_flash_kernel_at_pyramid_shapes(cuda_device, s, count):
    """Llama-3.1-8B's heads (32 / 8, d = 128, bf16) at the lengths of
    PyramidInfer's layers at bucket 8192: the deepest llama_60 layer (2048),
    the deepest llama_35 layer (256) and a middle one (5376), each with a
    gathered layout (ascending original positions, a zeroed tail past a
    count below s)."""
    gen = torch.Generator(device=cuda_device).manual_seed(s)
    bf16 = torch.bfloat16
    q = torch.randn((1, 32, s, 128), generator=gen, device=cuda_device).to(bf16)
    k = torch.randn((1, s, 8, 128), generator=gen, device=cuda_device).to(bf16).transpose(1, 2)
    v = torch.randn((1, s, 8, 128), generator=gen, device=cuda_device).to(bf16).transpose(1, 2)
    pos = torch.zeros((1, s), dtype=torch.int32, device=cuda_device)
    pos[0, :count] = torch.randperm(8192, generator=gen, device=cuda_device)[:count].sort().values
    cnt = torch.tensor([count], dtype=torch.int32, device=cuda_device)
    before = tfp.launches
    out = tfp.flash_attention(q, k, v, pos, cnt)
    assert tfp.launches == before + 1
    _agrees(out, tfp.flash_attention_plain, q, k, v, pos, cnt)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 48])
def test_pyramidinfer_on_the_card_matches_the_cpu(cuda_device, window):
    """PyramidInfer (llama_35, exceed 4, so that decode evicts) in float32
    through Engine.generate and the Scheduler (prefill_chunk 64: it admits
    whole) on the card against the port on the CPU: tokens and events equal,
    the flash kernel launched once a layer, the decode kernel never (pyramid
    decode attends in plain torch), the decode prologue once a layer a
    decode step, as on every path."""
    import dataclasses
    from pathlib import Path

    import numpy as np

    from fastkv_tpu_torch.core.config import EngineConfig, MethodConfig, ModelConfig
    from fastkv_tpu_torch.engine.generate import Engine
    from fastkv_tpu_torch.engine.scheduler import Scheduler
    from fastkv_tpu_torch.ops import decode_prologue as tdp

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig.tiny(head_dim=64, sliding_window=window)
    p_cpu, p_gpu = _tiny_params_cpu_and_card(cfg, cuda_device)
    path = (Path(__file__).resolve().parents[1] / "fastkv_tpu_torch" / "configs" / "pyramidinfer"
            / "llama_35.json")
    mcfg = dataclasses.replace(MethodConfig().with_pyramidinfer_json(str(path)),
                               pyramid_exceed_length_to_compress=4)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (300, 181, 457)]
    ecfg = EngineConfig(prefill_buckets=(512,), capacity_align=8)
    want = Engine(p_cpu, cfg, mcfg, ecfg, device="cpu").generate(prompts, 16)
    before = (tfp.launches, tda.launches, tdp.launches)
    got = Engine(p_gpu, cfg, mcfg, ecfg).generate(prompts, 16)
    assert got == want
    assert (tfp.launches - before[0], tda.launches - before[1],
            tdp.launches - before[2]) == (cfg.num_layers, 0, cfg.num_layers * 15)

    ecfg = EngineConfig(prefill_buckets=(256,), capacity_align=8, prefill_chunk=64)
    reqs = [(rng.integers(0, cfg.vocab_size, n).tolist(), b)
            for n, b in ((230, 24), (201, 6), (140, 12))]

    def serve(params, device):
        sched = Scheduler(params, cfg, mcfg, ecfg, max_batch=2, bucket=256, max_new_tokens=24,
                          device=device)
        for prompt, budget in reqs:
            sched.submit(prompt, budget)
        toks = {r.req_id: r.tokens for r in sched.run()}
        return toks, [e if e[0] != "decode" else ("decode",) for e in sched.events]

    want = serve(p_cpu, "cpu")
    before = (tda.launches, tdp.launches)
    got = serve(p_gpu, "cuda")
    assert got == want
    assert not [e for e in got[1] if e[0] in ("chunk", "finish")]
    steps = sum(e[0] == "decode" for e in got[1])
    assert (tda.launches - before[0], tdp.launches - before[1]) == (0, cfg.num_layers * steps)


@pytest.mark.cuda
def test_checkpoint_written_and_loaded_on_the_card_generates_the_same_tokens(cuda_device,
                                                                             tmp_path):
    """bf16 params at d = 128 made on the card, written as a sharded HF
    checkpoint by the port's own writer and loaded back by ``load_params``:
    every leaf equal, and FastKV and FullKV tokens equal to the in-memory
    params', with both kernels launched on the loaded path."""
    import numpy as np

    from fastkv_tpu_torch.core import weights
    from fastkv_tpu_torch.core.config import EngineConfig, Method, MethodConfig, ModelConfig
    from fastkv_tpu_torch.engine.generate import Engine
    from fastkv_tpu_torch.models.llama import init_params
    from fastkv_tpu_torch.utils.testing import write_model_dir

    cfg = ModelConfig.tiny(head_dim=128, dtype="bfloat16")
    params = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    write_model_dir(cfg, params, str(tmp_path), shard_bytes=200_000)
    loaded = weights.load_params(str(tmp_path), weights.model_config_from_dir(str(tmp_path)))
    flat = lambda p: {**{k: v for k, v in p.items() if k != "layers"}, **p["layers"]}
    for k, v in flat(params).items():
        got = flat(loaded)[k]
        assert got.device.type == "cuda" and got.dtype == v.dtype and torch.equal(got, v), k
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, 300).tolist()
    ecfg = EngineConfig(prefill_buckets=(512,), capacity_align=8)
    for method in (Method.FASTKV, Method.FULLKV):
        mcfg = MethodConfig(method=method, retain_rate=0.3, tsp_rate=0.5, tsp_idx=1)
        want = Engine(params, cfg, mcfg, ecfg).generate([prompt], 12)
        before = (tfp.launches, tda.launches)
        assert Engine(loaded, cfg, mcfg, ecfg).generate([prompt], 12) == want
        assert (tfp.launches - before[0], tda.launches - before[1]) == (
            cfg.num_layers, cfg.num_layers * 11)


AUX_FORMS = [("full", None), ("full", 150), ("causal", None), ("causal", 40)]


@pytest.mark.cuda
@pytest.mark.parametrize("pattern,window", AUX_FORMS)
@pytest.mark.parametrize("dtype,d", CASES)
def test_flash_prefill_kernel_aux_matches_plain(cuda_device, dtype, d, pattern, window):
    """The row statistics: 'full' is ring attention's earlier chunk (300
    queries at positions 300-599 against the 300 keys before them, example 1's
    chunk holding no valid key, so its rows see none), 'causal' its local step
    (the square form over one chunk with the chunk's own key count). o, m and
    l each held to the plain version (``agreement``)."""
    gen = torch.Generator(device=cuda_device).manual_seed(d + 23)
    b, s = 2, 300
    q, k, v = _qkv_views(gen, b, 8, 2, s, d, dtype, cuda_device)
    start = 300 if pattern == "full" else 0
    qpos = (start + torch.arange(s, dtype=torch.int32, device=cuda_device))[None].repeat(b, 1)
    kpos = torch.arange(s, dtype=torch.int32, device=cuda_device)[None].repeat(b, 1)
    count = torch.tensor([550, 230], dtype=torch.int32, device=cuda_device)
    k_count = (torch.tensor([300, 0], dtype=torch.int32, device=cuda_device)
               if pattern == "full" else count.clamp(max=s))
    kp = kpos if pattern == "full" else None
    before = (tfp.launches, tfp.aux_launches, tfp.full_launches, tfp.rect_launches)
    out, m, l = tfp.flash_attention(q, k, v, qpos, count, window, k_positions=kp,
                                    k_count=k_count, pattern=pattern, return_aux=True)
    full = pattern == "full"
    assert (tfp.launches, tfp.aux_launches, tfp.full_launches, tfp.rect_launches) == (
        before[0] + 1, before[1] + 1, before[2] + full, before[3] + full)
    ref = tfp.flash_attention_plain(q.float(), k.float(), v.float(), qpos, count, window,
                                    kp, k_count, return_aux=True)
    r = agreement.compare(out, ref[0], agreement.TOLERANCES[dtype])
    assert r["ok"], r
    r = agreement.compare_stats(m, l, ref[1], ref[2])
    assert r["ok"], r
    if pattern == "full":
        assert r["rows_seeing_no_key"] >= 8 * s


@pytest.mark.cuda
@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("dtype,d", CASES)
def test_ring_steps_on_the_card_match_one_causal_call(cuda_device, dtype, d, p):
    """Ring attention's steps over p chunks held in one process (the local
    step, then each earlier chunk in the 'full' pattern, merged by the row
    statistics) against the square kernel over the whole sequence."""
    from fastkv_tpu_torch.parallel import ring_attention as tra

    gen = torch.Generator(device=cuda_device).manual_seed(d + p)
    s = 512
    q, k, v = (x.contiguous() for x in _qkv_views(gen, 1, 8, 2, s, d, dtype, cuda_device))
    pos = torch.arange(s, dtype=torch.int32, device=cuda_device)[None]
    cnt = torch.tensor([s - 37], dtype=torch.int32, device=cuda_device)
    n = s // p
    outs = []
    for i in range(p):
        acc = None
        for t in range(p):
            o = (i - t) % p
            acc = tra.ring_step(q[:, :, i * n:(i + 1) * n], k[:, :, o * n:(o + 1) * n],
                                v[:, :, o * n:(o + 1) * n], pos[:, o * n:(o + 1) * n],
                                pos[:, i * n:(i + 1) * n], cnt, o, i, acc)
        outs.append(acc[0].to(dtype))
    whole = tfp.flash_attention(q, k, v, pos, cnt)
    ref = tfp.flash_attention_plain(q.float(), k.float(), v.float(), pos, cnt)
    for got in (torch.cat(outs, dim=2), whole):
        r = agreement.compare(got, ref, agreement.TOLERANCES[dtype])
        assert r["ok"], r


@pytest.mark.cuda
def test_front_door_on_the_card_matches_the_cpu_and_counts_every_launch(cuda_device):
    """A FrontDoor over two replica threads on the card (tiny, float32,
    FastKV with chunked admission) gives the CPU front door's tokens, and the
    launch counters count exactly what the two replicas' paths launch: the
    same requests through one Scheduler per replica, one after the other on
    this thread. Every decode arrival counter is zero afterwards."""
    import numpy as np

    from fastkv_tpu_torch.core.config import EngineConfig, Method, MethodConfig, ModelConfig
    from fastkv_tpu_torch.engine.scheduler import Scheduler
    from fastkv_tpu_torch.engine.serve import local_front_door

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig.tiny(head_dim=64)
    p_cpu, p_gpu = _tiny_params_cpu_and_card(cfg, cuda_device)
    mcfg = MethodConfig(method=Method.FASTKV, eviction_mode="proportional", retain_rate=0.3,
                        tsp_rate=0.5, tsp_idx=1, pooling="maxpool")
    ecfg = EngineConfig(prefill_buckets=(256,), capacity_align=8, prefill_chunk=64)
    kw = dict(max_batch=2, bucket=256, max_new_tokens=24)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab_size, n).tolist(), b)
            for n, b in ((230, 24), (201, 6), (140, 12), (180, 10), (90, 16), (250, 8))]

    def counts():
        return (tfp.launches, tfp.rect_launches, tda.launches)

    def served(params, device):
        fd = local_front_door(params, cfg, mcfg, ecfg, n_replicas=2, device=device, **kw)
        for prompt, budget in reqs:
            fd.submit(prompt, budget)
        out = fd.run()
        assert all(r.alive for r in fd.replicas)
        return [(r["replica"], r["tokens"]) for r in out]

    want = served(p_cpu, "cpu")
    before = counts()
    for r in range(2):  # least-loaded assignment alternates the replicas
        sched = Scheduler(p_gpu, cfg, mcfg, ecfg, device=cuda_device, **kw)
        for prompt, budget in reqs[r::2]:
            sched.submit(prompt, budget)
        sched.run()
    one_thread = [b - a for a, b in zip(before, counts())]
    before = counts()
    got = served(p_gpu, "cuda")
    threaded = [b - a for a, b in zip(before, counts())]
    torch.cuda.synchronize()
    assert got == want
    assert threaded == one_thread and threaded[1] > 0 and threaded[2] > 0
    assert all(int(c.abs().sum()) == 0 for c in tda._counters.values())


@pytest.mark.cuda
def test_mlp_chunk_on_the_card_at_llama_width(cuda_device):
    """One Llama-3.1-8B layer's MLP (D 4096, F 14336) in bf16 over 8192
    tokens, chunked by 2048 and whole, each row held to the float32 plain
    result (cuBLAS may pick another algorithm for the shorter M)."""
    from fastkv_tpu_torch.models.llama import mlp

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    D, F = 4096, 14336
    lp = {name: (torch.randn(shape, generator=gen, device=cuda_device) * 0.02).to(torch.bfloat16)
          for name, shape in (("w_gate", (D, F)), ("w_up", (D, F)), ("w_down", (F, D)))}
    x = torch.randn((1, 8192, D), generator=gen, device=cuda_device).to(torch.bfloat16)
    with torch.inference_mode():
        ref = mlp({k: v.float() for k, v in lp.items()}, x.float())
        for chunk in (2048, 0):
            out = mlp(lp, x, chunk=chunk)
            assert out.shape == x.shape and out.dtype == torch.bfloat16
            r = agreement.compare(out, ref, agreement.TOLERANCES[torch.bfloat16])
            assert r["ok"], (chunk, r)


def _graph_run(device, method="fastkv", kv_int8=False, buckets=(512,), prompts=(300, 457),
               graphed=True, monkeypatch=None, eng=None, max_batch=2):
    """Engine.generate and a Scheduler on the tiny config at d = 128 in
    bf16 on the card (a cache long enough that the decode kernel splits and
    uses its arrival counters), with the decode step replayed as a CUDA
    graph or (``graphed`` False) run eagerly -> (each call's tokens, each
    call's returned cache, the Scheduler's tokens and event kinds, decode
    launches, the Engine)."""
    import numpy as np

    from fastkv_tpu_torch.core.config import EngineConfig, Method, MethodConfig, ModelConfig
    from fastkv_tpu_torch.engine import decode as decode_mod
    from fastkv_tpu_torch.engine.generate import Engine
    from fastkv_tpu_torch.engine.scheduler import Scheduler
    from fastkv_tpu_torch.models.llama import init_params

    cfg = ModelConfig.tiny(head_dim=128, dtype="bfloat16")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0))
    mcfg = MethodConfig(method=Method(method), eviction_mode="proportional", retain_rate=0.3,
                        tsp_rate=0.5, tsp_idx=1)
    ecfg = EngineConfig(prefill_buckets=buckets, capacity_align=8, kv_int8=kv_int8)
    rng = np.random.default_rng(0)
    ps = [rng.integers(0, cfg.vocab_size, n).tolist() for n in prompts]
    with monkeypatch.context() as mp:
        if not graphed:
            mp.setattr(decode_mod, "graphable", lambda *a, **kw: False)
        caches = []
        orig = decode_mod.greedy_generate

        def spy(*a, **kw):
            out, cache = orig(*a, **kw)
            caches.append(cache)
            return out, cache

        mp.setattr(decode_mod, "greedy_generate", spy)
        before = tda.launches
        eng = eng or Engine(params, cfg, mcfg, ecfg)
        toks = [eng.generate([p], 12) for p in ps]
        sched = Scheduler(params, cfg, mcfg, ecfg, max_batch=max_batch, bucket=buckets[-1],
                          max_new_tokens=12, device=device)
        for p, n in zip(ps + ps[:1], (12, 5, 9)):
            sched.submit(p, n)
        served = {r.req_id: r.tokens for r in sched.run()}
        torch.cuda.synchronize()
        kinds = [e[0] for e in sched.events]
        return toks, caches, served, kinds, tda.launches - before, eng, sched


@pytest.mark.cuda
@pytest.mark.parametrize("method,kv_int8", [("fastkv", False), ("fullkv", False),
                                            ("snapkv", False), ("fastkv", True)])
def test_decode_graph_replays_the_eager_step(cuda_device, monkeypatch, method, kv_int8):
    """Engine.generate and the Scheduler with each decode step replayed as
    one CUDA graph against the same calls run eagerly: tokens and every
    field of each returned cache equal, the Scheduler's events equal, the
    decode kernel counted the same (once a layer a step), one graph for the
    Engine and one for the Scheduler, each replay launching the prologue
    kernel once a layer (none over an int8 cache) and the norm kernel twice
    a layer, the arrival counters at rest."""
    eager = _graph_run(cuda_device, method, kv_int8, graphed=False, monkeypatch=monkeypatch)
    graph = _graph_run(cuda_device, method, kv_int8, monkeypatch=monkeypatch)
    assert graph[0] == eager[0] and graph[2:5] == eager[2:5]
    for got, want in zip(graph[1], eager[1]):
        for (name, a), (_, b) in zip(got.fields(), want.fields()):
            assert torch.equal(a, b), name
    assert graph[1][0].k.data_ptr() != graph[1][1].k.data_ptr()
    [st] = graph[5]._decode_states.values()
    assert st.graph.graph is not None and graph[6]._graph.graph is not None
    assert st.graph.prologue == graph[6]._graph.prologue == (0 if kv_int8 else 4)
    assert st.graph.norm == graph[6]._graph.norm == 2 * 4
    assert eager[5]._decode_states == {} and eager[6]._graph is None
    assert tda.counters_at_rest()


@pytest.mark.cuda
def test_decode_graph_replay_eager_replay_on_one_stream(cuda_device, monkeypatch):
    """A replay, an eager decode and a replay, all on the graph's stream
    (they share its arrival counters): the same tokens each time, the
    counters at rest after."""
    first = _graph_run(cuda_device, monkeypatch=monkeypatch)
    eng = first[5]
    [st] = eng._decode_states.values()
    with torch.cuda.stream(st.graph.stream):
        eager = _graph_run(cuda_device, graphed=False, monkeypatch=monkeypatch, eng=eng)
        again = _graph_run(cuda_device, monkeypatch=monkeypatch, eng=eng)
    assert first[0] == eager[0] == again[0]
    assert list(eng._decode_states.values()) == [st]
    assert tda.counters_at_rest()


@pytest.mark.cuda
def test_decode_graph_a_second_shape_captures_its_own(cuda_device, monkeypatch):
    """Prompts of two buckets (two cache shapes) through one Engine: a
    state and a graph each, tokens as the eager calls give."""
    kw = dict(buckets=(256, 512), prompts=(200, 300, 457, 150))
    eager = _graph_run(cuda_device, graphed=False, monkeypatch=monkeypatch, **kw)
    graph = _graph_run(cuda_device, monkeypatch=monkeypatch, **kw)
    assert graph[0] == eager[0] and graph[2] == eager[2]
    states = list(graph[5]._decode_states.values())
    assert len(states) == 2 and all(st.graph.graph is not None for st in states)
    assert states[0].graph.stream is not states[1].graph.stream
    assert tda.counters_at_rest()


@pytest.mark.cuda
@pytest.mark.parametrize("why", ["guards", "pyramidinfer"])
def test_decode_runs_eagerly_under_guards_and_for_pyramidinfer(cuda_device, why):
    """With the guards on (``debug_checks``), and for PyramidInfer's own
    step, no decode state is kept and no graph captured, by the Engine and
    by the Scheduler."""
    import dataclasses
    from pathlib import Path

    import numpy as np

    from fastkv_tpu_torch.core.config import EngineConfig, Method, MethodConfig, ModelConfig
    from fastkv_tpu_torch.engine.generate import Engine
    from fastkv_tpu_torch.engine.scheduler import Scheduler
    from fastkv_tpu_torch.models.llama import init_params
    from fastkv_tpu_torch.utils import guards

    cfg = ModelConfig.tiny(head_dim=128, dtype="bfloat16")
    params = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    mcfg = MethodConfig(method=Method.FASTKV, eviction_mode="proportional", retain_rate=0.3,
                        tsp_rate=0.5, tsp_idx=1)
    if why == "pyramidinfer":
        path = (Path(__file__).resolve().parents[1] / "fastkv_tpu_torch" / "configs"
                / "pyramidinfer" / "llama_35.json")
        mcfg = dataclasses.replace(MethodConfig().with_pyramidinfer_json(str(path)),
                                   pyramid_exceed_length_to_compress=4)
    ecfg = EngineConfig(prefill_buckets=(512,), capacity_align=8,
                        debug_checks=why == "guards")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, 300).tolist()
    eng = Engine(params, cfg, mcfg, ecfg)
    eng.generate([prompt], 8)
    sched = Scheduler(params, cfg, mcfg, ecfg, max_batch=2, bucket=512, max_new_tokens=8,
                      device=cuda_device)
    sched.submit(prompt, 8)
    with guards.checking(why == "guards"):
        sched.run()
    assert eng._decode_states == {} and sched._graph is None


@pytest.mark.cuda
def test_decode_graph_steps_under_the_profiler(cuda_device, monkeypatch):
    """An Engine whose decode shape was captured before the profiler
    started: every ``decode.step`` span of the traced call counts
    ``graph`` 1, no ``decode.layers`` or ``decode.head`` span is recorded,
    and the profiler lists the graph's decode kernels (one a layer a step)."""
    import time

    from fastkv_tpu_torch.utils import profiling

    first = _graph_run(cuda_device, monkeypatch=monkeypatch, prompts=(300,))
    eng = first[5]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        lo = time.time_ns()
        again = _graph_run(cuda_device, monkeypatch=monkeypatch, prompts=(300,), eng=eng)
        hi = time.time_ns()
    assert again[0] == first[0]
    [gen] = [s for s in profiling.records(lo, hi) if s.name == "engine.generate"]
    spans = profiling.records(gen.start_ns, gen.end_ns)
    names = [s.name for s in spans]
    steps = [s for s in spans if s.name == "decode.step"]
    assert len(steps) == 11 and all(s.counts["graph"] == 1 for s in steps)
    assert "decode.layers" not in names and "decode.head" not in names
    assert "decode.capture" not in names
    kernels = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() == torch.autograd.DeviceType.CUDA
               and "decode_attn" in e.name() and steps[0].start_ns <= e.start_ns() <= gen.end_ns]
    assert len(kernels) == 11 * 4


@pytest.mark.cuda
def test_decode_graph_without_states_captures_per_call(cuda_device, monkeypatch):
    """``greedy_generate`` called directly, without ``states`` (as the
    headline and throughput CLIs call it): a graph captured over the call's
    own cache, the same tokens and cache as the eager call, the counters at
    rest."""
    import numpy as np

    from fastkv_tpu_torch.core.config import EngineConfig, Method, MethodConfig, ModelConfig
    from fastkv_tpu_torch.engine import decode as decode_mod
    from fastkv_tpu_torch.engine import prefill as prefill_mod
    from fastkv_tpu_torch.models.llama import init_params

    cfg = ModelConfig.tiny(head_dim=128, dtype="bfloat16")
    params = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    mcfg = MethodConfig(method=Method.FASTKV, eviction_mode="proportional", retain_rate=0.3,
                        tsp_rate=0.5, tsp_idx=1)
    ecfg = EngineConfig(prefill_buckets=(512,), max_new_tokens=12, capacity_align=8)
    shapes = prefill_mod.plan_shapes(cfg, mcfg, ecfg, 512)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 512)).astype(np.int32))
    tokens = tokens.to(cuda_device)
    n_true = torch.tensor([400, 512], dtype=torch.int32, device=cuda_device)
    made = []
    real_graph = decode_mod.StepGraph

    def step_graph(device):
        made.append(real_graph(device))
        return made[-1]

    outs = []
    with torch.inference_mode():
        for graphed in (False, True):
            with monkeypatch.context() as mp:
                if graphed:
                    mp.setattr(decode_mod, "StepGraph", step_graph)
                else:
                    mp.setattr(decode_mod, "graphable", lambda *a, **kw: False)
                logits, cache = prefill_mod.prefill(params, cfg, mcfg, shapes, tokens, n_true,
                                                    ecfg)
                res, out = decode_mod.greedy_generate(params, cfg, mcfg, shapes, logits, cache,
                                                      n_true, 12)
                assert out is cache
                outs.append((res, out))
    torch.cuda.synchronize()
    (want, want_cache), (got, got_cache) = outs
    assert len(made) == 1 and made[0].graph is not None
    assert torch.equal(got.tokens, want.tokens) and torch.equal(got.num_generated,
                                                                 want.num_generated)
    for (name, a), (_, b) in zip(got_cache.fields(), want_cache.fields()):
        assert torch.equal(a, b), name
    assert tda.counters_at_rest()


@pytest.mark.cuda
@pytest.mark.parametrize("counts", [(8192,), (8192, 5000)])
def test_flash_prefill_kernel_mla_form_matches_plain(cuda_device, counts):
    """The q/k 192, v 128 causal square (DeepSeek-V2's latent attention) at
    s = 8192, H = 16 and the model's softmax scale, with k and v views into
    the [b, s, H, 256] ``kv_b`` output as the engine hands them over, and a
    ragged batch whose rows past its count see only its valid keys."""
    from fastkv_tpu_torch.core.config import DeepSeekV2Config

    gen = torch.Generator(device=cuda_device).manual_seed(192)
    b, H, s = len(counts), 16, 8192
    bf16 = torch.bfloat16
    q = torch.randn((b, H, s, 192), generator=gen, device=cuda_device).to(bf16)
    kv = torch.randn((b, s, H, 256), generator=gen, device=cuda_device).to(bf16).transpose(1, 2)
    k_pe = torch.randn((b, 1, s, 64), generator=gen, device=cuda_device).to(bf16)
    k = torch.cat([kv[..., :128], k_pe.expand(b, H, s, 64)], dim=-1)
    v = kv[..., 128:]
    pos = torch.arange(s, dtype=torch.int32, device=cuda_device)[None].repeat(b, 1)
    cnt = torch.tensor(counts, dtype=torch.int32, device=cuda_device)
    scale = DeepSeekV2Config.lite().softmax_scale
    before = tfp.launches
    out = tfp.flash_attention(q, k, v, pos, cnt, scale=scale)
    assert tfp.launches == before + 1 and out.shape == (b, H, s, 128)
    _agrees(out, lambda *a: tfp.flash_attention_plain(*a, scale=scale), q, k, v, pos, cnt)
    with pytest.raises(NotImplementedError, match="192, 128"):
        tfp.flash_attention(q, k, v, pos, cnt, sliding_window=1024, scale=scale)


@pytest.mark.cuda
def test_mla_moe_decode_step_graph_matches_eager(cuda_device):
    """A DeepSeek-V2 decode step (absorbed latent attention, experts picked
    on the device) captured as a CUDA graph and replayed gives the tokens
    and the cache the same step run eagerly gives, at the flash kernel's
    MLA widths (q/k 192, v 128) over 3 layers of 8 experts, top 2."""
    from fastkv_tpu_torch.core.config import (DeepSeekV2Config, EngineConfig, Method,
                                              MethodConfig, MLAConfig, MoEConfig)
    from fastkv_tpu_torch.engine import decode as dm
    from fastkv_tpu_torch.engine import prefill as pm
    from fastkv_tpu_torch.models import deepseek_v2 as ds

    cfg = DeepSeekV2Config.tiny(
        hidden_size=256, intermediate_size=512, num_layers=3, num_heads=2, head_dim=192,
        vocab_size=512, dtype="bfloat16",
        mla=MLAConfig(kv_lora_rank=64, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
        moe=MoEConfig(n_routed_experts=8, num_experts_per_tok=2, moe_intermediate_size=64,
                      n_shared_experts=1, first_k_dense_replace=1))
    params = ds.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                            device=cuda_device, std=0.05)
    mcfg = MethodConfig(method=Method.FASTKV, tsp_idx=1)
    n, bucket, new = 700, 1024, 24
    ecfg = EngineConfig(prefill_buckets=(bucket,), capacity_align=64, max_new_tokens=new)
    shapes = pm.plan_shapes(cfg, mcfg, ecfg, bucket)
    toks = torch.zeros((1, bucket), dtype=torch.int32, device=cuda_device)
    toks[0, :n] = torch.randint(0, 512, (n,), generator=gen_cpu(), dtype=torch.int32)
    n_true = torch.tensor([n], dtype=torch.int32, device=cuda_device)

    def run(eager: bool):
        logits, cache = pm.prefill(params, cfg, mcfg, shapes, toks, n_true, ecfg)
        step = None
        if eager:
            def step(c, tok, t, inv_freq):
                return dm.decode_step(params, cfg, mcfg, c, tok, n_true + t,
                                      shapes.prefill_capacity + t, inv_freq)
        states = {}
        res, cache = dm.greedy_generate(params, cfg, mcfg, shapes, logits, cache, n_true, new,
                                        step_fn=step, states=states)
        if not eager:
            assert [st.graph.graph is not None for st in states.values()] == [True]
            assert [st.graph.prologue for st in states.values()] == [3]
            assert [st.graph.norm for st in states.values()] == [6]
        return res.tokens.cpu(), cache

    t_eager, c_eager = run(True)
    t_graph, c_graph = run(False)
    assert torch.equal(t_eager, t_graph)
    assert torch.equal(c_eager.pos, c_graph.pos) and torch.equal(c_eager.valid, c_graph.valid)
    for a, g in ((c_eager.k, c_graph.k), (c_eager.v, c_graph.v)):
        assert (a.float() - g.float()).abs().max().item() <= 1e-2 * a.float().abs().max().item()


@pytest.mark.cuda
def test_flash_prefill_kernel_mla_form_at_128_heads(cuda_device):
    """The q/k 192, v 128 causal square at DeepSeek-V3's 128 heads and
    softmax scale (YaRN x40, mscale_all_dim 1), s = 4096 with 3000 valid."""
    from fastkv_tpu_torch.core.config import YarnScaling, yarn_mscale

    gen = torch.Generator(device=cuda_device).manual_seed(128)
    b, H, s = 1, 128, 4096
    bf16 = torch.bfloat16
    q = torch.randn((b, H, s, 192), generator=gen, device=cuda_device).to(bf16)
    kv = torch.randn((b, s, H, 256), generator=gen, device=cuda_device).to(bf16).transpose(1, 2)
    k_pe = torch.randn((b, 1, s, 64), generator=gen, device=cuda_device).to(bf16)
    k = torch.cat([kv[..., :128], k_pe.expand(b, H, s, 64)], dim=-1)
    v = kv[..., 128:]
    pos = torch.arange(s, dtype=torch.int32, device=cuda_device)[None]
    cnt = torch.tensor([3000], dtype=torch.int32, device=cuda_device)
    m = yarn_mscale(YarnScaling().factor, 1.0)
    scale = 192 ** -0.5 * m * m
    before = tfp.launches
    out = tfp.flash_attention(q, k, v, pos, cnt, scale=scale)
    assert tfp.launches == before + 1 and out.shape == (b, H, s, 128)
    _agrees(out, lambda *a: tfp.flash_attention_plain(*a, scale=scale), q, k, v, pos, cnt)


@pytest.mark.cuda
def test_v3_share_decode_step_graph_matches_eager(cuda_device):
    """A DeepSeek-V3 decode step at a share of its experts (query LoRA and
    its norm kernel, ``noaux_tc`` routing and the held experts picked on
    the device) captured as a CUDA graph and replayed gives the tokens the
    same step run eagerly gives; the capture holds the prologue once a
    layer and the norm kernel three times a layer."""
    import dataclasses

    from fastkv_tpu_torch.core.config import EngineConfig, Method, MethodConfig, ModelConfig
    from fastkv_tpu_torch.engine import decode as dm
    from fastkv_tpu_torch.engine import prefill as pm
    from fastkv_tpu_torch.models import deepseek_v2 as ds
    from fastkv_tpu_torch.utils.testing import deepseek_v3_hf_config

    hf = deepseek_v3_hf_config(hidden_size=256, intermediate_size=512, num_attention_heads=2,
                               qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
                               kv_lora_rank=64, q_lora_rank=96, moe_intermediate_size=64,
                               vocab_size=512)
    cfg = dataclasses.replace(ModelConfig.from_hf_config(hf), dtype="bfloat16")
    params = ds.init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0),
                            device=cuda_device, std=0.05)
    mcfg = MethodConfig(method=Method.FASTKV, tsp_idx=1)
    n, bucket, new = 700, 1024, 24
    ecfg = EngineConfig(prefill_buckets=(bucket,), capacity_align=64, max_new_tokens=new)
    shapes = pm.plan_shapes(cfg, mcfg, ecfg, bucket)
    toks = torch.zeros((1, bucket), dtype=torch.int32, device=cuda_device)
    toks[0, :n] = torch.randint(0, 512, (n,), generator=gen_cpu(), dtype=torch.int32)
    n_true = torch.tensor([n], dtype=torch.int32, device=cuda_device)

    def run(eager: bool):
        logits, cache = pm.prefill(params, cfg, mcfg, shapes, toks, n_true, ecfg)
        step = None
        if eager:
            def step(c, tok, t, inv_freq):
                return dm.decode_step(params, cfg, mcfg, c, tok, n_true + t,
                                      shapes.prefill_capacity + t, inv_freq)
        states = {}
        res, cache = dm.greedy_generate(params, cfg, mcfg, shapes, logits, cache, n_true, new,
                                        step_fn=step, states=states)
        if not eager:
            assert [st.graph.prologue for st in states.values()] == [cfg.num_layers]
            assert [st.graph.norm for st in states.values()] == [3 * cfg.num_layers]
        return res.tokens.cpu(), cache

    t_eager, c_eager = run(True)
    t_graph, c_graph = run(False)
    assert torch.equal(t_eager, t_graph)
    assert torch.equal(c_eager.pos, c_graph.pos) and torch.equal(c_eager.valid, c_graph.valid)


def gen_cpu():
    return torch.Generator().manual_seed(5)


def _bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| in units of want's last place in bf16."""
    w = want.float()
    step = torch.ldexp(torch.ones_like(w),
                       torch.floor(torch.log2(w.abs().clamp_min(1e-30))).int() - 7)
    return float(((got.float() - w).abs() / step).max())


def _prologue_inputs(device, form, b, dtype, g=1, mscale_all_dim=None, C=1100):
    """A decode layer's prologue operands at Mistral-Nemo-12B's widths (H 32,
    KH 8, d 128; ``g`` cache heads a kv head) or DeepSeek-V2-Lite's (H 16,
    q 128 + 64, latent 512; YaRN's mscale ratio 1, or not with
    ``mscale_all_dim`` 1.0): projections' outputs as [b, 1, heads x width]
    views, positions past 32768, two cache planes -> (config, the form's
    arguments but the planes, the planes, a slot a row)."""
    import dataclasses

    from fastkv_tpu_torch.core.config import DeepSeekV2Config, ModelConfig
    from fastkv_tpu_torch.models.rope import compute_inv_freq

    gen = torch.Generator(device=device).manual_seed(b * 7 + g)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    pos = torch.randint(16385, 32768 + 128, (b,), generator=gen, device=device,
                        dtype=torch.int32)
    slot = torch.randperm(C, generator=gen, device=device)[:b]
    if form == "latent":
        cfg = DeepSeekV2Config.lite()
        if mscale_all_dim is not None:
            cfg = dataclasses.replace(cfg, rope_scaling=dataclasses.replace(
                cfg.rope_scaling, mscale_all_dim=mscale_all_dim))
        mla, H = cfg.mla, cfg.num_heads
        n, r, R = mla.qk_nope_head_dim, mla.qk_rope_head_dim, mla.kv_lora_rank
        inv_freq = torch.from_numpy(compute_inv_freq(cfg)).to(device)
        q = randn(b, 1, H * (n + r)).view(b, 1, H, n + r).transpose(1, 2)
        kv_norm = torch.rand((R,), generator=gen, device=device) + 0.5
        args = (q, randn(b, 1, R + r), kv_norm, pos, inv_freq)
        planes = (randn(b, 1, C, R), randn(b, 1, C, r))
    else:
        cfg = ModelConfig.mistral_nemo_12b()
        H, KH, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        inv_freq = torch.from_numpy(compute_inv_freq(cfg)).to(device)
        args = tuple(randn(b, 1, h * d).view(b, 1, h, d).transpose(1, 2) for h in (H, KH, KH))
        args += (pos, inv_freq)
        planes = (randn(b, KH * g, C, d), randn(b, KH * g, C, d))
    return cfg, args, planes, slot


def _latent_norm(cfg) -> dict:
    """The latent form's eps and YaRN ratio, as ``deepseek_v2.decode_qkv`` passes them."""
    from fastkv_tpu_torch.models import deepseek_v2

    return dict(eps=cfg.rms_norm_eps, mscale=deepseek_v2.rope_mscale(cfg))


def _prologue(form, cfg, args, planes, slot, plain=False):
    from fastkv_tpu_torch.ops import decode_prologue as tdp

    if form == "latent":
        fn = tdp.latent_prologue_plain if plain else tdp.latent_prologue
        return fn(args[0].clone(), *args[1:], *planes, slot, **_latent_norm(cfg))
    fn = tdp.rope_append_plain if plain else tdp.rope_append
    return fn(args[0].clone(), *args[1:], *planes, slot)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rope_append_kernel_is_its_plain_version_bit_for_bit(cuda_device, dtype, g, per_row, b):
    """The Llama/Mistral prologue at Mistral-Nemo-12B's widths against its
    plain version run on the card (PyTorch's composition): q and both cache
    planes equal bit for bit, one launch a call."""
    from fastkv_tpu_torch.ops import decode_prologue as tdp

    cfg, args, planes, slot = _prologue_inputs(cuda_device, "rope", b, dtype, g)
    if not per_row:
        slot = 1033
    want_planes = [p.clone() for p in planes]
    want = _prologue("rope", cfg, args, want_planes, slot, plain=True)
    before = tdp.launches
    got = _prologue("rope", cfg, args, planes, slot)
    torch.cuda.synchronize()
    assert tdp.launches == before + 1
    assert torch.equal(got, want)
    for a, w in zip(planes, want_planes):
        assert torch.equal(a, w)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("mscale_all_dim", [None, 1.0])
def test_latent_prologue_kernel_matches_its_plain_version(cuda_device, mscale_all_dim, per_row,
                                                          b):
    """The DeepSeek-V2 prologue at DeepSeek-V2-Lite's widths (YaRN's mscale
    ratio 1 as published, and 0.83 with ``mscale_all_dim`` 1.0) in bf16
    against its plain version on the card: q and the roped key plane bit for
    bit, the latent's norm within one bf16 ulp (its sum of squares taken in
    another order) and nothing else of the latent plane touched; one launch
    a call."""
    from fastkv_tpu_torch.ops import decode_prologue as tdp

    cfg, args, planes, slot = _prologue_inputs(cuda_device, "latent", b, torch.bfloat16,
                                               mscale_all_dim=mscale_all_dim)
    if not per_row:
        slot = 1099
    want_planes = [p.clone() for p in planes]
    want = _prologue("latent", cfg, args, want_planes, slot, plain=True)
    before = tdp.launches
    got = _prologue("latent", cfg, args, planes, slot)
    torch.cuda.synchronize()
    assert tdp.launches == before + 1
    assert torch.equal(got, want) and torch.equal(planes[1], want_planes[1])
    written = torch.zeros((b, planes[0].shape[2]), dtype=torch.bool, device=cuda_device)
    written[torch.arange(b, device=cuda_device), slot] = True
    lat, want_lat = planes[0][:, 0], want_planes[0][:, 0]
    assert torch.equal(lat[~written], want_lat[~written])
    assert _bf16_ulps(lat[written], want_lat[written]) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["rope", "latent"])
def test_decode_prologue_graph_replay_counts_and_matches_eager(cuda_device, form):
    """The prologue captured into a CUDA graph at b = 8 with a slot a row:
    the capture holds its one launch for the stream (``take_captured``) and
    launches nothing; a replay over new positions and slots writes what an
    eager call gives."""
    from fastkv_tpu_torch.ops import decode_prologue as tdp

    cfg, args, planes, slot = _prologue_inputs(cuda_device, form, 8, torch.bfloat16)
    q0, pos = args[0], args[-2]
    static_q = q0.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call = lambda: _prologue(form, cfg, (static_q,) + args[1:], planes, slot)  # noqa: E731
        call()
        graph = torch.cuda.CUDAGraph()
        before = tdp.launches
        with torch.cuda.graph(graph, stream=side):
            out = (tdp.latent_prologue(static_q, *args[1:], *planes, slot, **_latent_norm(cfg))
                   if form == "latent" else tdp.rope_append(static_q, *args[1:], *planes, slot))
        assert tdp.launches == before and tdp.take_captured(side.cuda_stream) == 1
        assert out.data_ptr() == static_q.data_ptr()
    torch.cuda.current_stream().wait_stream(side)
    pos.add_(1000)
    slot.copy_(torch.flip(slot, (0,)))
    static_q.copy_(q0)
    want_planes = [p.clone() for p in planes]
    want = _prologue(form, cfg, (q0,) + args[1:], want_planes, slot)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(static_q, want)
    for a, w in zip(planes, want_planes):
        assert torch.equal(a, w)


NORM_WIDTHS = [2048, 4096, 5120]  # DeepSeek-V2-Lite, Ministral-8B and Llama-8B, Mistral-Nemo-12B


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["rms_norm", "add_rms_norm"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("D", NORM_WIDTHS)
def test_add_rms_norm_kernel_matches_its_plain_version(cuda_device, D, b, dtype, form):
    """A norm site at the models' widths against its plain version run on the
    card (PyTorch's composition), one launch a call: the new residual bit for
    bit; the normed row within one bf16 ulp in bf16, and in float32 within
    1e-5 of each element: the kernel sums the D squares in another order,
    which moves the float32 sum by at most ~100 roundings (2^-24 each) of a
    sum of positive terms, rsqrt halves that, two products round once more."""
    from fastkv_tpu_torch.ops import add_rms_norm as arn

    gen = torch.Generator(device=cuda_device).manual_seed(D + b)
    h = (torch.randn((b, 1, D), generator=gen, device=cuda_device) * 4).to(dtype)
    delta = torch.randn((b, 1, D), generator=gen, device=cuda_device).to(dtype)
    w = torch.rand((D,), generator=gen, device=cuda_device) + 0.5
    eps = 1e-5
    before = arn.launches
    if form == "rms_norm":
        got, want = arn.rms_norm(h, w, eps), arn.rms_norm_plain(h, w, eps)
    else:
        (got_h, got), (want_h, want) = (arn.add_rms_norm(h, delta, w, eps),
                                        arn.add_rms_norm_plain(h, delta, w, eps))
        assert got_h.dtype == dtype and torch.equal(got_h, want_h)
    torch.cuda.synchronize()
    assert arn.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, 1, D)
    if dtype == torch.bfloat16:
        assert _bf16_ulps(got, want) <= 1.0
    else:
        assert ((got - want).abs() <= 1e-5 * want.abs()).all()


@pytest.mark.cuda
def test_add_rms_norm_kernel_raises_on_what_it_does_not_take(cuda_device):
    """The kernel takes [b, 1, D] rows, contiguous, bf16 or float32, a row a
    multiple of 16 bytes up to 32 KB, and a float32 weight: anything else
    raises and launches nothing."""
    from fastkv_tpu_torch.ops import add_rms_norm as arn

    x = torch.randn((2, 1, 256), device=cuda_device, dtype=torch.bfloat16)
    w = torch.ones(256, device=cuda_device)
    before = arn.launches
    with pytest.raises(TypeError):
        arn.rms_norm(x.half(), w, 1e-5)
    with pytest.raises(ValueError, match=r"\[b, 1, D\]"):
        arn.rms_norm(x.view(1, 2, 256), w, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        arn.rms_norm(torch.randn((2, 1, 512), device=cuda_device, dtype=torch.bfloat16)[..., ::2],
                     w, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        arn.rms_norm(x, w.bfloat16(), 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        arn.add_rms_norm(x, x.float(), w, 1e-5)
    with pytest.raises(ValueError, match="16 bytes"):
        arn.rms_norm(x[..., :252].contiguous(), w[:252].contiguous(), 1e-5)
    with pytest.raises(ValueError, match="16 bytes"):
        arn.rms_norm(torch.ones((1, 1, 16384), device=cuda_device), torch.ones(16384,
                     device=cuda_device), 1e-5)
    assert arn.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("family_name,layers", [("llama", 40), ("deepseek_v2", 27)])
def test_decode_graph_counts_two_norm_launches_a_layer(cuda_device, family_name, layers):
    """A decode step captured as a CUDA graph at the decode cells' depths
    (Mistral-Nemo-12B's 40 layers, DeepSeek-V2-Lite's 27) over tiny widths:
    the capture holds the norm kernel's two launches a layer (80, 54), a
    replay counts them, and the graphed tokens are the eager step's."""
    import dataclasses

    from fastkv_tpu_torch.core.config import (DeepSeekV2Config, EngineConfig, Method,
                                              MethodConfig, MLAConfig, ModelConfig, MoEConfig)
    from fastkv_tpu_torch.engine import decode as dm
    from fastkv_tpu_torch.engine import prefill as pm
    from fastkv_tpu_torch.models import deepseek_v2 as ds
    from fastkv_tpu_torch.models import llama
    from fastkv_tpu_torch.ops import add_rms_norm as arn

    gen = torch.Generator(device=cuda_device).manual_seed(0)
    if family_name == "deepseek_v2":
        cfg = DeepSeekV2Config.tiny(
            hidden_size=256, intermediate_size=512, num_layers=layers, num_heads=2,
            head_dim=192, vocab_size=512, dtype="bfloat16",
            mla=MLAConfig(kv_lora_rank=64, qk_nope_head_dim=128, qk_rope_head_dim=64,
                          v_head_dim=128),
            moe=MoEConfig(n_routed_experts=8, num_experts_per_tok=2, moe_intermediate_size=64,
                          n_shared_experts=1, first_k_dense_replace=1))
        params = ds.init_params(cfg, gen, device=cuda_device, std=0.05)
    else:
        cfg = dataclasses.replace(ModelConfig.tiny(head_dim=128, dtype="bfloat16"),
                                  num_layers=layers)
        params = llama.init_params(cfg, gen)
    mcfg = MethodConfig(method=Method.FASTKV, tsp_idx=1)
    n, bucket, new = 300, 512, 8
    ecfg = EngineConfig(prefill_buckets=(bucket,), capacity_align=64, max_new_tokens=new)
    shapes = pm.plan_shapes(cfg, mcfg, ecfg, bucket)
    toks = torch.zeros((1, bucket), dtype=torch.int32, device=cuda_device)
    toks[0, :n] = torch.randint(0, cfg.vocab_size, (n,), generator=gen_cpu(),
                                dtype=torch.int32)
    n_true = torch.tensor([n], dtype=torch.int32, device=cuda_device)

    def run(eager: bool):
        logits, cache = pm.prefill(params, cfg, mcfg, shapes, toks, n_true, ecfg)
        step = None
        if eager:
            def step(c, tok, t, inv_freq):
                return dm.decode_step(params, cfg, mcfg, c, tok, n_true + t,
                                      shapes.prefill_capacity + t, inv_freq)
        states = {}
        before = arn.launches
        res, _ = dm.greedy_generate(params, cfg, mcfg, shapes, logits, cache, n_true, new,
                                    step_fn=step, states=states)
        torch.cuda.synchronize()
        return res.tokens.cpu(), states, arn.launches - before

    t_eager, _, eager_launches = run(True)
    t_graph, states, graph_launches = run(False)
    assert torch.equal(t_eager, t_graph)
    [st] = states.values()
    assert st.graph.norm == 2 * layers
    # new - 1 steps either way: graphed, the first eager (its capture runs
    # nothing), then new - 2 replays
    assert eager_launches == 2 * layers * (new - 1)
    assert graph_launches == 2 * layers * (new - 1)
