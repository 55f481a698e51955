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
