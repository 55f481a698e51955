"""Port parity: attention ops and the two kernels' plain versions.

The port's kernel wrappers (``ops.flash_prefill.flash_attention``,
``ops.decode_attn.decode_attention``) run their plain versions on CPU tensors.
Those are held against the JAX package's Pallas kernels in interpret mode
(as tests/test_flash_kernel.py and tests/test_decode_kernel.py run them) and
against its XLA references. Tolerance 1e-5 in float32: only the order of
summation differs. The CUDA kernels themselves are held against the plain
versions on a card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fastkv_tpu.ops import attention as jatt
from fastkv_tpu.ops.experimental.decode_attn import decode_attention as j_pallas_decode
from fastkv_tpu.ops.flash_prefill import flash_attention as j_pallas_flash
from fastkv_tpu_torch.ops import attention as tatt
from fastkv_tpu_torch.ops import decode_attn as tda
from fastkv_tpu_torch.ops import flash_prefill as tfp
from fastkv_tpu_torch.utils.testing import one_thread_per_module

_one_torch_thread = one_thread_per_module()

ATOL = 1e-5


def _flash_inputs(b, h, kh, s, d, counts, tail_positions, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, kh, s, d)).astype(np.float32)
    v = rng.standard_normal((b, kh, s, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    if tail_positions:  # post-TSP layout: ascending kept positions, zero tail
        for i, n in enumerate(counts):
            pos[i, :n] = np.sort(rng.choice(4 * s, n, replace=False))
            pos[i, n:] = 0
    return q, k, v, pos, np.asarray(counts, np.int32)


FLASH_CASES = {
    "s128_full": (1, 4, 2, 128, 64, [128], False),
    "s200_count_lt_s": (2, 4, 2, 200, 64, [200, 143], False),
    "s200_tail_positions": (1, 4, 2, 200, 64, [180], True),
    "s128_d128_tail": (2, 4, 2, 128, 128, [100, 37], True),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_jax(case):
    b, h, kh, s, d, counts, tail = FLASH_CASES[case]
    q, k, v, pos, cnt = _flash_inputs(b, h, kh, s, d, counts, tail, seed=len(case))
    out = tfp.flash_attention(*map(torch.from_numpy, (q, k, v, pos, cnt))).numpy()
    valid = np.arange(s)[None, :] < cnt[:, None]
    # the XLA reference on every row (rows that see no key give 0 in both)
    ref = np.asarray(jatt.chunked_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
        jnp.asarray(pos), jnp.asarray(valid), q_block=64))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=ATOL,
                               err_msg=_miss("the XLA reference", out, ref))
    # the Pallas kernel on valid rows only (its pure-causal path leaves finite
    # garbage in rows that see no key)
    with pltpu.force_tpu_interpret_mode():
        pal = np.asarray(j_pallas_flash(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
            jnp.asarray(cnt), block_q=128, block_k=128))
    for i in range(b):
        got, want = out[i][:, valid[i]], pal[i][:, valid[i]]
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL,
                                   err_msg=_miss(f"Pallas interpret, example {i}", got, want))


def _miss(against: str, got, want) -> str:
    """What a parity miss says: which reference, by how much, where, and the
    process-wide numeric state another test file could have left changed."""
    err = np.abs(got - want)
    where = np.argwhere(err > ATOL + ATOL * np.abs(want))
    state = dict(
        torch_threads=torch.get_num_threads(),
        torch_interop_threads=torch.get_num_interop_threads(),
        float32_matmul_precision=torch.get_float32_matmul_precision(),
        default_dtype=str(torch.get_default_dtype()),
        mkldnn=torch.backends.mkldnn.enabled,
        deterministic=torch.are_deterministic_algorithms_enabled(),
        jax_matmul_precision=jax.config.jax_default_matmul_precision,
        jax_x64=jax.config.jax_enable_x64,
        jax_devices=len(jax.devices()),
    )
    return (f"against {against}: max abs err {err.max():.3g}, {len(where)} of {err.size} "
            f"elements past the tolerance (first at {where[:3].tolist()}); state {state}")


def test_flash_rows_that_see_nothing_are_zero():
    # post-TSP padded rows carry position 0 while the smallest kept key is > 0
    q, k, v, pos, cnt = _flash_inputs(1, 2, 1, 64, 64, [40], True, seed=5)
    pos[0, :40] += 1
    out = tfp.flash_attention(*map(torch.from_numpy, (q, k, v, pos, cnt)))
    assert torch.all(out[0, :, 40:] == 0)
    assert torch.all(out[0, :, :40].abs().sum(-1) > 0)


def test_fold_key_validity():
    pos = torch.tensor([[0, 5, 9, 0], [3, 4, 0, 0]], dtype=torch.int32)
    got = tfp.fold_key_validity(pos, torch.tensor([3, 2], dtype=torch.int32))
    big = tfp.INVALID_POS
    assert got.tolist() == [[0, 5, 9, big], [3, 4, big, big]]
    assert got.dtype == torch.int32


DECODE_CASES = {
    "gqa_scattered_C384": (2, 8, 2, 384, 64, False),
    "per_head_cache_C256": (1, 4, 4, 256, 64, True),
    "ragged_C200_d128": (1, 8, 4, 200, 128, False),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_plain_matches_jax(case):
    b, h, ch, C, d, per_head = DECODE_CASES[case]
    rng = np.random.default_rng(len(case))
    q = rng.standard_normal((b, h, 1, d)).astype(np.float32)
    k = rng.standard_normal((b, ch, C, d)).astype(np.float32)
    v = rng.standard_normal((b, ch, C, d)).astype(np.float32)
    valid = rng.random((b, ch, C) if per_head else (b, C)) < 0.6
    valid[..., 0] = True
    out = tda.decode_attention(*map(torch.from_numpy, (q, k, v, valid))).numpy()
    jargs = [jnp.asarray(x) for x in (q, k, v, valid)]
    np.testing.assert_allclose(out, np.asarray(jatt.decode_attention(*jargs)),
                               atol=ATOL, rtol=ATOL)
    with pltpu.force_tpu_interpret_mode():
        pal = np.asarray(j_pallas_decode(*jargs, block_c=128))
    np.testing.assert_allclose(out, pal, atol=ATOL, rtol=ATOL)


PLAN_CASES = {  # (b, CH, g, C, SMs); the first five are the main path's forms
    "fastkv_b1_C1032": (1, 8, 4, 1032, 132),
    "snapkv_b4_CH32_C1032": (4, 32, 1, 1032, 132),
    "fullkv_C8320": (1, 8, 4, 8320, 132),
    "ministral_rank_cut_C41088": (1, 8, 4, 41088, 132),
    "window_term_C41088_b2": (2, 8, 4, 41088, 132),
    "ragged_C77_b4": (4, 32, 1, 77, 132),
    "group10_C131200": (1, 2, 10, 131200, 132),
    "group20_two_row_groups": (1, 2, 20, 777, 132),
    "one_slot": (1, 1, 1, 1, 1),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_decode_split_plan_covers_the_cache(case):
    """Every slot in exactly one split, splits whole tiles (but the last),
    none empty, within the kernel's limits; the grid one wave of one CTA an
    SM unless the cache needs more splits; scratch bounded."""
    b, ch, g, C, sms = PLAN_CASES[case]
    plan = tda.split_plan(b, ch, g, C, sms)
    assert 1 <= plan.tiles <= tda.MAX_TILES and 1 <= plan.splits <= tda.MAX_SPLITS
    assert plan.row_groups == -(-g // tda.MAX_ROWS)
    span = plan.tiles * tda.TILE  # the kernel's split s walks [s * span, (s + 1) * span) of C
    covered = np.zeros(C, np.int64)
    for lo, hi in [(s * span, min(C, (s + 1) * span)) for s in range(plan.splits)]:
        assert lo % tda.TILE == 0 and lo < hi <= lo + plan.tiles * tda.TILE
        covered[lo:hi] += 1
    assert (covered == 1).all()
    units = b * ch * plan.row_groups
    ntiles = -(-C // tda.TILE)
    one_wave = sms
    assert plan.splits <= max(one_wave // units, -(-ntiles // tda.MAX_TILES), 1)
    if units <= one_wave and ntiles <= one_wave // units * tda.MAX_TILES:
        assert plan.grid(b, ch) <= one_wave
    assert plan.grid(b, ch) == plan.splits * units
    for d in (64, 128):
        bf16 = plan.scratch_floats(b, ch, g, d, True)
        assert bf16 == (0 if plan.splits == 1 else units * plan.splits * tda.MAX_ROWS * (d + 2))
        assert plan.scratch_floats(b, ch, g, d, False) == b * ch * plan.splits * g * (d + 2)
        assert 4 * max(bf16, plan.scratch_floats(b, ch, g, d, False)) <= 16 << 20


def test_decode_split_plan_refuses_a_cache_beyond_its_splits():
    too_long = tda.MAX_SPLITS * tda.MAX_TILES * tda.TILE + 1
    with pytest.raises(NotImplementedError, match="exceeds"):
        tda.split_plan(1, 1, 1, too_long, 132)


@pytest.mark.parametrize("view", ["contiguous", "layer_of_stack", "shifted_base", "padded_row",
                                  "size_one_dim_any_stride"])
def test_decode_cp_async_strides(view):
    """The bf16 kernel's 16-byte copies: an aligned cache (or one layer of a
    stacked one) passes; a base 2 bytes off or a row stride that is not a
    multiple of 16 bytes raises; a dimension of size 1 is never stepped
    along, so its stride is not checked."""
    shape = (2, 2, 37, 64)
    if view == "contiguous":
        x, err = torch.zeros(shape, dtype=torch.bfloat16), None
    elif view == "layer_of_stack":
        x, err = torch.zeros((3,) + shape, dtype=torch.bfloat16)[1], None
    elif view == "shifted_base":
        x, err = torch.zeros(2 * 2 * 37 * 64 + 1, dtype=torch.bfloat16)[1:].view(shape), "aligned"
    elif view == "padded_row":
        x, err = torch.zeros((2, 2, 37, 68), dtype=torch.bfloat16)[..., :64], "multiple of 16"
    else:  # batch 1 whose batch stride (10 bytes) is never stepped along
        x = torch.zeros(2 * 37 * 64 + 8, dtype=torch.bfloat16).as_strided(
            (1, 2, 37, 64), (5, 37 * 64, 64, 1))
        err = None
    if err is None:
        tda.cp_async_strides(x, "k_cache")
    else:
        with pytest.raises(ValueError, match=err):
            tda.cp_async_strides(x, "k_cache")


@pytest.mark.parametrize("pooling", ["avgpool", "maxpool"])
def test_pool_scores_matches_jax(pooling):
    rng = np.random.default_rng(2)
    scores = rng.random((2, 4, 97)).astype(np.float32)
    scores[:, :, 10:13] = 0.5  # plateaus: max pooling ties
    valid = np.arange(97)[None, :] < np.array([[97], [60]])
    for kernel in (3, 7):
        out = tatt.pool_scores(torch.from_numpy(scores), torch.from_numpy(valid), kernel, pooling)
        ref = jatt.pool_scores(jnp.asarray(scores), jnp.asarray(valid), kernel, pooling)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-7, rtol=1e-6)


def test_masked_attention_matches_jax_and_zeroes_empty_rows():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 4, 6, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 9, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 9, 16)).astype(np.float32)
    mask = rng.random((2, 1, 6, 9)) < 0.5
    mask[0, 0, 2] = False  # one row sees nothing
    out = tatt.masked_attention(*map(torch.from_numpy, (q, k, v, mask))).numpy()
    ref = np.asarray(jatt.masked_attention(*map(jnp.asarray, (q, k, v, mask))))
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=ATOL)
    assert np.all(out[0, :, 2] == 0)


def test_causal_mask_from_positions_matches_jax():
    rng = np.random.default_rng(6)
    qp = rng.integers(0, 50, (2, 7)).astype(np.int32)
    kp = rng.integers(0, 50, (2, 11)).astype(np.int32)
    kv = rng.random((2, 11)) < 0.8
    for window in (None, 9):
        got = tatt.causal_mask_from_positions(
            *map(torch.from_numpy, (qp, kp, kv)), sliding_window=window)
        ref = jatt.causal_mask_from_positions(*map(jnp.asarray, (qp, kp, kv)), sliding_window=window)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


H2O_CASES = {
    # b, H, KH, s, counts, window, row_block
    "gqa_ragged_block_not_dividing": (2, 4, 2, 100, [100, 37], 8, 16),
    "window_corner_block_37": (1, 4, 2, 90, [90], 12, 37),
    "prompt_shorter_than_window": (2, 4, 2, 64, [5, 40], 8, 24),
    "one_block": (2, 4, 4, 48, [48, 30], 8, 2048),
}


@pytest.mark.parametrize("case", sorted(H2O_CASES))
def test_h2o_scores_match_jax(case):
    """The accumulated attention mass against the JAX package's: GQA, a
    ragged batch (bucket-padding columns and query rows), row blocks smaller
    than s and not dividing it, the window corner, a prompt shorter than the
    window."""
    b, h, kh, s, counts, window, row_block = H2O_CASES[case]
    rng = np.random.default_rng(len(case))
    q = rng.standard_normal((b, h, s, 16)).astype(np.float32)
    k = rng.standard_normal((b, kh, s, 16)).astype(np.float32)
    n = np.asarray(counts, np.int32)
    valid = np.arange(s)[None, :] < n[:, None]
    out = tatt.h2o_scores(*map(torch.from_numpy, (q, k, valid, n)), window,
                          row_block=row_block).numpy()
    ref = np.asarray(jatt.h2o_scores(*map(jnp.asarray, (q, k, valid, n)), window,
                                     row_block=row_block))
    np.testing.assert_allclose(out, ref, atol=1e-6, rtol=1e-6)
    # window and padding columns get no score; the others some
    keep = valid & (np.arange(s)[None, :] < n[:, None] - window)
    assert np.all(out[~np.broadcast_to(keep[:, None], out.shape)] == 0)
    assert np.all(out[np.broadcast_to(keep[:, None], out.shape)] > 0)
