"""The bf16 flash kernel's host-side operand rule, on the CPU.

``fastkv_tpu_torch.ops.flash_prefill.tma_strides`` decides which q/k/v the
tensor-core kernel takes: TMA reads them in place through their strides, so it
needs a 16-byte aligned base and (batch, head, row) strides that are multiples
of 16 bytes. It is a function of pointers and strides alone, so it is held
here on CPU tensors; the card's tests (``tests/test_torch_cuda.py``) hold the
wrapper to it on the card.
"""

import pytest
import torch

from fastkv_tpu_torch.ops import flash_prefill as tfp


def _aligned(shape, dtype=torch.bfloat16):
    x = torch.zeros(shape, dtype=dtype)
    assert x.data_ptr() % 16 == 0  # the CPU allocator aligns far more than this
    return x


@pytest.mark.parametrize("b,H,s,d", [(1, 32, 8192, 128), (2, 8, 300, 64), (3, 4, 1, 128)])
def test_tma_strides_contiguous(b, H, s, d):
    x = _aligned((b, H, s, d))
    sb, sh, ss = tfp.tma_strides(x, "q")
    # a dimension of size 1 takes the next inner extent, which TMA accepts
    assert ss == (d if s == 1 else x.stride(2))
    assert (sh, sb) == (x.stride(1), x.stride(0) if b > 1 else H * s * d)
    assert all(st * 2 % 16 == 0 for st in (sb, sh, ss))


def test_tma_strides_transposed_view_as_qkv_proj_gives_it():
    """k/v reach the kernel as [b, s, KH, d].transpose(1, 2): head stride d,
    row stride KH * d, taken as they are."""
    b, s, KH, d = 2, 300, 8, 128
    v = _aligned((b, s, KH, d)).transpose(1, 2)
    assert tfp.tma_strides(v, "v") == (s * KH * d, d, KH * d)


def test_tma_strides_slice_of_a_wider_tensor():
    """k as a slice of a fused projection: the base moves by whole heads (a
    multiple of 16 bytes), the strides stay those of the wider row."""
    b, s, H, KH, d = 1, 64, 4, 2, 64
    qkv = _aligned((b, s, (H + 2 * KH) * d))
    k = qkv[..., H * d:(H + KH) * d].view(b, s, KH, d).transpose(1, 2)
    assert tfp.tma_strides(k, "k")[1:] == (d, (H + 2 * KH) * d)


def test_tma_strides_misaligned_base_raises():
    flat = _aligned(4 * 64 * 64 + 1)
    q = flat[1:].view(1, 4, 64, 64)  # 2 bytes past an aligned base
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfp.tma_strides(q, "q")


@pytest.mark.parametrize("pad", [1, 4])
def test_tma_strides_misaligned_row_stride_raises(pad):
    q = _aligned((1, 4, 64, 64 + pad))[..., :64]  # rows 2 * (64 + pad) bytes apart
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        tfp.tma_strides(q, "q")


def test_tma_strides_float32_counts_bytes():
    """The rule is in bytes: 4 float32 elements are 16 bytes."""
    x = _aligned((1, 2, 8, 68), torch.float32)[..., :64]
    assert tfp.tma_strides(x, "q") == (2 * 8 * 68, 8 * 68, 68)


def test_tma_strides_needs_unit_stride_along_head_dim():
    q = _aligned((1, 4, 64, 64)).transpose(2, 3)
    with pytest.raises(ValueError, match="unit stride"):
        tfp.tma_strides(q, "q")
