"""The kernels' agreement limits (``fastkv_tpu_torch.kernels.agreement``) on the
CPU: the plain versions run in bfloat16, which round P and the output as the
kernels do, pass against their float32 result; the same result with one key
tile or cache chunk dropped, or one element off, fails."""

import numpy as np
import pytest
import torch

from fastkv_tpu_torch.kernels import agreement
from fastkv_tpu_torch.ops import attention as tatt
from fastkv_tpu_torch.ops import decode_attn as tda
from fastkv_tpu_torch.ops import flash_prefill as tfp
from fastkv_tpu_torch.utils.testing import one_thread_per_module

_one_torch_thread = one_thread_per_module()

BF16 = agreement.TOLERANCES[torch.bfloat16]


def _bf16(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16()


def _flash(mutation):
    rng = np.random.default_rng(0)
    b, h, kh, s, d = 1, 4, 2, 256, 64
    q, k, v = _bf16(rng, (b, h, s, d)), _bf16(rng, (b, kh, s, d)), _bf16(rng, (b, kh, s, d))
    pos = torch.arange(s, dtype=torch.int32)[None]
    cnt = torch.tensor([s - 20], dtype=torch.int32)
    ref = tfp.flash_attention_plain(q.float(), k.float(), v.float(), pos, cnt)
    out = tfp.flash_attention_plain(q, k, v, pos, cnt)
    if mutation == "dropped_tile":  # keys 64..127 unseen by every later row
        kpos = tfp.fold_key_validity(pos, cnt)
        kpos[:, 64:128] = tfp.INVALID_POS
        kept = tatt.chunked_causal_attention(q, k, v, pos, kpos, kpos < tfp.INVALID_POS)
        out = torch.cat([out[:, :, :128], kept[:, :, 128:]], dim=2)
    elif mutation == "one_element":
        out = out.clone()
        out[0, 1, 200, 5] += 0.1 * out[0, 1, 200].float().square().mean().sqrt().item()
    return out, ref


def _decode(mutation):
    rng = np.random.default_rng(1)
    b, h, ch, c, d = 1, 8, 2, 2048, 128
    q = _bf16(rng, (b, h, 1, d))
    kc, vc = _bf16(rng, (b, ch, c, d)), _bf16(rng, (b, ch, c, d))
    valid = torch.from_numpy(rng.random((b, ch, c)) < 0.9)
    ref = tda.decode_attention_plain(q.float(), kc.float(), vc.float(), valid)
    if mutation == "dropped_tile":  # one 32-slot chunk of ~1840 valid slots lost
        valid = valid.clone()
        valid[:, :, 512:544] = False
    out = tda.decode_attention_plain(q, kc, vc, valid)
    if mutation == "one_element":
        out = out.clone()
        out[0, 3, 0, 7] += 0.1 * out[0, 3, 0].float().square().mean().sqrt().item()
    return out, ref


@pytest.mark.parametrize("case", [_flash, _decode], ids=["flash", "decode"])
@pytest.mark.parametrize("mutation", [None, "dropped_tile", "one_element"])
def test_bf16_limits_pass_rounding_and_reject_lost_work(case, mutation):
    out, ref = case(mutation)
    r = agreement.compare(out, ref, BF16)
    assert r["ok"] == (mutation is None), r
    if mutation is None:
        # rounding alone sits well inside the limits it was sized for
        assert r["max_row_rel_rms"] < BF16.row / 2 and r["max_elem_rel"] < BF16.elem / 2, r


def test_rows_that_see_no_key_must_be_exactly_zero():
    ref = torch.zeros(2, 3, 8)
    ref[0] = 1.0
    out = ref.clone()
    assert agreement.compare(out, ref, BF16)["ok"]
    out[1, 2, 4] = 1e-6
    assert not agreement.compare(out, ref, BF16)["ok"]
