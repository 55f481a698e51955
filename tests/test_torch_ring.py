"""Ring attention's pieces in the port against the JAX package, on the CPU.

* ``merge`` against JAX ``ring_attention._merge`` on seeded inputs, rows whose
  partial saw no key (m = -1e30, l = 0) included.
* The flash wrapper's plain version with ``return_aux`` (the ``'full'``
  pattern of an earlier chunk, and the square causal form of the local step,
  with and without a sliding window) against the JAX kernel in interpret
  mode: o, m and l in float32, rows that see no key included (o = 0, m =
  -1e30, l = 0). The JAX kernel's pure-causal square path leaves finite
  garbage in a row that sees no key (its documented invariant), so that one
  case compares only rows that see a key.
* ``ring_step`` over 2 and 4 chunks held in one process against one square
  causal call over the whole sequence, and against the JAX ring (its XLA
  route under ``shard_map`` on the virtual CPU mesh).

Tolerances: float32 on both sides, another order of summation: 2e-5
absolute on o and m, 1e-5 relative on l.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from fastkv_tpu.core.config import ParallelConfig as JParallelConfig
from fastkv_tpu.ops.flash_prefill import flash_attention as j_flash
from fastkv_tpu.parallel import ring_attention as jra
from fastkv_tpu.parallel.sharding import make_mesh as j_make_mesh
from fastkv_tpu_torch.ops import flash_prefill as tfp
from fastkv_tpu_torch.parallel import ring_attention as tra

ATOL, L_RTOL = 2e-5, 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_merge_matches_jax():
    rng = np.random.default_rng(3)
    b, h, s, d = 2, 3, 5, 8
    o1, o2 = (rng.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(2))
    m1, m2 = (rng.standard_normal((b, h, s)).astype(np.float32) * 3 for _ in range(2))
    l1, l2 = (rng.uniform(0.5, 20, (b, h, s)).astype(np.float32) for _ in range(2))
    # partials that saw no key: one side, and both sides
    m1[0, 0, 1], l1[0, 0, 1], o1[0, 0, 1] = -1e30, 0.0, 0.0
    m2[1, 2, 3], l2[1, 2, 3], o2[1, 2, 3] = -1e30, 0.0, 0.0
    m1[1, 1, 4] = m2[1, 1, 4] = -1e30
    l1[1, 1, 4] = l2[1, 1, 4] = 0.0
    o1[1, 1, 4] = o2[1, 1, 4] = 0.0
    ref = jra._merge(*(jnp.asarray(x) for x in (o1, m1, l1, o2, m2, l2)))
    got = tra.merge(*(_t(x) for x in (o1, m1, l1, o2, m2, l2)))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


def _chunks(seed, b=2, h=4, kh=2, s=128, d=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, kh, s, d)).astype(np.float32)
    v = rng.standard_normal((b, kh, s, d)).astype(np.float32)
    return q, k, v


# (name, pattern, query chunk start, key chunk start, count, k_count, window)
AUX_CASES = [
    # an earlier chunk, ragged: one example's chunk holds no valid key
    ("full_ragged", "full", 128, 0, [200, 100], [90, 0], None),
    # an earlier chunk under a window that leaves the last rows no key
    ("full_window", "full", 128, 0, [256, 256], [128, 128], 100),
    # the local step: the square causal form over the local chunk
    ("causal_local", "causal", 128, 128, [200, 150], [72, 22], None),
    # the local step under a window: rows past the window's reach see no key
    ("causal_local_window", "causal", 128, 128, [200, 150], [72, 22], 50),
]


@pytest.mark.parametrize("name,pattern,q0,k0,count,k_count,window", AUX_CASES,
                         ids=[c[0] for c in AUX_CASES])
def test_plain_aux_matches_jax_kernel(name, pattern, q0, k0, count, k_count, window):
    q, k, v = _chunks(5)
    b, _, s, _ = q.shape
    qpos = np.broadcast_to(np.arange(q0, q0 + s, dtype=np.int32), (b, s)).copy()
    kpos = np.broadcast_to(np.arange(k0, k0 + s, dtype=np.int32), (b, s)).copy()
    cnt = np.asarray(count, np.int32)
    kcnt = np.asarray(k_count, np.int32)
    with pltpu.force_tpu_interpret_mode():
        oj, mj, lj = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(qpos),
                             jnp.asarray(cnt), sliding_window=window, pattern=pattern,
                             return_aux=True, k_positions=jnp.asarray(kpos),
                             k_count=jnp.asarray(kcnt), block_q=128, block_k=128)
    # the port's local step shares one position array (the square form)
    kp = None if pattern == "causal" else _t(kpos)
    ot, mt, lt = tfp.flash_attention(_t(q), _t(k), _t(v), _t(qpos), _t(cnt), window,
                                     k_positions=kp, k_count=_t(kcnt), pattern=pattern,
                                     return_aux=True)
    oj, mj, lj = np.asarray(oj), np.asarray(mj), np.asarray(lj)
    sees = lt.numpy() > 0  # [b, H, s]
    if pattern == "causal" and window is None:
        rows = sees  # the Pallas pure-causal path: garbage where a row sees nothing
        assert sees.all()
    else:
        rows = np.ones_like(sees)
        assert (~sees).any(), "the case must hold rows that see no key"
        np.testing.assert_array_equal(lj[~sees], 0.0)
        np.testing.assert_array_equal(mt.numpy()[~sees], np.float32(-1e30))
        np.testing.assert_array_equal(mj[~sees], np.float32(-1e30))
        np.testing.assert_array_equal(ot.numpy()[~sees], 0.0)
    np.testing.assert_allclose(ot.numpy()[rows], oj[rows], atol=ATOL, rtol=0)
    np.testing.assert_allclose(mt.numpy()[rows], mj[rows], atol=ATOL, rtol=0)
    np.testing.assert_allclose(lt.numpy()[rows], lj[rows], rtol=L_RTOL, atol=0)


def _ring_in_process(q, k, v, pos, cnt, p, window):
    """Each place i's ring steps over the chunks in rotation order, merged."""
    s_loc = q.shape[2] // p
    chunk = lambda x, j: x[..., j * s_loc:(j + 1) * s_loc, :]  # noqa: E731
    pchunk = lambda j: pos[:, j * s_loc:(j + 1) * s_loc]  # noqa: E731
    outs = []
    for i in range(p):
        acc = None
        for t in range(p):
            owner = (i - t) % p
            acc = tra.ring_step(chunk(q, i), chunk(k, owner), chunk(v, owner), pchunk(owner),
                                pchunk(i), cnt, owner, i, acc, window)
        outs.append(acc[0].to(q.dtype))
    return torch.cat(outs, dim=2)


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("window", [None, 64])
def test_ring_steps_match_one_causal_call_and_the_jax_ring(p, window):
    q, k, v = _chunks(11, b=1, h=8, kh=4, s=256, d=16)
    cnt = np.asarray([200], np.int32)
    pos = np.arange(256, dtype=np.int32)[None]
    got = _ring_in_process(_t(q), _t(k), _t(v), _t(pos), _t(cnt), p, window).numpy()
    whole = tfp.flash_attention(_t(q), _t(k), _t(v), _t(pos), _t(cnt), window).numpy()
    np.testing.assert_allclose(got, whole, atol=ATOL, rtol=0)
    mesh = j_make_mesh(JParallelConfig(data=1, model=1, seq=p))
    fn = jra.make_ring_attention(mesh, sliding_window=window, use_pallas=False)
    with jax.set_mesh(mesh):
        ref = np.asarray(jax.jit(fn)(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(pos), jnp.asarray(cnt)))
    valid = np.arange(256) < cnt[0]  # the JAX ring leaves rows past the count unspecified
    np.testing.assert_allclose(got[:, :, valid], ref[:, :, valid], atol=ATOL, rtol=0)


def test_ring_step_skips_later_chunks():
    q, k, v = _chunks(2, b=1, h=2, kh=1, s=64, d=8)
    pos = torch.arange(64, dtype=torch.int32)[None]
    acc = (torch.zeros(1, 2, 64, 8), torch.zeros(1, 2, 64), torch.ones(1, 2, 64))
    assert tra.ring_step(_t(q), _t(k), _t(v), pos, pos, torch.tensor([64]), 1, 0, acc) is acc


@pytest.mark.parametrize("kh,h,p,r", [(4, 8, 2, 1), (4, 8, 8, 2), (2, 8, 4, 2), (8, 32, 2, 1)])
def test_ulysses_kv_repeats(kh, h, p, r):
    assert tra.kv_repeats(kh, h, p) == r


def test_ulysses_refuses_heads_it_cannot_split():
    with pytest.raises(ValueError, match="cannot split"):
        tra.kv_repeats(2, 6, 4)


def test_aux_refuses_fused_scores_and_unknown_patterns():
    q, k, v = (_t(x) for x in _chunks(1, b=1, h=2, kh=1, s=16, d=8))
    pos = torch.arange(16, dtype=torch.int32)[None]
    cnt = torch.tensor([16], dtype=torch.int32)
    with pytest.raises(ValueError, match="pattern"):
        tfp.flash_attention(q, k, v, pos, cnt, pattern="diagonal")
    with pytest.raises(ValueError, match="return_aux"):
        tfp.flash_attention(q, k, v, pos, cnt, window_q=q[:, :, :4],
                            window_q_pos=pos[:, :4], return_aux=True)
