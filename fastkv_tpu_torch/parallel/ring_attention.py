"""Sequence parallelism: ring attention and Ulysses over the mesh's ``seq``
ranks.

Port of ``fastkv_tpu/parallel/ring_attention.py``. Each of the P ranks of a
``seq`` group holds a contiguous [s/P]-token chunk of q, k and v.

Ring attention (``ring_flash_attention``, JAX :55-127): P steps. Step 0
attends the local queries to the local chunk (the square causal form with
its row statistics); at step t the rank holds the K/V chunk of rank
(i - t) mod P, which it received from the previous rank
(``parallel.comm.ring_shift``: every rank takes part in every rotation). A
chunk strictly before the local one is fully visible (the ``'full'`` pattern
with row statistics) and merges into the running result by the online
softmax's statistics (``merge``); a chunk after it contributes nothing and is
skipped (JAX's ``lax.cond`` is a Python ``if``). ``ring_step`` is one step
(partial attention plus merge) apart from the rotation, so the same
arithmetic runs over chunks held in one process (the smoke run's check at
P = 2 and 4, the tests). On the card the steps launch the flash kernel; on
the CPU its plain version with statistics (the JAX package's XLA route,
:83-96).

Ulysses (``ulysses_attention``, JAX :162-213): an all-to-all reshards
sequence to heads (every rank gets the whole sequence of H/P query heads,
and of the kv heads, replicated to a multiple of P where there are fewer),
the square causal form runs over the whole sequence, and a second
all-to-all reshards back.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from fastkv_tpu_torch.ops import flash_prefill as fp
from fastkv_tpu_torch.parallel import comm

Partial = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (o, m, l)


def merge(o1, m1, l1, o2, m2, l2) -> Partial:
    """Merge two online-softmax partials whose outputs are each normalised
    by their own l (JAX ``_merge``) -> (o float32, m, l)."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m) * l1
    a2 = torch.exp(m2 - m) * l2
    denom = a1 + a2
    safe = torch.clamp(denom, min=1e-30)
    o = o1.float() * (a1 / safe)[..., None] + o2.float() * (a2 / safe)[..., None]
    return o, m, denom


def chunk_count(count_global: torch.Tensor, owner: int, s_loc: int) -> torch.Tensor:
    """The valid keys of the chunk of rank ``owner``: [b] int32."""
    return torch.clamp(count_global - owner * s_loc, 0, s_loc).to(torch.int32)


def ring_step(q, kc, vc, pc, positions, count_global, owner: int, index: int,
              acc: Optional[Partial], sliding_window: Optional[int] = None
              ) -> Optional[Partial]:
    """One ring step of the rank at place ``index``: its queries q [b, H,
    s_loc, d] at ``positions`` [b, s_loc] against the chunk (kc, vc, pc) of
    rank ``owner``, merged into ``acc`` (None before step 0). The local chunk
    (owner == index) takes the square causal form, a chunk before it the
    'full' pattern, a chunk after it nothing."""
    s_loc = q.shape[2]
    if owner > index:
        return acc
    cnt = chunk_count(count_global, owner, s_loc)
    if owner == index:
        part = fp.flash_attention(q, kc, vc, positions, count_global, sliding_window,
                                  k_count=cnt, return_aux=True)
    else:
        part = fp.flash_attention(q, kc, vc, positions, count_global, sliding_window,
                                  k_positions=pc, k_count=cnt, pattern="full",
                                  return_aux=True)
    return part if acc is None else merge(*acc, *part)


def ring_flash_attention(q, k, v, positions, count_global, mesh,
                         sliding_window: Optional[int] = None) -> torch.Tensor:
    """Ring attention over ``mesh``'s seq group. q [b, H, s_loc, d], k/v [b,
    KH, s_loc, d] and positions [b, s_loc] are this rank's chunk;
    count_global [b] counts the valid tokens of the whole sequence. Returns
    [b, H, s_loc, d] in q's dtype."""
    p, i = mesh.seq, mesh.seq_index
    acc = ring_step(q, k, v, positions, positions, count_global, i, i, None, sliding_window)
    kc, vc, pc = k, v, positions
    for t in range(1, p):
        kc, vc, pc = comm.ring_shift([kc, vc, pc], mesh.seq_group, mesh.seq_ranks, i)
        acc = ring_step(q, kc, vc, pc, positions, count_global, (i - t) % p, i, acc,
                        sliding_window)
    return acc[0].to(q.dtype)


def kv_repeats(kh: int, h: int, p: int) -> int:
    """How many times Ulysses repeats each kv head so that P divides them
    (the fewest), or ValueError where the query heads cannot follow."""
    r = 1
    while (kh * r) % p:
        r += 1
    if h % p or h % (kh * r):
        raise ValueError(f"ulysses: cannot split {h} query and {kh} kv heads over {p} ranks")
    return r


def ulysses_attention(q, k, v, positions_global, count_global, mesh,
                      sliding_window: Optional[int] = None) -> torch.Tensor:
    """Ulysses over ``mesh``'s seq group: q [b, H, s_loc, d], k/v [b, KH,
    s_loc, d] this rank's chunk; positions_global [b, s] of the whole
    sequence. Repeating a kv head r times keeps query head h on kv head
    h // (H / KH) (each repeat sits next to its original). Returns [b, H,
    s_loc, d] in q's dtype."""
    p, i = mesh.seq, mesh.seq_index
    r = kv_repeats(k.shape[1], q.shape[1], p)
    if r > 1:
        k = k.repeat_interleave(r, dim=1)
        v = v.repeat_interleave(r, dim=1)
    g, ranks = mesh.seq_group, mesh.seq_ranks
    qf, kf, vf = (comm.all_to_all(x, g, ranks, i, split_dim=1, concat_dim=2)
                  for x in (q, k, v))
    of = fp.flash_attention(qf, kf, vf, positions_global, count_global, sliding_window)
    return comm.all_to_all(of, g, ranks, i, split_dim=2, concat_dim=1)
