"""Causal flash-attention prefill, square or rectangular, with an optional
sliding window: the CUDA kernel's wrapper and its plain version.

Replaces the TPU kernel ``fastkv_tpu/ops/flash_prefill.py::flash_attention``
(Pallas, ``pallas_call`` at :472) in every form: causal square, with and
without its ``sliding_window`` term (:143-144); rectangular with the
dynamic ``k_hi`` key-block gate (``k_positions``/``k_count``/``k_hi``,
:276-290), which chunked admission calls with a chunk of queries against a
bucket-sized key scratch; the fused window scores; and the ``'full'``
pattern with the ``(m, l)`` row statistics that ring attention merges. The kernel is
``fastkv_tpu_torch/kernels/csrc/flash_prefill.cu``: hand-written CUDA C++ for
sm_90a. What bounds it and what its design does about that is written at the
top of that file: it is bound by operations (~5.5e11 FLOP per layer call at
Llama-3.1-8B width and s = 8192; 1.32e13 at Ministral-8B's s = 40960 under
its 32768 window), walks key tiles only up to the diagonal (square) or up to
``k_hi`` and the last key a query tile can see (rectangular) and, under a
window, from the first tile that reaches the band. In bf16 it multiplies on
the tensor cores (wgmma) with 128-row tiles that TMA loads through a ring of
shared memory; in float32 (the tiny config's checks) on the CUDA cores.

TMA reads q, k and v in place, through their strides, and needs a 16-byte
aligned base and strides (along s, heads and batch) that are multiples of 16
bytes: ``tma_strides`` checks both and the wrapper raises on anything else.
It never copies an operand and never falls back to another kernel.

One more form, for DeepSeek-V2's latent attention (MLA): the causal square
with q/k width 192 and v width 128 (``v`` narrower than ``k``; the output
takes v's width) and the softmax scale the model gives (``scale``, YaRN's
mscale in it), bf16 only, without a window, fused scores, row statistics
or the rectangular walk (the MLA path asks for none of them). Its kernel
is an instantiation of the same bf16 kernel (``flash_prefill_sm90_kernel``
with q/k tiles of three 64-column boxes and v tiles of two). The plain
version takes a v narrower than q/k at any widths (the CPU tests' tiny
model), without fused scores or row statistics.

Semantics kept from the TPU kernel:
  * GQA native: query head h reads kv head h // (H / KH), no repeat;
  * causality over the given position ids (pk <= pq), with key validity folded
    into the key positions on the host (slots at or beyond the key count get
    2^30), in plain torch so the CPU tests cover it;
  * under a window W, key j is visible to query i only if pk > pq - W as well;
    the engine passes layout indices as positions then (``engine/prefill.py``
    ``_mask_positions``; chunked admission's scratch indices);
  * a row that sees no key gives 0 (the Pallas pure-causal path left finite
    garbage there; the XLA path and the port write 0).

The ``k_hi`` gate: the Pallas kernel skips key *blocks* that start at or
beyond ``k_hi``, so which keys past ``k_hi`` it still sees depends on its
1024-key blocks. Here both the kernel and its plain version treat every key
at index >= ``k_hi`` as invalid (``k_hi`` folds into the key count), so the
kernel equals its plain version whatever its tiling. It equals the JAX kernel
whenever ``k_hi >= k_count``, which is the only way the JAX package calls it
(``engine/chunked.py`` passes ``k_hi = k_count``).

Fused observation-window scores (``window_q``/``window_q_pos``, square form
only, as the JAX package asserts): the call also returns the SnapKV/FastKV
scores [b, H, s] float32, the exact full-row softmax of each of the W window
rows, summed over the rows, under the Pallas strip's mask (key position <=
the row's position, key index < count, row position >= 0; -1 marks a row of
a short prompt) and with no sliding-window term. The kernel scores each key
tile once, at the block whose diagonal it is, into a float32 strip in device
memory, and a second small kernel (``window_scores_finish``) turns the strip
into the scores (two kernels: each row's max and 1 / sum, then the column
sums); the plain version is ``window_scores_plain``.

Row statistics (``return_aux=True``, the JAX kernel's ``(m, l)`` outputs,
:271-278, :431-436, :483-485): the call also returns, per query row, ``m``,
the max of ``scale * q.k`` over the keys it sees, in natural-log units, and
``l``, the sum of ``exp(scale * q.k - m)`` over them, each [b, H, s] float32;
a row that sees no key gives ``o = 0``, ``l = 0`` and ``m = -1e30`` (JAX's
``NEG_INF``). Ring attention merges partials with them
(``parallel.ring_attention``): its local step is the square causal form with
statistics, every earlier chunk the ``'full'`` pattern with statistics. Not
with the fused scores.

``pattern='full'`` (the JAX kernel's no-diagonal-skip pattern, used for a K/V
chunk from another shard) takes the rectangular form, which walks every key
tile up to the last one its queries can see; the mask is the same
position-based one either way, so only the walk differs.

Positions form an ascending valid prefix and are non-negative; the kernel's
tile skipping relies on it. The rectangular form is taken when ``k`` is longer
or shorter than ``q``, or ``k_positions`` or ``k_hi`` is given, or the
pattern is ``'full'`` (the square form's diagonal skip holds only where
queries and keys share one position array).

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. ``launches`` counts kernel launches,
``rect_launches`` those of them in the rectangular form, ``scores_launches``
those in the fused-scores form, ``aux_launches`` those that write row
statistics, ``full_launches`` those in the ``'full'`` pattern, and
``finish_launches`` the fused form's finishing passes: one per fused call,
which launches its two kernels. The counts are module globals, added to
under a lock, so threads that launch at once (serving replicas) lose none.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from fastkv_tpu_torch.kernels import build
from fastkv_tpu_torch.ops import attention as att

INVALID_POS = 1 << 30
HEAD_DIMS = (64, 128)
# (q/k width, v width) of the forms the kernel takes with v narrower than k:
# the causal square in bf16, without a window (MLA)
NARROW_V = ((192, 128),)
MAX_WINDOW = (1 << 31) - 1  # the kernel takes W as a C int
MAX_WINDOW_ROWS = 4096  # window rows the finishing pass holds statistics for

launches = 0  # kernel launches since the caller last set it to 0
rect_launches = 0  # of those, launches of the rectangular form
scores_launches = 0  # of those, launches of the fused-scores form
aux_launches = 0  # of those, launches that write the (m, l) row statistics
full_launches = 0  # of those, launches in the 'full' pattern (ring attention's earlier chunks)
finish_launches = 0  # launches of the fused form's finishing pass
_count_lock = threading.Lock()  # held while a launch adds to the counts
PATTERNS = ("causal", "full")


def fold_key_validity(positions: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Key positions with validity folded in: slots at or beyond ``count`` get
    2^30, which the causal compare pk <= pq rejects. [b, s] int32."""
    s = positions.shape[1]
    idx = torch.arange(s, device=positions.device)[None, :]
    return torch.where(idx < count[:, None], positions.to(torch.int32), INVALID_POS).to(torch.int32)


def _key_side(positions, count, k_positions, k_count, k_hi):
    """Folded key positions [b, sk] int32 for either form: keys at or beyond
    ``k_count`` (default ``count``) or ``k_hi`` are invalid."""
    kpos = positions if k_positions is None else k_positions
    kc = count if k_count is None else k_count
    if k_hi is not None:
        kc = torch.minimum(kc.to(torch.int32), k_hi.to(torch.int32))
    return fold_key_validity(kpos, kc)


def tma_strides(x: torch.Tensor, name: str):
    """The (batch, head, row) element strides of a [b, heads, rows, d]
    operand as the bf16 kernel's TMA maps take them: a 16-byte aligned base
    and strides that are multiples of 16 bytes, or ValueError. A dimension
    of size 1 is never stepped along, so its stride is replaced by a legal
    one (the next inner dimension's extent) rather than checked."""
    if x.stride(-1) != 1:
        raise ValueError(f"flash_attention kernel: {name} needs unit stride along head_dim")
    elt = x.element_size()
    if x.data_ptr() % 16:
        raise ValueError(f"flash_attention kernel: {name}'s base address is not 16-byte aligned "
                         f"(TMA); pass an aligned tensor")
    out = []
    inner = x.shape[-1]  # the extent, in elements, of one step of the next dimension out
    for dim in (2, 1, 0):
        st = x.stride(dim) if x.shape[dim] > 1 else inner
        if st <= 0 or (st * elt) % 16:
            raise ValueError(f"flash_attention kernel: {name} stride {x.stride(dim)} along dim "
                             f"{dim} is not a multiple of 16 bytes (TMA)")
        out.append(st)
        inner = st * x.shape[dim]
    return out[2], out[1], out[0]


def window_scores_plain(
    window_q: torch.Tensor,  # [b, H, W, d]
    k: torch.Tensor,  # [b, KH, s, d]
    k_pos: torch.Tensor,  # [b, s] int32 folded key positions (``_key_side``)
    window_q_pos: torch.Tensor,  # [b, W] int32; -1 marks a row that scores nothing
    count: torch.Tensor,  # [b]
) -> torch.Tensor:
    """The fused form's scores [b, H, s] float32 in plain PyTorch: each window
    row's logits under the Pallas strip's mask (``pk <= pw``, ``col < count``,
    ``pw >= 0``; no sliding-window term), an exact full-row softmax (a row
    that sees no key gives 0), summed over the W rows."""
    b, h, w, d = window_q.shape
    kh, s = k.shape[1], k.shape[2]
    qg = window_q.reshape(b, kh, h // kh, w, d).to(torch.float32)
    logits = torch.matmul(qg, k.to(torch.float32)[:, :, None].transpose(-1, -2))
    logits = logits.reshape(b, h, w, s) * (d ** -0.5)
    pw = window_q_pos.to(torch.int32)[:, None, :, None]  # [b, 1, W, 1]
    col = torch.arange(s, device=k.device)[None, :] < count[:, None]  # [b, s]
    mask = (k_pos[:, None, None, :] <= pw) & col[:, None, None, :] & (pw >= 0)
    logits = torch.where(mask, logits, att.NEG_INF)
    m = torch.amax(logits, dim=-1, keepdim=True)
    p = torch.where(m > att.NEG_INF / 2, torch.exp(logits - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    inv = torch.where(l > 0, 1.0 / torch.where(l > 0, l, 1.0), 0.0)
    return (p * inv).sum(dim=-2)


def attention_with_stats(q, k, v, q_pos, k_pos, sliding_window=None, scale=None):
    """The plain attention with row statistics -> (out [b, H, s, d] in q's
    dtype, m, l [b, H, s] float32), over query blocks: ``k_pos`` are folded
    key positions; m is the max masked logit (``NEG_INF`` where a row sees
    no key), l the sum of exp(logit - m) over the visible keys, out the
    probabilities e / l (0 where l = 0), cast to V's dtype, times V."""
    b, h, sq, d = q.shape
    budget = 512 * 1024 * 1024 // (max(b * h * k.shape[2], 1) * 4)
    q_block = max(128, min(1024, budget))
    outs, ms, ls = [], [], []
    for i in range(0, sq, q_block):
        mask = att.causal_mask_from_positions(
            q_pos[:, i:i + q_block], k_pos, k_pos < INVALID_POS, sliding_window)
        logits = att._grouped_qk(q[:, :, i:i + q_block], k) * (d ** -0.5 if scale is None
                                                                else scale)
        logits = logits.masked_fill(~mask, att.NEG_INF)
        m = torch.amax(logits, dim=-1)
        e = torch.where(mask, torch.exp(logits - m[..., None]), 0.0)
        l = e.sum(dim=-1)
        outs.append(att._grouped_pv(e / torch.clamp(l, min=1e-30)[..., None], v, q.dtype))
        ms.append(m)
        ls.append(l)
    return torch.cat(outs, dim=2), torch.cat(ms, dim=2), torch.cat(ls, dim=2)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    positions: torch.Tensor,
    count: torch.Tensor,
    sliding_window: Optional[int] = None,
    k_positions: Optional[torch.Tensor] = None,
    k_count: Optional[torch.Tensor] = None,
    k_hi: Optional[torch.Tensor] = None,
    window_q: Optional[torch.Tensor] = None,
    window_q_pos: Optional[torch.Tensor] = None,
    return_aux: bool = False,
    scale: Optional[float] = None,
):
    """Plain PyTorch version of the kernel: the same folded mask, float32
    softmax over query blocks, rows that see nothing give 0; with
    ``window_q``, (out, ``window_scores_plain``); with ``return_aux``,
    (out, m, l) from ``attention_with_stats``. The pattern changes only the
    kernel's walk, so the plain version takes none."""
    k_pos = _key_side(positions, count, k_positions, k_count, k_hi)
    if return_aux:
        return attention_with_stats(q, k, v, positions.to(torch.int32), k_pos, sliding_window,
                                    scale)
    out = att.chunked_causal_attention(
        q, k, v, positions, k_pos, k_pos < INVALID_POS, sliding_window=sliding_window,
        scale=scale)
    if window_q is None:
        return out
    return out, window_scores_plain(window_q, k, k_pos, window_q_pos, count)


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C entry points' signatures (csrc/flash_prefill.cu)."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_prefill.argtypes = ([i, i, i] + [p] * 7 + [i] * 6 + [ll] * 9 + [ctypes.c_float]
                                  + [p] * 3 + [i] + [ll] * 3 + [p] * 3)
    lib.flash_prefill.restype = ctypes.c_int
    lib.window_scores_finish.argtypes = [p, p, p] + [i] * 4 + [p]
    lib.window_scores_finish.restype = ctypes.c_int


def launch(lib, q, k, v, q_pos, k_pos, stream: int, window: int = 0,
           k_hi: Optional[torch.Tensor] = None, window_q: Optional[torch.Tensor] = None,
           window_q_pos: Optional[torch.Tensor] = None, aux: bool = False,
           full: bool = False, scale: Optional[float] = None):
    """Launch the kernel on prepared operands; returns the [b, H, s, d] output,
    or (output, scores [b, H, s] float32) with ``window_q``, or (output, m,
    l) with ``aux`` (m in natural-log units, -1e30 and l = 0 on a row that
    sees no key). ``full`` only counts the launch as the 'full' pattern's
    (the caller passes the rectangular form's gate for it).
    q/k/v need unit stride along d (bf16: and ``tma_strides``' alignment,
    checked here); q_pos [b, s] and k_pos [b, sk] are
    contiguous int32; ``window`` is the sliding window W >= 1, or 0 for none;
    ``k_hi`` is None for the square form (sk == s) or a contiguous int32 [b]
    of gates in [0, sk] for the rectangular form. ``window_q`` [b, H, W, d]
    (unit stride along d) and ``window_q_pos`` [b, W] contiguous int32 ask
    for the fused scores (square form): the flash kernel writes the raw
    strip, and the finishing pass the scores. ``scale`` multiplies the
    logits (default d^-0.5); the output takes v's width.
    The launches are asynchronous; operands may be freed on return, because
    the caching allocator reuses their memory only for work queued after the
    kernels on the same stream."""
    global launches, rect_launches, scores_launches, finish_launches, aux_launches
    global full_launches
    b, h, s, d = q.shape
    dv = v.shape[-1]
    if q.dtype == torch.bfloat16:  # the tensor-core kernel reads q/k/v through TMA
        strides = [*tma_strides(q, "q"), *tma_strides(k, "k"), *tma_strides(v, "v")]
    else:
        strides = [x.stride(i) for x in (q, k, v) for i in range(3)]
    out = torch.empty((b, h, s, dv), dtype=q.dtype, device=q.device)
    strip, nw, wq_strides = None, 0, (0, 0, 0)
    if window_q is not None:
        nw = window_q.shape[2]
        strip = torch.empty((b, h, nw, s), dtype=torch.float32, device=q.device)
        wq_strides = (window_q.stride(0), window_q.stride(1), window_q.stride(2))

    m = l = None
    if aux:
        if window_q is not None:
            raise ValueError("flash_prefill launch: row statistics and fused scores do not "
                             "go together")
        m = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
        l = torch.empty((b, h, s), dtype=torch.float32, device=q.device)

    def ptr(x):
        return None if x is None else x.data_ptr()

    err = lib.flash_prefill(
        build.DTYPES[q.dtype], d, dv, q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        k_pos.data_ptr(), ptr(k_hi), out.data_ptr(),
        b, h, k.shape[1], s, k.shape[2], window, *strides,
        d ** -0.5 if scale is None else scale, ptr(window_q),
        ptr(window_q_pos), ptr(strip), nw, *wq_strides, ptr(m), ptr(l), stream)
    build.check(lib, err, "flash_prefill")
    with _count_lock:
        launches += 1
        rect_launches += k_hi is not None
        aux_launches += aux
        full_launches += full
        scores_launches += window_q is not None
    if aux:
        return out, m, l
    if window_q is None:
        return out
    scores = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    stats = torch.empty((b, h, nw, 2), dtype=torch.float32, device=q.device)  # max, 1 / sum
    err = lib.window_scores_finish(strip.data_ptr(), stats.data_ptr(), scores.data_ptr(), b, h,
                                   nw, s, stream)
    build.check(lib, err, "window_scores_finish")
    with _count_lock:
        finish_launches += 1
    return out, scores


def flash_attention(
    q: torch.Tensor,  # [b, H, s, d]
    k: torch.Tensor,  # [b, KH, sk, d]
    v: torch.Tensor,  # [b, KH, sk, d]
    positions: torch.Tensor,  # [b, s] original positions (ascending valid prefix)
    count: torch.Tensor,  # [b] number of valid tokens (keys, unless k_count is given)
    sliding_window: Optional[int] = None,
    k_positions: Optional[torch.Tensor] = None,  # [b, sk]; defaults to positions
    k_count: Optional[torch.Tensor] = None,  # [b] valid keys; defaults to count
    k_hi: Optional[torch.Tensor] = None,  # [b] keys at index >= k_hi are invalid
    window_q: Optional[torch.Tensor] = None,  # [b, H, W, d] observation-window rows
    window_q_pos: Optional[torch.Tensor] = None,  # [b, W] int32 their positions, -1: none
    pattern: str = "causal",  # 'full': the rectangular walk (a chunk from another shard)
    return_aux: bool = False,  # also return the (m, l) row statistics [b, H, s] float32
    scale: Optional[float] = None,  # the logits' scale (default d^-0.5)
):
    """Causal prefill attention, under ``sliding_window`` if given ->
    [b, H, s, dv] in q's dtype (dv: v's width); with ``window_q``, (that,
    the window scores [b, H, s] float32); with ``return_aux``, (that, m,
    l)."""
    b, h, s, d = q.shape
    if pattern not in PATTERNS:
        raise ValueError(f"flash_attention: pattern {pattern!r} is not one of {PATTERNS}")
    if return_aux and window_q is not None:
        raise ValueError("flash_attention: return_aux and fused window scores do not go "
                         "together")
    sk = k.shape[2]
    if v.shape[:3] != k.shape[:3] or k.shape[3] != d or k.shape[0] != b or h % k.shape[1]:
        raise NotImplementedError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if k_positions is not None and tuple(k_positions.shape) != (b, sk):
        raise ValueError(f"flash_attention: k_positions {tuple(k_positions.shape)} is not "
                         f"[{b}, {sk}]")
    for name, x in (("k_count", k_count), ("k_hi", k_hi)):
        if x is not None and tuple(x.shape) != (b,):
            raise ValueError(f"flash_attention: {name} {tuple(x.shape)} is not [{b}]")
    if sk != s and k_positions is None:
        raise ValueError("flash_attention: a rectangular call (sk != s) needs k_positions")
    if sliding_window is not None and not 1 <= sliding_window <= MAX_WINDOW:
        raise ValueError(f"flash_attention: sliding_window {sliding_window} is not in "
                         f"[1, {MAX_WINDOW}]")
    if (window_q is None) != (window_q_pos is None):
        raise ValueError("flash_attention: window_q and window_q_pos go together")
    if window_q is not None:
        nw = window_q.shape[2]
        if (tuple(window_q.shape) != (b, h, nw, d) or tuple(window_q_pos.shape) != (b, nw)
                or not 1 <= nw <= MAX_WINDOW_ROWS):
            raise ValueError(f"flash_attention: window_q {tuple(window_q.shape)}, "
                             f"window_q_pos {tuple(window_q_pos.shape)}")
        if sk != s or k_positions is not None or k_count is not None or k_hi is not None:
            raise ValueError("flash_attention: fused window scores need the square form "
                             "(sk == s, no k_positions, k_count or k_hi)")
    dv = v.shape[3]
    if dv != d and (window_q is not None or return_aux):
        raise NotImplementedError(f"flash_attention: v width {dv} below q/k width {d} takes no "
                                  f"fused scores or row statistics")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, positions, count, sliding_window,
                                     k_positions, k_count, k_hi, window_q, window_q_pos,
                                     return_aux, scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: unsupported device {q.device}")
    narrow = (d, dv) in NARROW_V
    if dv != d and not narrow:
        raise NotImplementedError(f"flash_attention kernel: q/k width {d} with v width {dv} is "
                                  f"not one of {NARROW_V}")
    if d not in HEAD_DIMS and not narrow:
        raise NotImplementedError(f"flash_attention kernel: head_dim {d} not in {HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in build.DTYPES:
        raise TypeError(f"flash_attention kernel: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention kernel: q/k/v need unit stride along head_dim")
    full = pattern == "full"
    rect = sk != s or k_positions is not None or k_hi is not None or full
    if narrow and (q.dtype != torch.bfloat16 or rect or sliding_window is not None):
        raise NotImplementedError(f"flash_attention kernel: the ({d}, {dv}) form is the causal "
                                  f"square in bf16 without a window")
    q_pos = positions.to(torch.int32).contiguous()
    k_pos = _key_side(positions, count, k_positions, k_count, k_hi).contiguous()
    gate = None
    if rect:
        hi = torch.full((b,), sk, dtype=torch.int32, device=q.device) if k_hi is None else k_hi
        gate = torch.clamp(hi.to(torch.int32), 0, sk).contiguous()
    wpos = None
    if window_q is not None:
        if window_q.dtype != q.dtype:
            raise TypeError(f"flash_attention kernel: window_q {window_q.dtype}, q {q.dtype}")
        if window_q.stride(3) != 1:
            window_q = window_q.contiguous()
        wpos = window_q_pos.to(torch.int32).contiguous()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return launch(build.load("flash_prefill", bind), q, k, v, q_pos, k_pos, stream,
                  sliding_window or 0, gate, window_q, wpos, return_aux, full, scale)
