"""Decode attention over the compressed cache: the CUDA kernel's wrapper and its
plain version.

Replaces the TPU kernel ``fastkv_tpu/ops/experimental/decode_attn.py::
decode_attention`` (Pallas, ``pallas_call`` at :231). The TPU build shelved it
for a v5e timing reason; in the port it is the decode path. The kernel is
``fastkv_tpu_torch/kernels/csrc/decode_attn.cu``: hand-written CUDA C++ for
sm_90a. It is bound by bytes (each visible K/V row read once: ~4 MB per layer
for the FastKV cache at Llama-3.1-8B width, ~34 MB for FullKV at 8K context).
With bf16 q (a bf16 or int8 cache) it is one launch of a tensor-core kernel:
each CTA takes one (batch, cache head, up to 16 query heads) and a run of
64-slot tiles (``split_plan``), reads the run's mask first and never reads a
tile with no visible slot, streams K/V through a 3-stage cp.async ring,
scores and accumulates with ``mma.sync`` under an online softmax, and the
last CTA of each (batch, cache head) to arrive merges the runs in the same
launch. float32 q keeps a CUDA-core kernel pair (split, then merge).

The mask is the explicit ``valid`` ([b, C] or [b, CH, C]): the compressed cache
is scattered (kept prefix, then decode slots). A row with no visible slot
gives 0. Two more forms, template parameters of the same kernel chosen at
launch:

  * the Pallas kernel's own sliding-window term (:110-112): slot c is visible
    only if ``k_pos[c] > q_pos - W``. No engine path passes it (decode cuts a
    window by rank, ``engine.decode.window_mask``), but it is part of the
    kernel, so it is ported and held to its plain version;
  * an int8 cache with per-slot float32 scales (``EngineConfig.kv_int8``),
    which the JAX package folds in on its XLA path (its Pallas kernel is
    bf16-only): K's scales multiply the logits, V's the probabilities, and no
    dequantized copy of the cache exists. An int8 cache without scales raises.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. ``launches`` counts wrapper calls that
launched it; ``int8_launches`` and ``window_launches`` count those of the two
forms. The counts are module globals, added to under a lock, so threads that
launch at once (serving replicas) lose none. A call captured into a CUDA
graph launches nothing: it is held per stream (``take_captured``), and each
replay of the graph counts what it holds (``count_launches``).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from fastkv_tpu_torch.kernels import build
from fastkv_tpu_torch.ops import attention as att

HEAD_DIMS = (64, 128)
TILE = 64  # cache slots a tile (csrc/decode_attn.cu kTile)
MAX_TILES = 32  # tiles a split (kMaxTiles; also the float32 kernel's 2048-slot chunk)
MAX_SPLITS = 256  # splits a (batch, cache head, row group) (kMaxSplits)
MAX_ROWS = 16  # query heads a CTA (kTcRows); a larger group takes more row groups
MAX_WINDOW = (1 << 31) - 1  # the kernel takes W as a C int

launches = 0  # kernel launches since the caller last set it to 0
int8_launches = 0  # of those, launches over an int8 cache
window_launches = 0  # of those, launches with the sliding-window term

_count_lock = threading.Lock()  # held while a launch adds to the counts
# stream -> [launches, int8, window] of the calls captured on it since the
# last take_captured
_captured: Dict[int, List[int]] = {}

_counters: Dict[Tuple[int, int], torch.Tensor] = {}  # (device, stream) -> arrival counters
_counters_lock = threading.Lock()


def decode_attention_plain(q, k_cache, v_cache, valid, q_pos=None, k_pos=None,
                           sliding_window=None, k_scale=None, v_scale=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (``ops.attention.decode_attention``)."""
    return att.decode_attention(q, k_cache, v_cache, valid, q_pos, k_pos, sliding_window,
                                k_scale, v_scale)


class SplitPlan(NamedTuple):
    tiles: int  # TILE-slot tiles a split walks (the last split may walk fewer)
    splits: int  # splits of the cache axis
    row_groups: int  # groups of up to MAX_ROWS query heads a cache head

    def grid(self, b: int, ch: int) -> int:
        """CTAs of one launch."""
        return self.splits * ch * self.row_groups * b

    def scratch_floats(self, b: int, ch: int, group: int, d: int, bf16: bool) -> int:
        """float32 scratch of one call: the splits' (m, l, acc) partials (none
        for a bf16 call with one split, which writes its output directly)."""
        if bf16:
            return 0 if self.splits == 1 else (
                b * ch * self.row_groups * self.splits * MAX_ROWS * (d + 2))
        return b * ch * self.splits * group * (d + 2)


def split_plan(b: int, ch: int, group: int, C: int, num_sms: int) -> SplitPlan:
    """How the cache axis is cut over CTAs, from the shapes alone: as many
    splits as one wave of one CTA an SM holds, each split a whole number of
    TILE-slot tiles (at most MAX_TILES), and every split non-empty. One wave,
    because a second, partial one would leave most SMs idle while it runs;
    one CTA an SM (two fit at d = 128 bf16), because twice the tiles a split
    means half the splits to merge, which measured faster in every main-path
    form; a long cache walks several tiles a split, which keeps the ring in
    flight; a short one few, so that its bytes are spread over as many SMs
    as it can fill."""
    if C < 1:
        raise ValueError(f"decode_attention: a cache of {C} slots")
    ntiles = -(-C // TILE)
    row_groups = -(-group // MAX_ROWS)
    units = b * ch * row_groups
    want = max(1, num_sms // units)
    tiles = min(MAX_TILES, -(-ntiles // min(ntiles, want)))
    splits = -(-ntiles // tiles)
    if splits > MAX_SPLITS:
        raise NotImplementedError(
            f"decode_attention kernel: C = {C} exceeds {MAX_SPLITS * MAX_TILES * TILE} slots")
    return SplitPlan(tiles, splits, row_groups)


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C entry point's signature (csrc/decode_attn.cu)."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.decode_attn.argtypes = (
        [i] * 3 + [p] * 11 + [i] * 7 + [ll] * 14 + [ctypes.c_float, p])
    lib.decode_attn.restype = ctypes.c_int


def _strides(x: Optional[torch.Tensor]) -> Tuple[int, int]:
    """(batch, head) strides in elements of a [b, C] or [b, CH, C] operand; a
    [b, C] one is broadcast over the cache heads by a zero head stride."""
    if x is None:
        return 0, 0
    return x.stride(0), (0 if x.dim() == 2 else x.stride(1))


def cp_async_strides(x: torch.Tensor, name: str) -> None:
    """The bf16 kernel copies K/V rows to shared memory 16 bytes at a time:
    a [b, CH, C, d] cache needs unit stride along d, a 16-byte aligned base
    and strides (of the dimensions longer than 1) that are multiples of 16
    bytes, or ValueError. Never a copy."""
    if x.stride(-1) != 1:
        raise ValueError(f"decode_attention kernel: {name} needs unit stride along head_dim")
    if x.data_ptr() % 16:
        raise ValueError(f"decode_attention kernel: {name}'s base address is not 16-byte "
                         f"aligned (cp.async); pass an aligned tensor")
    elt = x.element_size()
    for dim in (0, 1, 2):
        if x.shape[dim] > 1 and (x.stride(dim) * elt) % 16:
            raise ValueError(f"decode_attention kernel: {name} stride {x.stride(dim)} along "
                             f"dim {dim} is not a multiple of 16 bytes (cp.async)")


def _arrival_counters(device: torch.device, stream: int, n: int) -> torch.Tensor:
    """Per-(device, stream) int32 arrival counters of the bf16 kernel's merge:
    zero when made, and left zero by the last CTA of each (batch, cache head,
    row group) of a call, so calls in order on one stream share them.

    The contract: no two calls that share these counters may run at once.
    Calls on one stream run in order, so eager calls keep it. A CUDA graph
    keeps the counters of the stream it was captured on: replay it on that
    stream, in order with the eager calls there, never beside them on
    another stream. A call that overlapped another would leave a counter
    off zero, and every later multi-split call of that (batch, cache head)
    would leave its output unwritten."""
    key = (device.index, stream)
    with _counters_lock:
        have = _counters.get(key)
        if have is None or have.numel() < n:
            have = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
            _counters[key] = have
        return have


def counters_at_rest() -> bool:
    """Whether every arrival counter is back at zero once the card's work so
    far has ended (a counter left off zero would leave later multi-split
    outputs unwritten)."""
    with _counters_lock:
        counters = list(_counters.values())
    if counters:
        torch.cuda.synchronize()
    return all(int(c.abs().sum()) == 0 for c in counters)


def launch(lib, q, k_cache, v_cache, valid, plan: SplitPlan, stream: int,
           k_scale=None, v_scale=None, q_pos=None, k_pos=None, window: int = 0):
    """Launch the kernel on prepared operands; returns [b, H, 1, d]. q is
    contiguous; k/v/valid (and k_scale/v_scale/k_pos where given) need unit
    stride along their slot axis (k/v along d); a [b, C] valid is broadcast
    over the cache heads by a zero stride. An int8 k/v takes k_scale/v_scale;
    ``window`` >= 1 takes q_pos [b] and k_pos."""
    b, H, _, d = q.shape
    ch, C = k_cache.shape[1], k_cache.shape[2]
    group = H // ch
    dev = q.device
    int8 = k_cache.dtype == torch.int8
    bf16 = q.dtype == torch.bfloat16
    n = plan.scratch_floats(b, ch, group, d, bf16)
    scratch = torch.empty(n, dtype=torch.float32, device=dev) if n else None
    counters = (_arrival_counters(dev, stream, b * ch * plan.row_groups)
                if bf16 and plan.splits > 1 else None)
    out = torch.empty((b, H, 1, d), dtype=q.dtype, device=dev)

    def ptr(x):
        return None if x is None else x.data_ptr()

    err = lib.decode_attn(
        build.DTYPES[q.dtype], int(int8), d, q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), ptr(k_scale), ptr(v_scale), valid.data_ptr(), ptr(q_pos),
        ptr(k_pos), ptr(scratch), ptr(counters), out.data_ptr(),
        b, ch, group, C, plan.tiles, plan.splits, window,
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        *_strides(valid), *_strides(k_scale), *_strides(v_scale), *_strides(k_pos),
        d ** -0.5, stream)
    build.check(lib, err, "decode_attn")
    counts = (1, int(int8), int(window > 0))
    if torch.cuda.is_current_stream_capturing():
        with _count_lock:
            held = _captured.setdefault(stream, [0, 0, 0])
            for i, n in enumerate(counts):
                held[i] += n
    else:
        count_launches(*counts)
    return out


def count_launches(n: int, n_int8: int, n_window: int) -> None:
    """Add ``n`` launches to the counts, ``n_int8`` of them over an int8
    cache and ``n_window`` with the window term."""
    global launches, int8_launches, window_launches
    with _count_lock:
        launches += n
        int8_launches += n_int8
        window_launches += n_window


def take_captured(stream: int) -> Tuple[int, int, int]:
    """The (launches, int8, window) counts of the calls captured on
    ``stream`` (a CUDA stream handle) since the last call; a replay of
    their graph launches them again."""
    with _count_lock:
        return tuple(_captured.pop(stream, (0, 0, 0)))


def decode_attention(
    q: torch.Tensor,  # [b, H, 1, d]
    k_cache: torch.Tensor,  # [b, CH, C, d] in q's dtype, or int8
    v_cache: torch.Tensor,  # [b, CH, C, d]
    valid: torch.Tensor,  # [b, C] or [b, CH, C] bool
    q_pos: Optional[torch.Tensor] = None,  # [b] int32, read under a window
    k_pos: Optional[torch.Tensor] = None,  # [b, CH, C] int32, read under a window
    sliding_window: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # [b, CH, C] float32 with an int8 cache
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-token decode attention -> [b, H, 1, d] in q's dtype."""
    b, H, one, d = q.shape
    ch = k_cache.shape[1]
    if one != 1 or H % ch or v_cache.shape != k_cache.shape:
        raise ValueError(
            f"decode_attention: q {tuple(q.shape)}, cache {tuple(k_cache.shape)}")
    int8 = k_cache.dtype == torch.int8
    if int8 != (v_cache.dtype == torch.int8):
        raise TypeError(f"decode_attention: cache dtypes {k_cache.dtype}, {v_cache.dtype}")
    scales = (k_scale is not None, v_scale is not None)
    if int8 and scales != (True, True):
        raise ValueError("decode_attention: an int8 cache needs k_scale and v_scale")
    if not int8 and any(scales):
        raise ValueError("decode_attention: k_scale/v_scale go with an int8 cache")
    if sliding_window is not None:
        if q_pos is None or k_pos is None:
            raise ValueError("decode_attention: sliding_window needs q_pos and k_pos")
        if tuple(q_pos.shape) != (b,) or tuple(k_pos.shape) != tuple(k_cache.shape[:3]):
            raise ValueError(f"decode_attention: q_pos {tuple(q_pos.shape)}, k_pos "
                             f"{tuple(k_pos.shape)} for a cache {tuple(k_cache.shape)}")
        if not 1 <= sliding_window <= MAX_WINDOW:
            raise ValueError(f"decode_attention: sliding_window {sliding_window} is not in "
                             f"[1, {MAX_WINDOW}]")
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, valid, q_pos, k_pos,
                                      sliding_window, k_scale, v_scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"decode_attention: unsupported device {q.device}")
    if d not in HEAD_DIMS:
        raise NotImplementedError(f"decode_attention kernel: head_dim {d} not in {HEAD_DIMS}")
    if q.dtype not in build.DTYPES or not (int8 or q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError(
            f"decode_attention kernel: dtypes {q.dtype}, {k_cache.dtype}, {v_cache.dtype}")
    if valid.dtype != torch.bool or valid.stride(-1) != 1:
        raise ValueError("decode_attention kernel: valid must be bool with unit stride along C")
    if k_cache.stride(3) != 1 or v_cache.stride(3) != 1:
        raise ValueError("decode_attention kernel: cache needs unit stride along head_dim")
    if q.dtype == torch.bfloat16:
        cp_async_strides(k_cache, "k_cache")
        cp_async_strides(v_cache, "v_cache")
    if int8 and (k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32
                 or k_scale.stride(-1) != 1 or v_scale.stride(-1) != 1):
        raise ValueError("decode_attention kernel: scales must be float32 with unit stride "
                         "along C")
    window = 0
    if sliding_window is not None:
        q_pos = q_pos.to(torch.int32).contiguous()
        k_pos = k_pos.to(torch.int32)
        if k_pos.stride(-1) != 1:
            k_pos = k_pos.contiguous()
        window = sliding_window
    else:
        q_pos = k_pos = None
    plan = split_plan(b, ch, H // ch, k_cache.shape[2], build.num_sms(q.device))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return launch(build.load("decode_attn", bind), q.contiguous(), k_cache, v_cache, valid,
                  plan, stream, k_scale if int8 else None, v_scale if int8 else None,
                  q_pos, k_pos, window)
