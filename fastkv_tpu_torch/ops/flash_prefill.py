"""Causal flash-attention prefill, with an optional sliding window: the CUDA
kernel's wrapper and its plain version.

Replaces the TPU kernel ``fastkv_tpu/ops/flash_prefill.py::flash_attention``
(Pallas, ``pallas_call`` at :472) in its causal square form, with and without
its ``sliding_window`` term (:143-144). The kernel is
``fastkv_tpu_torch/kernels/csrc/flash_prefill.cu``: hand-written CUDA C++ for
sm_90a. What bounds it and what its design does about that is written at the
top of that file: it is bound by operations (~5.5e11 FLOP per layer call at
Llama-3.1-8B width and s = 8192; 1.32e13 at Ministral-8B's s = 40960 under
its 32768 window), walks key tiles only up to the diagonal and, under a
window, from the first tile that reaches the band, and in this first version
multiplies on the CUDA cores in float32.

Semantics kept from the TPU kernel:
  * GQA native: query head h reads kv head h // (H / KH), no repeat;
  * causality over the given position ids (pk <= pq), with key validity folded
    into the key positions on the host (slots at or beyond ``count`` get 2^30),
    in plain torch so the CPU tests cover it;
  * under a window W, key j is visible to query i only if pk > pq - W as well;
    the engine passes layout indices as positions then (``engine/prefill.py``
    ``_mask_positions``);
  * a row that sees no key gives 0 (the Pallas pure-causal path left finite
    garbage there; the XLA path and the port write 0).

Positions form an ascending valid prefix and are non-negative; the kernel's
tile skipping relies on it.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises. ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from fastkv_tpu_torch.kernels import build
from fastkv_tpu_torch.ops import attention as att

INVALID_POS = 1 << 30
HEAD_DIMS = (64, 128)
MAX_WINDOW = (1 << 31) - 1  # the kernel takes W as a C int

launches = 0  # kernel launches since the caller last set it to 0


def fold_key_validity(positions: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Key positions with validity folded in: slots at or beyond ``count`` get
    2^30, which the causal compare pk <= pq rejects. [b, s] int32."""
    s = positions.shape[1]
    idx = torch.arange(s, device=positions.device)[None, :]
    return torch.where(idx < count[:, None], positions.to(torch.int32), INVALID_POS).to(torch.int32)


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    positions: torch.Tensor,
    count: torch.Tensor,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same folded mask, float32
    softmax over query blocks, rows that see nothing give 0."""
    k_pos = fold_key_validity(positions, count)
    return att.chunked_causal_attention(
        q, k, v, positions, k_pos, k_pos < INVALID_POS, sliding_window=sliding_window)


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C entry point's signature (csrc/flash_prefill.cu)."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_prefill.argtypes = [i, i] + [p] * 6 + [i] * 5 + [ll] * 9 + [ctypes.c_float, p]
    lib.flash_prefill.restype = ctypes.c_int


def launch(lib, q, k, v, q_pos, k_pos, stream: int, window: int = 0) -> torch.Tensor:
    """Launch the kernel on prepared operands; returns the [b, H, s, d] output.
    q/k/v need unit stride along d; q_pos/k_pos are contiguous int32 [b, s];
    ``window`` is the sliding window W >= 1, or 0 for none.
    The launch is asynchronous; operands may be freed on return, because the
    caching allocator reuses their memory only for work queued after the
    kernel on the same stream."""
    global launches
    b, h, s, d = q.shape
    out = torch.empty((b, h, s, d), dtype=q.dtype, device=q.device)
    err = lib.flash_prefill(
        build.DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        k_pos.data_ptr(), out.data_ptr(), b, h, k.shape[1], s, window,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        d ** -0.5, stream)
    build.check(lib, err, "flash_prefill")
    launches += 1
    return out


def flash_attention(
    q: torch.Tensor,  # [b, H, s, d]
    k: torch.Tensor,  # [b, KH, s, d]
    v: torch.Tensor,  # [b, KH, s, d]
    positions: torch.Tensor,  # [b, s] original positions (ascending valid prefix)
    count: torch.Tensor,  # [b] number of valid tokens
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Causal square prefill attention, under ``sliding_window`` if given ->
    [b, H, s, d] in q's dtype."""
    b, h, s, d = q.shape
    if k.shape[2] != s or v.shape != k.shape or h % k.shape[1]:
        raise NotImplementedError(
            f"flash_attention takes the causal square form only: q {tuple(q.shape)}, "
            f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if sliding_window is not None and not 1 <= sliding_window <= MAX_WINDOW:
        raise ValueError(f"flash_attention: sliding_window {sliding_window} is not in "
                         f"[1, {MAX_WINDOW}]")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, positions, count, sliding_window)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_attention: unsupported device {q.device}")
    if d not in HEAD_DIMS:
        raise NotImplementedError(f"flash_attention kernel: head_dim {d} not in {HEAD_DIMS}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in build.DTYPES:
        raise TypeError(f"flash_attention kernel: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention kernel: q/k/v need unit stride along head_dim")
    q_pos = positions.to(torch.int32).contiguous()
    k_pos = fold_key_validity(positions, count).contiguous()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return launch(build.load("flash_prefill", bind), q, k, v, q_pos, k_pos, stream,
                  sliding_window or 0)
