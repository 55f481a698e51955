"""A decode layer's attention prologue: the CUDA kernel's wrapper and its
plain versions.

Between a decode layer's q/k/v projections and its attention call, the new
token is turned by RoPE at its position and its cache row is written at
its slot. As PyTorch operations that is ~25 (Llama, Mistral) to ~37
(DeepSeek-V2) launches a layer of a few KB each; the kernel,
``fastkv_tpu_torch/kernels/csrc/decode_prologue.cu``, is one. It replaces no
TPU kernel (XLA fuses this step for the JAX package). Two forms:

  * ``rope_append`` (``models.llama``): q turned in place (rotate-half), k
    turned, k and v written into the cache at each row's slot, each kv head
    repeated into CH / KH consecutive cache heads;
  * ``latent_prologue`` (``models.deepseek_v2``): the rope part of q turned
    in place (HF's pair layout), the latent RMS-normalised into the ``k``
    plane and the shared rope key turned into the ``v`` plane.

Both compute cos/sin on the device from ``pos`` and ``inv_freq``, so a call
needs nothing from the host and is captured into the decode step's CUDA
graph. The arithmetic is the plain version's, rounded where PyTorch rounds,
so the RoPE and the appends are bit for bit equal to it; the latent's norm
sums in another order (within a bf16 ulp).

On a CPU tensor a form runs its plain version (the composition the decode
step ran before the kernel); on a CUDA tensor it launches the kernel or
raises. ``launches`` counts calls that launched it, under a lock; a call
captured into a CUDA graph is held per stream (``take_captured``) and
counted on each replay (``count_launches``), as ``ops.decode_attn`` does.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch

from fastkv_tpu_torch.cache.kv_cache import Slot, write_slot
from fastkv_tpu_torch.kernels import build
from fastkv_tpu_torch.models.rope import apply_rope, apply_rope_pairs, rope_cos_sin
from fastkv_tpu_torch.ops.add_rms_norm import rms_norm_plain

MAX_ROPE = 256  # the latent form's rope width (csrc/decode_prologue.cu kMaxRope)

launches = 0  # kernel launches since the caller last set it to 0

_count_lock = threading.Lock()  # held while a launch adds to the count
_captured: Dict[int, int] = {}  # stream -> calls captured on it since take_captured


def rope_append_plain(q, k, v, pos, inv_freq, k_cache, v_cache, slot: Slot,
                      rows=None) -> torch.Tensor:
    """Plain version of ``rope_append``."""
    cos, sin = rope_cos_sin(pos[:, None], inv_freq)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    g = k_cache.shape[1] // k.shape[1]
    if g > 1:  # a per-query-head cache (SnapKV's methods)
        k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    write_slot(k_cache, k[:, :, 0], slot, rows)
    write_slot(v_cache, v[:, :, 0], slot, rows)
    return q


def latent_prologue_plain(q, kv_a, kv_norm, pos, inv_freq, k_cache, v_cache, slot: Slot,
                          rows=None, *, eps: float, mscale: float) -> torch.Tensor:
    """Plain version of ``latent_prologue``."""
    R, r = k_cache.shape[3], v_cache.shape[3]
    cos, sin = rope_cos_sin(pos[:, None], inv_freq)
    if mscale != 1.0:
        cos, sin = cos * mscale, sin * mscale
    write_slot(k_cache, rms_norm_plain(kv_a[..., :R], kv_norm, eps), slot, rows)
    write_slot(v_cache, apply_rope_pairs(kv_a[..., None, R:].transpose(1, 2), cos, sin)[:, :, 0],
               slot, rows)
    n = q.shape[-1] - r
    return torch.cat([q[..., :n], apply_rope_pairs(q[..., n:], cos, sin)], dim=-1)


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C entry points' signatures (csrc/decode_prologue.cu)."""
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.rope_append.argtypes = [i] + [p] * 5 + [ll, p, p, p] + [i] * 6 + [ll] * 12 + [p]
    lib.rope_append.restype = i
    lib.latent_prologue.argtypes = ([i] + [p] * 5 + [ll, p, p, p] + [i] * 6 + [ll] * 7
                                    + [f, f, p])
    lib.latent_prologue.restype = i


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, dims: int) -> None:
    if x.dim() != dims or x.dtype != dtype or x.stride(-1) != 1:
        raise ValueError(f"decode_prologue kernel: {name} {tuple(x.shape)} {x.dtype} (stride "
                         f"{x.stride()}); wants {dims} dims of {dtype}, unit stride last")


def _device_inputs(q, pos, inv_freq, k_cache, v_cache, slot: Slot, rope: int):
    """Checks shared by both forms -> (pos int32, slots int64 or None, the int
    slot, inv_freq float32), each contiguous."""
    if q.dtype not in build.DTYPES:
        raise TypeError(f"decode_prologue kernel: dtype {q.dtype}")
    b = q.shape[0]
    _check("q", q, q.dtype, 4)
    _check("k_cache", k_cache, q.dtype, 4)
    _check("v_cache", v_cache, q.dtype, 4)
    if q.shape[2] != 1 or k_cache.shape[:3] != v_cache.shape[:3] or k_cache.shape[0] != b:
        raise ValueError(f"decode_prologue kernel: q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    if tuple(pos.shape) != (b,) or inv_freq.numel() * 2 != rope:
        raise ValueError(f"decode_prologue kernel: pos {tuple(pos.shape)}, inv_freq "
                         f"{tuple(inv_freq.shape)} for {b} rows of rope width {rope}")
    pos = pos.to(torch.int32).contiguous()
    inv_freq = inv_freq.to(torch.float32).contiguous()
    if isinstance(slot, int):
        if not 0 <= slot < k_cache.shape[2]:
            raise ValueError(f"decode_prologue kernel: slot {slot} outside the cache's "
                             f"{k_cache.shape[2]} slots")
        return pos, None, slot, inv_freq
    if tuple(slot.shape) != (b,):
        raise ValueError(f"decode_prologue kernel: slots {tuple(slot.shape)} for {b} rows")
    return pos, slot.to(torch.long).contiguous(), 0, inv_freq


def _counted(stream: int) -> None:
    if torch.cuda.is_current_stream_capturing():
        with _count_lock:
            _captured[stream] = _captured.get(stream, 0) + 1
    else:
        count_launches(1)


def count_launches(n: int) -> None:
    """Add ``n`` launches to the count."""
    global launches
    with _count_lock:
        launches += n


def take_captured(stream: int) -> int:
    """The launches captured on ``stream`` (a CUDA stream handle) since the
    last call; a replay of their graph launches them again."""
    with _count_lock:
        return _captured.pop(stream, 0)


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def rope_append(
    q: torch.Tensor,  # [b, H, 1, d] pre-RoPE, turned in place on the card
    k: torch.Tensor,  # [b, KH, 1, d] pre-RoPE
    v: torch.Tensor,  # [b, KH, 1, d]
    pos: torch.Tensor,  # [b] int32: each row's original position
    inv_freq: torch.Tensor,  # [d/2] float32
    k_cache: torch.Tensor,  # [b, CH, C, d] one layer's planes, CH a multiple of KH
    v_cache: torch.Tensor,
    slot: Slot,  # one int, or a [b] tensor of one slot per row
    rows: Optional[torch.Tensor] = None,  # arange(b) for the plain version's per-row write
) -> torch.Tensor:
    """The Llama/Mistral prologue: -> q roped [b, H, 1, d]; k roped and v
    written into the cache at each row's slot."""
    if q.device.type == "cpu":
        return rope_append_plain(q, k, v, pos, inv_freq, k_cache, v_cache, slot, rows)
    if q.device.type != "cuda":
        raise RuntimeError(f"rope_append: unsupported device {q.device}")
    b, H, _, d = q.shape
    KH, CH = k.shape[1], k_cache.shape[1]
    pos, slots, slot0, inv_freq = _device_inputs(q, pos, inv_freq, k_cache, v_cache, slot, d)
    _check("k", k, q.dtype, 4)
    _check("v", v, q.dtype, 4)
    if (k.shape != v.shape or tuple(k.shape) != (b, KH, 1, d) or CH % KH
            or k_cache.shape[3] != d or v_cache.shape[3] != d):
        raise ValueError(f"rope_append kernel: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, cache {tuple(k_cache.shape)}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = build.load("decode_prologue", bind)
    err = lib.rope_append(
        build.DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        _ptr(slots), slot0, inv_freq.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        b, H, KH, CH, k_cache.shape[2], d, q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), *k_cache.stride()[:3], *v_cache.stride()[:3], stream)
    build.check(lib, err, "rope_append")
    _counted(stream)
    return q


def latent_prologue(
    q: torch.Tensor,  # [b, H, 1, n + r]: its rope part (the last r) turned in place on the card
    kv_a: torch.Tensor,  # [b, 1, R + r]: the latent, then the shared rope key, pre-norm/RoPE
    kv_norm: torch.Tensor,  # [R] float32
    pos: torch.Tensor,  # [b] int32
    inv_freq: torch.Tensor,  # [r/2] float32
    k_cache: torch.Tensor,  # [b, 1, C, R] the layer's latents (one cache head)
    v_cache: torch.Tensor,  # [b, 1, C, r] the layer's roped keys
    slot: Slot,
    rows: Optional[torch.Tensor] = None,
    *,
    eps: float,  # the latent norm's
    mscale: float,  # YaRN's ratio on cos/sin (``models.deepseek_v2.rope_mscale``)
) -> torch.Tensor:
    """The DeepSeek-V2 prologue: -> q with its rope part turned [b, H, 1,
    n + r]; the normed latent and the roped key written into the cache at
    each row's slot."""
    if k_cache.shape[1] != 1 or v_cache.shape[1] != 1:
        raise ValueError(f"latent_prologue: the latent cache has one head, not "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    if q.device.type == "cpu":
        return latent_prologue_plain(q, kv_a, kv_norm, pos, inv_freq, k_cache, v_cache, slot,
                                     rows, eps=eps, mscale=mscale)
    if q.device.type != "cuda":
        raise RuntimeError(f"latent_prologue: unsupported device {q.device}")
    b, H, _, qk = q.shape
    R, r = k_cache.shape[3], v_cache.shape[3]
    pos, slots, slot0, inv_freq = _device_inputs(q, pos, inv_freq, k_cache, v_cache, slot, r)
    _check("kv_a", kv_a, q.dtype, 3)
    _check("kv_norm", kv_norm, torch.float32, 1)
    if (tuple(kv_a.shape) != (b, 1, R + r) or tuple(kv_norm.shape) != (R,) or r > qk
            or r > MAX_ROPE):
        raise ValueError(f"latent_prologue kernel: q {tuple(q.shape)}, kv_a "
                         f"{tuple(kv_a.shape)}, kv_norm {tuple(kv_norm.shape)}, cache planes "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    lib = build.load("decode_prologue", bind)
    err = lib.latent_prologue(
        build.DTYPES[q.dtype], q.data_ptr(), kv_a.data_ptr(), kv_norm.data_ptr(),
        pos.data_ptr(), _ptr(slots), slot0, inv_freq.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), b, H, k_cache.shape[2], qk - r, r, R, q.stride(0), q.stride(1),
        kv_a.stride(0), k_cache.stride(0), k_cache.stride(2), v_cache.stride(0),
        v_cache.stride(2), eps, mscale, stream)
    build.check(lib, err, "latent_prologue")
    _counted(stream)
    return q
