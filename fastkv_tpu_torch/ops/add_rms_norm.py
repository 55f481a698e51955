"""A decode step's residual add and RMSNorm: the CUDA kernel's wrapper and its
plain versions.

A decode layer normalises its hidden state twice: before the attention, and
after the attention's residual add, before the MLP. As PyTorch operations a
norm is 8 launches in bf16 (the float32 upcast, square, mean, + eps, rsqrt,
two products, the cast back) and the add one more, each a few KB; the
kernel, ``fastkv_tpu_torch/kernels/csrc/add_rms_norm.cu``, takes a norm site
in one launch. It replaces no TPU kernel (XLA fuses this step for the JAX
package). Two forms over x [b, 1, D], contiguous, bf16 or float32, with a
float32 weight [D]:

  * ``rms_norm(x, w, eps)`` -> the normed x;
  * ``add_rms_norm(h, delta, w, eps)`` -> (h + delta, its normed copy).

The arithmetic is the plain version's, rounded where PyTorch rounds, so the
new residual is bit for bit ``h + delta``; the norm sums its squares in
another order (within a bf16 ulp).

``rms_norm_plain`` is the model's RMSNorm (``models.llama.rms_norm`` is this
function): prefill and the LM head take it on every device. On a CPU tensor a
form runs its plain version; on a CUDA tensor it launches the kernel or
raises. ``launches`` counts calls that launched it, under a lock; a call
captured into a CUDA graph is held per stream (``take_captured``) and
counted on each replay (``count_launches``), as ``ops.decode_prologue`` does.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from fastkv_tpu_torch.kernels import build

MAX_ROW_BYTES = 32768  # the widest row a call takes (csrc/add_rms_norm.cu: 512 x 4 x 16)

launches = 0  # kernel launches since the caller last set it to 0

_count_lock = threading.Lock()  # held while a launch adds to the count
_captured: Dict[int, int] = {}  # stream -> calls captured on it since take_captured


def rms_norm_plain(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last dim, in float32, cast back to x's dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * w.to(torch.float32)).to(x.dtype)


def add_rms_norm_plain(h: torch.Tensor, delta: torch.Tensor, w: torch.Tensor,
                       eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of ``add_rms_norm``."""
    h = h + delta
    return h, rms_norm_plain(h, w, eps)


def bind(lib: ctypes.CDLL) -> None:
    """Declare the C entry point's signature (csrc/add_rms_norm.cu)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.add_rms_norm.argtypes = [i] + [p] * 5 + [i, i, ctypes.c_float, p]
    lib.add_rms_norm.restype = i


def _check(name: str, x: torch.Tensor, shape, dtype: torch.dtype, device) -> None:
    if (tuple(x.shape) != tuple(shape) or x.dtype != dtype or x.device != device
            or not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(f"add_rms_norm kernel: {name} {tuple(x.shape)} {x.dtype} on {x.device} "
                         f"(stride {x.stride()}); wants {tuple(shape)} {dtype} on {device}, "
                         f"contiguous and 16-byte aligned")


def _launch(x: torch.Tensor, delta: Optional[torch.Tensor], w: torch.Tensor,
            eps: float) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """-> (x + delta, or None without delta; the normed row)."""
    if x.dtype not in build.DTYPES:
        raise TypeError(f"add_rms_norm kernel: dtype {x.dtype}")
    if x.dim() != 3 or x.shape[1] != 1:
        raise ValueError(f"add_rms_norm kernel: x {tuple(x.shape)}; wants [b, 1, D]")
    b, _, D = x.shape
    _check("x", x, x.shape, x.dtype, x.device)
    if delta is not None:
        _check("delta", delta, x.shape, x.dtype, x.device)
    _check("w", w, (D,), torch.float32, x.device)
    if D * x.element_size() > MAX_ROW_BYTES or D * x.element_size() % 16:
        raise ValueError(f"add_rms_norm kernel: a row of {D} x {x.dtype} is not a multiple of "
                         f"16 bytes up to {MAX_ROW_BYTES}")
    out = torch.empty_like(x)
    h = None if delta is None else torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = build.load("add_rms_norm", bind)
    err = lib.add_rms_norm(build.DTYPES[x.dtype], x.data_ptr(),
                           None if delta is None else delta.data_ptr(), w.data_ptr(),
                           None if h is None else h.data_ptr(), out.data_ptr(), b, D, eps,
                           stream)
    build.check(lib, err, "add_rms_norm")
    if torch.cuda.is_current_stream_capturing():
        with _count_lock:
            _captured[stream] = _captured.get(stream, 0) + 1
    else:
        count_launches(1)
    return h, out


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


def _device(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one."""
    if x.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{what}: unsupported device {x.device}")
    return x.device.type == "cuda"


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x [b, 1, D] -> its RMSNorm with weight w [D] float32."""
    if not _device(x, "rms_norm"):
        return rms_norm_plain(x, w, eps)
    return _launch(x, None, w, eps)[1]


def add_rms_norm(h: torch.Tensor, delta: torch.Tensor, w: torch.Tensor,
                 eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """h, delta [b, 1, D] -> (h + delta, its RMSNorm with weight w [D] float32)."""
    if not _device(h, "add_rms_norm"):
        return add_rms_norm_plain(h, delta, w, eps)
    return _launch(h, delta, w, eps)
