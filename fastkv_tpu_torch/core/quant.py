"""Int8 quantization: weight-only absmax int8 and the int8 KV cache.

Port of ``fastkv_tpu.core.quant``. The arithmetic runs in float32, and
``torch.round`` rounds half to even as ``jnp.round`` does, so the int8 values
equal the JAX package's.

  * Weights: per-output-channel symmetric scales, ``w_i8 = round(w / s)`` with
    ``s = absmax / 127`` over the contraction axis; the embedding table per
    row, which is also per output channel of a tied LM head. A quantized
    weight gets a float32 ``<name>_scale`` sibling, which ``models.llama``
    reads.
  * KV cache: one scale per (head, slot) over head_dim; the decode kernel
    folds K's scales into the logits and V's into the probabilities.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

# weights quantized per layer-stack entry: [L, in, out] -> scale [L, 1, out]
LAYER_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def absmax_quantize(w: torch.Tensor, axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization along ``axis``. Returns (w int8, scale
    float32 shaped like w but of size 1 on ``axis``)."""
    wf = w.to(torch.float32)
    a = wf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp(a, min=1e-12) / 127.0
    wi = torch.clamp(torch.round(wf / scale), -127, 127)
    return wi.to(torch.int8), scale


def quantize_params_int8(params: Dict[str, Any]) -> Dict[str, Any]:
    """Weight-only int8 of a ``models.llama`` params tree: each quantized
    weight gets a ``<name>_scale`` sibling; norms stay float32. A layer stack
    is quantized one layer at a time, so the float32 transient is one
    layer's weight."""
    out = dict(params)
    layers = dict(params["layers"])
    for name in LAYER_WEIGHTS:
        w = layers[name]
        wi = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        sc = torch.empty((w.shape[0], 1, w.shape[2]), dtype=torch.float32, device=w.device)
        for l in range(w.shape[0]):
            wi[l], sc[l] = absmax_quantize(w[l], axis=0)  # contraction = "in"
        layers[name], layers[name + "_scale"] = wi, sc
    out["layers"] = layers
    if "lm_head" in params:
        out["lm_head"], out["lm_head_scale"] = absmax_quantize(params["lm_head"], axis=0)
    out["embed"], out["embed_scale"] = absmax_quantize(params["embed"], axis=1)
    return out


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize K or V entries per (..., slot) over head_dim.

    x [..., C, d] -> (int8 of the same shape, scale float32 [..., C])."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-12) / 127.0
    xi = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return xi.to(torch.int8), scale
