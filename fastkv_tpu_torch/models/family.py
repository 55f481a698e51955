"""The per-family seam, where the engine picks a model family's layer code,
and the decoder layer: once for prefill, once for decode.

``of(cfg)`` gives the module whose functions run a layer of ``cfg``'s
family (``cfg.kind``): ``models.llama`` (the Llama and Mistral families:
GQA, a SwiGLU MLP, a K and a V row a kv head in the cache) or
``models.deepseek_v2`` (latent attention with one latent cache head,
experts). The engine and ``core.weights`` ask only these of it; every
engine loop runs its layers through the two layer functions here:

  * ``CHUNKED_ADMISSION``: whether the Scheduler may admit a prompt chunk
    by chunk (``engine.chunked.supported``);
  * ``READS_CHECKPOINTS``: whether ``core.weights`` reads its HF weights;
  * ``cache_dims(cfg)``: the widths of a cache row's ``k`` and ``v`` planes;
  * ``check(cfg, mcfg, ecfg, params, mesh, pcfg)``: raise on what the
    family's path does not run;
  * ``layer_params(params, l)``: layer ``l``'s weights.

They call the family's ``prefill_attention``, ``ffn``, ``decode_qkv``,
``decode_attention`` and ``decode_ffn``; prefill takes ``models.llama``'s
norm, decode ``ops.add_rms_norm``'s forms (the same arithmetic on the CPU).
"""

from __future__ import annotations

from types import ModuleType
from typing import Any, Callable, Dict, Optional

import torch

from fastkv_tpu_torch.core.config import ModelConfig
from fastkv_tpu_torch.models import deepseek_v2, llama
from fastkv_tpu_torch.models.rope import inv_freq_on
from fastkv_tpu_torch.ops import add_rms_norm
from fastkv_tpu_torch.utils import guards

FAMILIES = {"llama": llama, "deepseek_v2": deepseek_v2}


def of(cfg: ModelConfig) -> ModuleType:
    """The layer code of ``cfg``'s family."""
    return FAMILIES[cfg.kind]


def prefill_layer(lp: Dict[str, Any], cfg: ModelConfig, h: torch.Tensor,
                  positions: torch.Tensor, attend: Callable, layer: int, *, mlp_chunk: int = 0,
                  tp=None, valid: Optional[torch.Tensor] = None):
    """One prefill layer over h [b, s, D] (RoPE at the original ``positions``):
    RMSNorm, the family's attention with ``attend(q, k, v)`` -> (out, score
    context), out-projection and residual, RMSNorm, the family's ``ffn`` and
    residual -> (h, score context, q, k, the cache row's k and v planes). An
    ``attend`` whose out is None ends the layer there, h None."""
    fam = of(cfg)
    hn = llama.rms_norm(h, lp["ln_attn"], cfg.rms_norm_eps)
    attn, ctx, q, k, ck, cv = fam.prefill_attention(lp, cfg, hn, positions,
                                                    inv_freq_on(cfg, h.device), attend, layer)
    if attn is None:
        return None, ctx, q, k, ck, cv
    h = h + llama.attn_out_proj(lp, attn, tp)
    h = h + fam.ffn(lp, cfg, llama.rms_norm(h, lp["ln_mlp"], cfg.rms_norm_eps),
                    chunk=mlp_chunk, tp=tp, valid=valid, layer=layer)
    guards.finite("hidden states", h)
    return h, ctx, q, k, ck, cv


def decode_layer(lp: Dict[str, Any], cfg: ModelConfig, h: torch.Tensor, pos: torch.Tensor,
                 inv_freq: torch.Tensor, cache, i: int, slot, rows=None, *,
                 mask: Optional[torch.Tensor] = None, attend: Optional[Callable] = None,
                 tp=None):
    """One decode layer over h [b, 1, D] at positions pos [b], on layer ``i`` of
    ``cache``: RMSNorm, the family's ``decode_qkv`` (the new row written at
    ``slot``), attention, out-projection and residual, RMSNorm, the family's
    ``decode_ffn`` and residual -> (h, aux). The attention is ``attend(q)`` ->
    (out, aux) if given, else the family's over the slots ``mask`` shows. The
    norms, the second with the residual add before it, are
    ``ops.add_rms_norm``'s: one launch each on the card."""
    fam = of(cfg)
    hn = add_rms_norm.rms_norm(h, lp["ln_attn"], cfg.rms_norm_eps)
    q = fam.decode_qkv(lp, cfg, hn, pos, inv_freq, cache, i, slot, rows)
    if attend is None:
        attn, aux = fam.decode_attention(lp, cfg, q, cache, i, mask), None
    else:
        attn, aux = attend(q)
    h, hn = add_rms_norm.add_rms_norm(h, llama.attn_out_proj(lp, attn, tp), lp["ln_mlp"],
                                      cfg.rms_norm_eps)
    h = h + fam.decode_ffn(lp, cfg, hn, tp)
    guards.finite("hidden states", h)
    return h, aux
