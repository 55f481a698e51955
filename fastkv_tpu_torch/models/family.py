"""The per-family seam: the one place the engine picks a model family's
layer code.

``of(cfg)`` gives the module whose functions run a layer of ``cfg``'s
family (``cfg.kind``): ``models.llama`` (the Llama and Mistral families:
GQA, a SwiGLU MLP, a K and a V row a kv head in the cache) or
``models.deepseek_v2`` (latent attention with one latent cache head,
experts). The engine (``engine.prefill``, ``engine.decode``,
``engine.generate``, ``engine.scheduler``, ``engine.chunked``) and
``core.weights`` ask only these of it:

  * ``CHUNKED_ADMISSION``: whether the Scheduler may admit a prompt chunk
    by chunk (``engine.chunked.supported``);
  * ``READS_CHECKPOINTS``: whether ``core.weights`` reads its HF weights;
  * ``cache_dims(cfg)``: the widths of a cache row's ``k`` and ``v`` planes;
  * ``check(cfg, mcfg, ecfg, params, mesh, pcfg)``: raise on what the
    family's path does not run;
  * ``layer_params(params, l)``: layer ``l``'s weights;
  * ``prefill_attention(lp, cfg, hn, positions, inv_freq, attend, layer)``:
    projections, RoPE and the flash call ``attend`` -> (out, score context,
    q, k for the window scores, the cache row's k and v planes);
  * ``ffn(lp, cfg, x, chunk, tp, valid, layer)``: a prefill layer's MLP;
  * ``decode_qkv(lp, cfg, hn, pos, inv_freq, cache, i, slot, rows)``: a
    decode step's q, the new cache row written into layer ``i`` at
    ``slot`` (``ops.decode_prologue``);
  * ``decode_attention(lp, cfg, q, k_cache, v_cache, attend, **scales)``;
  * ``decode_ffn(lp, cfg, x, tp)``.

Embedding, the LM head and the norms are the same in both
(``models.llama``).
"""

from __future__ import annotations

from types import ModuleType

from fastkv_tpu_torch.core.config import ModelConfig
from fastkv_tpu_torch.models import deepseek_v2, llama


FAMILIES = {"llama": llama, "deepseek_v2": deepseek_v2}


def of(cfg: ModelConfig) -> ModuleType:
    """The layer code of ``cfg``'s family."""
    return FAMILIES[cfg.kind]
