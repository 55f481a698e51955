"""Llama family forward blocks on plain tensors.

Port of ``fastkv_tpu.models.llama``. Parameters keep the JAX package's layout:
a dict whose per-layer weights are stacked on a leading [num_layers] axis and
stored [in, out], so the forward is ``x @ W``. A layer's weights are views
``stack[l]`` (no copy). Weights live in the model dtype (bf16 on the card), or
as int8 with float32 ``_scale`` siblings (``core.quant``); norms, RoPE and
logits run in float32. The large matrix products stay ``torch.matmul``.

The names at the end of this module (``CHUNKED_ADMISSION`` to
``decode_ffn``) are this family's side of ``models.family``'s seam,
``models.deepseek_v2`` the other; the norms, the out-projection, ``embed``
and ``unembed`` serve both.

Under tensor parallelism a rank holds its slice of each weight
(``parallel.sharding``): ``qkv_proj`` reads its head counts from the weights'
shapes, the row-parallel products (``attn_out_proj``, ``ffn``) end with
the sum over the model group ``tp`` (``parallel.comm.all_sum``: the same bits on
every rank), and an untied head's logits are its vocabulary slice's,
gathered over ``tp``. The group is an argument: None (one device) sums
nothing.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from fastkv_tpu_torch.cache.kv_cache import write_slot
from fastkv_tpu_torch.core import quant
from fastkv_tpu_torch.core.config import ModelConfig
from fastkv_tpu_torch.core.device import resolve_device, torch_dtype
from fastkv_tpu_torch.models.rope import apply_rope, rope_cos_sin
from fastkv_tpu_torch.ops import add_rms_norm, decode_attn, decode_prologue
from fastkv_tpu_torch.parallel import comm
from fastkv_tpu_torch.utils import guards

Params = Dict[str, Any]


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    L, D, F_ = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    H, KH, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {
        "embed": (cfg.vocab_size, D),
        "final_norm": (D,),
        "layers.wq": (L, D, H * dh),
        "layers.wk": (L, D, KH * dh),
        "layers.wv": (L, D, KH * dh),
        "layers.wo": (L, H * dh, D),
        "layers.w_gate": (L, D, F_),
        "layers.w_up": (L, D, F_),
        "layers.w_down": (L, F_, D),
        "layers.ln_attn": (L, D),
        "layers.ln_mlp": (L, D),
    }
    if not cfg.tie_word_embeddings:
        shapes["lm_head"] = (D, cfg.vocab_size)
    return shapes


def is_norm(name: str) -> bool:
    return name.endswith("norm") or "ln_" in name


def unflatten(flat: Dict[str, torch.Tensor]) -> Params:
    params: Params = {"layers": {}}
    for k, v in flat.items():
        if k.startswith("layers."):
            params["layers"][k[len("layers."):]] = v
        else:
            params[k] = v
    return params


def init_params(
    cfg: ModelConfig,
    generator: Optional[torch.Generator] = None,
    device="cuda",
    dtype=None,
) -> Params:
    """Random-normal weights (std 0.02, norms 1) made directly on ``device``.

    Each tensor is filled in place in its storage dtype, so an 8B model on the
    card never holds a float32 copy. ``generator`` must live on ``device``;
    by default one seeded with 0 is made there.
    """
    dev = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    flat = {}
    for k, shp in param_shapes(cfg).items():
        if is_norm(k):
            flat[k] = torch.ones(shp, dtype=torch.float32, device=dev)
        else:
            flat[k] = torch.empty(shp, dtype=dtype, device=dev).normal_(
                0.0, 0.02, generator=generator)
    return unflatten(flat)


def init_params_int8(
    cfg: ModelConfig,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> Params:
    """Random-normal weights (std 0.02, norms 1) made directly in the int8
    weight-only format of ``core.quant.quantize_params_int8`` on ``device``:
    each layer's weight is drawn in float32 and quantized on its own, so the
    float32 transient is one layer's weight (235 MB for Llama-3.1-8B's
    ``w_gate``), never a whole stack. The counterpart of the JAX package's
    ``init_params_int8_on_device``; ``generator`` must live on ``device``."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def draw(shp):
        return torch.empty(shp, dtype=torch.float32, device=dev).normal_(
            0.0, 0.02, generator=generator)

    flat = {}
    for k, shp in param_shapes(cfg).items():
        if is_norm(k):
            flat[k] = torch.ones(shp, dtype=torch.float32, device=dev)
        elif k.startswith("layers."):
            wi = torch.empty(shp, dtype=torch.int8, device=dev)
            sc = torch.empty((shp[0], 1, shp[2]), dtype=torch.float32, device=dev)
            for l in range(shp[0]):
                wi[l], sc[l] = quant.absmax_quantize(draw(shp[1:]), axis=0)
            flat[k], flat[k + "_scale"] = wi, sc
        elif k == "lm_head":
            flat[k], flat[k + "_scale"] = quant.absmax_quantize(draw(shp), axis=0)
        else:  # the embedding table, per row
            flat[k], flat[k + "_scale"] = quant.absmax_quantize(draw(shp), axis=1)
    return unflatten(flat)


def params_from_numpy(cfg: ModelConfig, tree: Params, device="cuda", dtype=None) -> Params:
    """Carry a params tree of numpy arrays (the JAX package's layout, e.g. after
    ``jax.tree_util.tree_map(np.asarray, params)``) over to the port's tensors.
    Norms stay float32; int8 weights stay int8 with their float32 ``_scale``
    siblings (a ``quantize_params_int8`` tree); every other weight takes
    ``dtype`` (default cfg.dtype)."""
    dev = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)
    flat = {}
    for k in param_shapes(cfg):
        for name in (k, k + "_scale"):
            sub = tree["layers"] if name.startswith("layers.") else tree
            key = name[len("layers."):] if name.startswith("layers.") else name
            if key not in sub:
                continue  # a weight without a scale sibling
            arr = np.asarray(sub[key])
            if arr.dtype == np.int8:
                flat[name] = torch.from_numpy(arr.copy()).to(dev)
                continue
            t = torch.from_numpy(np.array(arr, dtype=np.float32))
            keep_f32 = is_norm(name) or name.endswith("_scale")
            flat[name] = t.to(device=dev, dtype=torch.float32 if keep_f32 else dtype)
    return unflatten(flat)


def layer_params(params: Params, l: int) -> Params:
    """Views of layer ``l``'s weights."""
    return {k: v[l] for k, v in params["layers"].items()}


# ---------------------------------------------------------------------------
# Forward building blocks
# ---------------------------------------------------------------------------

# every prefill's norm and the LM head's; a decode layer's run through the
# kernel on the card (``models.family.decode_layer``)
rms_norm = add_rms_norm.rms_norm_plain


def linear(lp: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """x @ lp[name]. An int8 weight (a ``<name>_scale`` sibling holds its
    per-column float32 scales) is multiplied as a copy of this one layer's
    weight in x's dtype, and the product is scaled per column in float32,
    then cast back to x's dtype. cuBLAS sums a bf16 product in float32 but
    rounds it to bf16 before the scale: one rounding more than the JAX
    package's float32 product; a float32 x takes none."""
    w = lp[name]
    s = lp.get(name + "_scale")
    if s is None:
        return x @ w
    return ((x @ w.to(x.dtype)).to(torch.float32) * s).to(x.dtype)


def qkv_proj(lp: Params, cfg: ModelConfig, h_normed: torch.Tensor):
    """h_normed [b, s, D] -> q [b, H, s, d], k/v [b, KH, s, d] (pre-RoPE);
    H and KH are the heads the weights hold (a tensor-parallel rank's
    share), d is ``cfg.head_dim``."""
    b, s, _ = h_normed.shape
    d = cfg.head_dim
    q = linear(lp, "wq", h_normed).view(b, s, lp["wq"].shape[-1] // d, d)
    k = linear(lp, "wk", h_normed).view(b, s, lp["wk"].shape[-1] // d, d)
    v = linear(lp, "wv", h_normed).view(b, s, lp["wv"].shape[-1] // d, d)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def tp_sum(x: torch.Tensor, tp) -> torch.Tensor:
    """A row-parallel partial product summed over the model group ``tp``
    (``comm.all_sum``); ``x`` itself without one."""
    return x if tp is None else comm.all_sum(x, tp)


def mlp(lp: Params, x: torch.Tensor, chunk: int = 0) -> torch.Tensor:
    """Gated SiLU MLP. With ``chunk`` > 0 and s a multiple of it, the same
    function runs over sequence slices of ``chunk`` tokens, each written into
    one preallocated [b, s, D] output, so the [s, intermediate] gate and up
    activations exist one slice at a time (pure sequence tiling). Under
    tensor parallelism the rank's MLP columns give a partial product, which
    the caller sums over the model group once (``ffn``, ``decode_ffn``)."""
    b, s, _ = x.shape
    if chunk and s > chunk and s % chunk == 0:
        out = x.new_empty((b, s, lp["w_down"].shape[-1]))
        for start in range(0, s, chunk):
            out[:, start:start + chunk] = mlp(lp, x[:, start:start + chunk])
        return out
    gate = linear(lp, "w_gate", x)
    up = linear(lp, "w_up", x)
    return linear(lp, "w_down", F.silu(gate) * up)


def attn_out_proj(lp: Params, attn: torch.Tensor, tp=None) -> torch.Tensor:
    """attn [b, H, s, d] -> [b, s, D]; under tensor parallelism the rank's
    heads give a partial product, summed over ``tp``."""
    b, H, s, d = attn.shape
    return tp_sum(linear(lp, "wo", attn.transpose(1, 2).reshape(b, s, H * d)), tp)


def embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    idx = tokens.long()
    rows = params["embed"][idx]
    s = params.get("embed_scale")
    if s is None:
        return rows
    # an int8 table: each row times its own scale
    return (rows.to(torch.float32) * s[idx]).to(torch_dtype(cfg.dtype))


def unembed(params: Params, cfg: ModelConfig, h: torch.Tensor, tp=None) -> torch.Tensor:
    """Final norm + LM head. h [b, s, D] -> logits [b, s, V] float32. An int8
    head (tied: the embedding table) is copied to h's dtype for the product,
    which is then scaled per vocabulary entry. A tied head is replicated
    (every rank computes the whole logits); an untied one under tensor
    parallelism holds the rank's vocabulary slice, whose logits are gathered
    over ``tp`` in vocabulary order."""
    h = rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    if cfg.tie_word_embeddings:
        w, s = params["embed"], params.get("embed_scale")
        y = (h @ w.to(h.dtype).T).to(torch.float32)
        return y * s[:, 0] if s is not None else y
    w, s = params["lm_head"], params.get("lm_head_scale")
    y = (h @ w.to(h.dtype)).to(torch.float32)
    y = y * s[0] if s is not None else y
    return y if tp is None else comm.all_gather(y, tp, dim=-1)


def rope_qk(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor):
    cos, sin = rope_cos_sin(positions, inv_freq)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin)


# ---------------------------------------------------------------------------
# The family seam (``models.family``)
# ---------------------------------------------------------------------------

CHUNKED_ADMISSION = True
READS_CHECKPOINTS = True


def cache_dims(cfg: ModelConfig) -> Tuple[int, int]:
    """A cache row's k and v widths: head_dim each."""
    return cfg.head_dim, cfg.head_dim


def check(cfg: ModelConfig, mcfg, ecfg, params: Params, mesh=None, pcfg=None) -> None:
    """The Llama and Mistral families run every method, mesh and int8 form:
    nothing to refuse."""


def prefill_attention(lp: Params, cfg: ModelConfig, hn: torch.Tensor, positions: torch.Tensor,
                      inv_freq: torch.Tensor, attend, layer: int):
    """One layer's prefill attention: q/k/v, RoPE, ``attend(q, k, v)`` ->
    (out, score context) -> (out, the score context, q, k, and the cache
    row's planes: k and v)."""
    q, k, v = qkv_proj(lp, cfg, hn)
    guards.finite("q/k/v", q, k, v)
    q, k = rope_qk(q, k, positions, inv_freq)
    out, ctx = attend(q, k, v)
    return out, ctx, q, k, k, v


def ffn(lp: Params, cfg: ModelConfig, x: torch.Tensor, chunk: int = 0, tp=None,
        valid: Optional[torch.Tensor] = None, layer: Optional[int] = None) -> torch.Tensor:
    """A prefill layer's MLP, summed over the model group ``tp``."""
    return tp_sum(mlp(lp, x, chunk=chunk), tp)


def decode_qkv(lp: Params, cfg: ModelConfig, hn: torch.Tensor, pos: torch.Tensor,
               inv_freq: torch.Tensor, cache, i: int, slot, rows=None) -> torch.Tensor:
    """hn [b, 1, D] at positions pos [b] -> q [b, H, 1, d], roped; the new
    cache row (k roped, v) written into layer ``i`` of ``cache`` at
    ``slot`` (``ops.decode_prologue.rope_append``: one launch on the card).
    An int8 cache takes its row quantized, with its scales at the slot."""
    q, k, v = qkv_proj(lp, cfg, hn)
    guards.finite("q/k/v", q, k, v)
    if cache.k_scale is None:
        return decode_prologue.rope_append(q, k, v, pos, inv_freq, cache.k[i], cache.v[i],
                                           slot, rows)
    q, k = rope_qk(q, k, pos[:, None], inv_freq)
    g = cache.k.shape[2] // k.shape[1]  # the reference repeats kv heads before caching (SnapKV)
    for plane, scale, x in ((cache.k, cache.k_scale, k), (cache.v, cache.v_scale, v)):
        x, sc = quant.quantize_kv(x.repeat_interleave(g, dim=1) if g > 1 else x)
        write_slot(scale[i], sc[:, :, 0], slot, rows)
        write_slot(plane[i], x[:, :, 0], slot, rows)
    return q


def decode_attention(lp: Params, cfg: ModelConfig, q: torch.Tensor, cache, i: int,
                     attend: torch.Tensor) -> torch.Tensor:
    """Decode attention over layer ``i`` of ``cache`` (``ops.decode_attn``),
    an int8 cache's scales folded in."""
    scales = {} if cache.k_scale is None else dict(k_scale=cache.k_scale[i],
                                                   v_scale=cache.v_scale[i])
    return decode_attn.decode_attention(q, cache.k[i], cache.v[i], attend, **scales)


def decode_ffn(lp: Params, cfg: ModelConfig, x: torch.Tensor, tp=None) -> torch.Tensor:
    """A decode step's MLP, summed over the model group ``tp``."""
    return tp_sum(mlp(lp, x), tp)
