"""DeepSeek-V2 and -V3 forward blocks on plain tensors: latent attention
(MLA), routed and shared experts, a share of the routed experts, YaRN.

Written from HF's ``modeling_deepseek.py`` of each (``DeepseekV2Attention``
and ``DeepseekV3Attention``, ``MoEGate``, ``DeepseekV2MoE``,
``DeepseekV2YarnRotaryEmbedding``). A decoder layer:

  * attention: q = h @ wq [H x (n + r)] without a query LoRA (V2), or q =
    RMSNorm(h @ q_a, ``q_a_norm``) @ q_b through ``q_lora_rank`` values
    (V3); ``kv_a`` maps h to
    the latent (R, RMS-normed by ``kv_norm``) and one rope key (r) that
    every head shares; ``kv_b`` maps the normed latent to each head's nope
    key (n) and value (v). RoPE (YaRN frequencies, ``models.rope``) turns
    the rope parts of q and the shared key at the original positions, in
    HF's layout: each interleaved pair regrouped (evens, then odds) before
    rotate-half. Keys are [k_nope, k_pe] (n + r wide), values v wide; the
    softmax scale is ``cfg.softmax_scale`` (YaRN's mscale squared in it);
  * the MLP: a dense SwiGLU in the first ``first_k_dense_replace`` layers,
    then experts: a float32 router (``route``: V2's softmax and greedy top
    k weighted by the scores as they are; V3's ``noaux_tc``: sigmoid scores,
    a correction bias and a group limit in the choice, the weights
    renormalised and scaled), plus the shared experts, one SwiGLU every
    token takes. The routed experts run as grouped GEMMs over the rows
    sorted by expert (``routed_experts``), in prefill and decode alike.
    Under expert parallelism's share (``MoEConfig.ep_size`` > 1) the layer
    holds ``n_routed_experts`` of the router's experts: it routes over all
    of them and computes only its own experts' part, with the weights
    computed over all; the shared experts are every device's alike.

The cache of a layer is one head a token (``KVCache.k`` the normed latent,
``KVCache.v`` the roped shared key: R + r values a token, no second copy),
and prefill expands keys and values only for its own attention. A decode
step attends over the latent rows as they are (``ops.latent_attn``).

Parameters (the layout ``init_params`` makes and ``perfbench``'s
architecture module draws; [in, out] as in ``models.llama``):
  ``embed``, ``final_norm``, ``lm_head``;
  ``layers``, stacked over every layer: ``ln_attn``, ``ln_mlp``, ``wq``
  (or, with a query LoRA, ``q_a`` [D, Q], ``q_a_norm`` [Q], ``q_b`` [Q,
  H (n + r)]), ``w_kv_a``, ``kv_norm``, ``w_kv_b``, ``wo``;
  ``dense``, stacked over the dense layers: ``w_gate``, ``w_up``, ``w_down``;
  ``moe``, stacked over the expert layers: ``router`` [D, E_router] (and
  ``e_bias`` [E_router] float32 under ``noaux_tc``), the held experts'
  ``w_gate``, ``w_up`` [E, D, F_e], ``w_down`` [E, F_e, D], ``ws_gate``,
  ``ws_up``, ``ws_down`` (the shared experts, n_shared x F_e wide).
``layer_params`` gives one layer's views, its kind's MLP among them.

What the port runs of it: FastKV and FullKV through ``Engine.generate``
and the ``Scheduler`` (admitted whole) on one device, bf16 or float32
weights and cache, random weights (``init_params``; ``core.weights`` reads
no DeepSeek checkpoint), V3 at one device's share of its experts without
the exchange between devices (V3's multi-token-prediction module is not
built). ``check`` raises NotImplementedError, naming the model kind, on the
rest.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from fastkv_tpu_torch.core.config import (
    EngineConfig,
    Method,
    MethodConfig,
    ModelConfig,
    YarnScaling,
    yarn_mscale,
)
from fastkv_tpu_torch.core.device import resolve_device, torch_dtype
from fastkv_tpu_torch.models import llama
from fastkv_tpu_torch.models.rope import apply_rope_pairs, rope_cos_sin
from fastkv_tpu_torch.ops import add_rms_norm, decode_prologue, latent_attn
from fastkv_tpu_torch.utils import guards, profiling

Params = Dict[str, Any]
METHODS = (Method.FASTKV, Method.FULLKV)
# admitted whole: chunks would need the flash kernel's rectangular form at
# q/k 192, v 128; no HF checkpoint reader yet (random weights only)
CHUNKED_ADMISSION = False
READS_CHECKPOINTS = False
# a prefill's expert layer runs over row chunks whose float32 weighted sum
# ([rows, k, D]) stays within this: DeepSeek-V2-Lite's 32768 rows take 1.6
# GB and run whole, DeepSeek-V3's 8 x 7168-wide pairs take 9362 rows a chunk
MOE_SUM_BYTES = 2 << 30


def cache_dims(cfg: ModelConfig) -> Tuple[int, int]:
    """A cache row's k and v widths: the normed latent and the roped
    shared key."""
    return cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim


def check(cfg: ModelConfig, mcfg: MethodConfig, ecfg: EngineConfig, params: Params,
          mesh=None, pcfg=None) -> None:
    """NotImplementedError, naming the model kind, for what this path does
    not run: methods other than FastKV and FullKV, an int8 cache or int8
    weights, fused window scores, a mesh of more than one rank."""
    kind = cfg.kind
    if mcfg.method not in METHODS:
        raise NotImplementedError(f"{kind}: method {mcfg.method.value} is not ported; "
                                  f"{', '.join(m.value for m in METHODS)} are")
    if ecfg.kv_int8:
        raise NotImplementedError(f"{kind}: kv_int8 is not ported (the cache holds latents)")
    if ecfg.fuse_window_scores:
        raise NotImplementedError(f"{kind}: fuse_window_scores is not ported (the flash "
                                  f"kernel's q/k 192, v 128 form has no fused scores)")
    groups = [params] + [params[g] for g in ("layers", "dense", "moe") if g in params]
    if any(k.endswith("_scale") for g in groups for k in g):
        raise NotImplementedError(f"{kind}: int8 weights are not ported")
    for p in (pcfg, None if mesh is None else mesh.pcfg):
        if p is not None and p.num_devices > 1:
            raise NotImplementedError(f"{kind}: a mesh of more than one rank is not ported")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def param_shapes(cfg: ModelConfig) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """The shapes of every weight, by group (see the module docstring)."""
    mla, moe = cfg.mla, cfg.moe
    L, D, V, H = cfg.num_layers, cfg.hidden_size, cfg.vocab_size, cfg.num_heads
    R, n, r, v = mla.kv_lora_rank, mla.qk_nope_head_dim, mla.qk_rope_head_dim, mla.v_head_dim
    Ld = min(moe.first_k_dense_replace, L)
    Le = L - Ld
    E, Fe, Fs = moe.n_routed_experts, moe.moe_intermediate_size, (
        moe.n_shared_experts * moe.moe_intermediate_size)
    top = {"embed": (V, D), "final_norm": (D,)}
    if not cfg.tie_word_embeddings:
        top["lm_head"] = (D, V)
    Q = mla.q_lora_rank
    query = ({"wq": (L, D, H * (n + r))} if Q is None else
             {"q_a": (L, D, Q), "q_a_norm": (L, Q), "q_b": (L, Q, H * (n + r))})
    out = {"": top,
           "layers": {"ln_attn": (L, D), "ln_mlp": (L, D), **query,
                      "w_kv_a": (L, D, R + r), "kv_norm": (L, R),
                      "w_kv_b": (L, R, H * (n + v)), "wo": (L, H * v, D)}}
    if Ld:
        F_ = cfg.intermediate_size
        out["dense"] = {"w_gate": (Ld, D, F_), "w_up": (Ld, D, F_), "w_down": (Ld, F_, D)}
    if Le:
        out["moe"] = {"router": (Le, D, moe.router_experts)}
        if moe.topk_method == "noaux_tc":
            out["moe"]["e_bias"] = (Le, moe.router_experts)
        out["moe"].update(w_gate=(Le, E, D, Fe), w_up=(Le, E, D, Fe), w_down=(Le, E, Fe, D))
        if Fs:
            out["moe"].update(ws_gate=(Le, D, Fs), ws_up=(Le, D, Fs), ws_down=(Le, Fs, D))
    return out


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None, device="cuda",
                dtype=None, std: float = 0.02) -> Params:
    """Random-normal weights (``std``, norms 1) made on ``device`` in their
    storage dtype, group by group in ``param_shapes``' order; the router's
    correction bias in float32."""
    dev = resolve_device(device)
    dtype = torch_dtype(dtype or cfg.dtype)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    params: Params = {}
    for group, shapes in param_shapes(cfg).items():
        dst = params if not group else params.setdefault(group, {})
        for k, shp in shapes.items():
            if llama.is_norm(k):
                dst[k] = torch.ones(shp, dtype=torch.float32, device=dev)
            elif k == "e_bias":
                dst[k] = torch.empty(shp, dtype=torch.float32, device=dev).normal_(
                    0.0, std, generator=generator)
            else:
                dst[k] = torch.empty(shp, dtype=dtype, device=dev).normal_(
                    0.0, std, generator=generator)
    return params


def layer_params(params: Params, l: int) -> Params:
    """Views of layer ``l``'s weights: its attention's, and its MLP's (the
    dense group's or the expert group's, by its kind)."""
    lp = {k: v[l] for k, v in params["layers"].items()}
    n_dense = params["dense"]["w_gate"].shape[0] if "dense" in params else 0
    group, i = (params["dense"], l) if l < n_dense else (params["moe"], l - n_dense)
    lp.update({k: v[i] for k, v in group.items()})
    return lp


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def rope_mscale(cfg: ModelConfig) -> float:
    """YaRN's rope factor yarn_mscale(factor, mscale) /
    yarn_mscale(factor, mscale_all_dim), 1.0 without YaRN."""
    rs = cfg.rope_scaling
    if isinstance(rs, YarnScaling):
        return yarn_mscale(rs.factor, rs.mscale) / yarn_mscale(rs.factor, rs.mscale_all_dim)
    return 1.0


def cos_sin(cfg: ModelConfig, positions: torch.Tensor, inv_freq: torch.Tensor):
    """cos/sin [..., s, r/2] at ``positions``, times ``rope_mscale(cfg)``."""
    cos, sin = rope_cos_sin(positions, inv_freq)
    m = rope_mscale(cfg)
    if m != 1.0:
        cos, sin = cos * m, sin * m
    return cos, sin


def latent_proj(lp: Params, cfg: ModelConfig, hn: torch.Tensor, norm=llama.rms_norm):
    """hn [b, s, D] -> the projections q [b, H, s, n + r] and kv_a [b, s, R + r].
    A query LoRA's norm is ``norm`` (x, weight, eps)."""
    mla = cfg.mla
    b, s, _ = hn.shape
    n, r = mla.qk_nope_head_dim, mla.qk_rope_head_dim
    if mla.q_lora_rank is None:
        q = llama.linear(lp, "wq", hn)
    else:
        q_a = norm(llama.linear(lp, "q_a", hn), lp["q_a_norm"], cfg.rms_norm_eps)
        q = llama.linear(lp, "q_b", q_a)
    q = q.view(b, s, cfg.num_heads, n + r).transpose(1, 2)
    kv_a = llama.linear(lp, "w_kv_a", hn)  # [b, s, R + r]
    guards.finite("q/kv_a", q, kv_a)
    return q, kv_a


def latent_rope(cfg: ModelConfig, q: torch.Tensor, kv_a: torch.Tensor, kv_norm: torch.Tensor,
                cos, sin):
    """The projections' q [b, H, s, n + r] and kv_a [b, s, R + r] -> q with
    its rope part turned, the latent normed by ``kv_norm`` [b, s, R] and the
    roped shared key [b, 1, s, r]."""
    n, R = cfg.mla.qk_nope_head_dim, cfg.mla.kv_lora_rank
    latent = llama.rms_norm(kv_a[..., :R], kv_norm, cfg.rms_norm_eps)
    k_pe = apply_rope_pairs(kv_a[..., None, R:].transpose(1, 2), cos, sin)  # [b, 1, s, r]
    q = torch.cat([q[..., :n], apply_rope_pairs(q[..., n:], cos, sin)], dim=-1)
    return q, latent, k_pe


def prefill_attention(lp: Params, cfg: ModelConfig, hn: torch.Tensor, positions: torch.Tensor,
                      inv_freq: torch.Tensor, attend, layer: int):
    """One layer's prefill attention under a ``prefill.mla`` span (the
    latent projections, the ``kv_b`` expansion, RoPE and the flash call
    ``attend(q, k, v)`` -> (out, score context)) -> (out [b, H, s, v], the
    score context, q and k [b, H, s, n + r] for the keep-set's window
    scores, and the cache row's planes: the latent [b, 1, s, R] and the
    roped key [b, 1, s, r])."""
    mla = cfg.mla
    b, s, _ = hn.shape
    n, vd, H = mla.qk_nope_head_dim, mla.v_head_dim, cfg.num_heads
    with profiling.span("prefill.mla", device=True, layer=layer, rows=s):
        cos, sin = cos_sin(cfg, positions, inv_freq)
        q, kv_a = latent_proj(lp, cfg, hn)
        q, latent, k_pe = latent_rope(cfg, q, kv_a, lp["kv_norm"], cos, sin)
        kv = llama.linear(lp, "w_kv_b", latent).view(b, s, H, n + vd).transpose(1, 2)
        k = torch.cat([kv[..., :n], k_pe.expand(b, H, s, k_pe.shape[-1])], dim=-1)
        out, ctx = attend(q, k, kv[..., n:])
    return out, ctx, q, k, latent[:, None], k_pe


def decode_qkv(lp: Params, cfg: ModelConfig, hn: torch.Tensor, pos: torch.Tensor,
               inv_freq: torch.Tensor, cache, i: int, slot, rows=None) -> torch.Tensor:
    """hn [b, 1, D] at positions pos [b] -> q [b, H, 1, n + r] (its rope part
    turned); the new cache row (the normed latent, the roped key) written
    into layer ``i`` of ``cache`` at ``slot`` (``ops.decode_prologue``'s
    latent form: one launch on the card). A query LoRA's norm is
    ``ops.add_rms_norm.rms_norm``: one launch."""
    q, kv_a = latent_proj(lp, cfg, hn, norm=add_rms_norm.rms_norm)
    return decode_prologue.latent_prologue(q, kv_a, lp["kv_norm"], pos, inv_freq, cache.k[i],
                                           cache.v[i], slot, rows, eps=cfg.rms_norm_eps,
                                           mscale=rope_mscale(cfg))


def decode_attention(lp: Params, cfg: ModelConfig, q: torch.Tensor, cache, i: int,
                     attend: torch.Tensor) -> torch.Tensor:
    """Absorbed latent attention over layer ``i`` of ``cache`` (``k`` the
    latents, ``v`` the roped keys) -> [b, H, 1, v]."""
    with profiling.span("decode.mla"):
        return latent_attn.absorbed(q, cache.k[i], cache.v[i], attend, lp["w_kv_b"],
                                    cfg.mla.v_head_dim, cfg.softmax_scale)


# ---------------------------------------------------------------------------
# Experts
# ---------------------------------------------------------------------------

def route(lp: Params, cfg: ModelConfig, x: torch.Tensor):
    """HF's ``MoEGate``: x [N, D] -> (weights [N, k] float32, expert ids
    [N, k] int64 over the router's experts). ``greedy``: softmax scores,
    the top k as they are. ``noaux_tc`` (V3): sigmoid scores s; the choice
    ranks c = s + ``e_bias``, within the ``topk_group`` groups whose two
    best c sum highest (c set to 0 outside them, as HF does); the weights
    are the chosen s, over their sum (+ 1e-20) when ``norm_topk_prob``,
    times ``routed_scaling_factor``. Static shapes, no host sync."""
    moe = cfg.moe
    logits = x.float() @ lp["router"].float()
    if moe.topk_method != "noaux_tc":
        return torch.topk(torch.softmax(logits, dim=-1), moe.num_experts_per_tok, dim=-1)
    scores = torch.sigmoid(logits)
    choice = scores + lp["e_bias"]
    N, G = choice.shape[0], moe.n_group
    grouped = choice.view(N, G, -1)
    best = torch.topk(grouped.topk(2, dim=-1).values.sum(dim=-1), moe.topk_group, dim=-1).indices
    kept = torch.zeros((N, G), dtype=torch.bool, device=x.device).scatter_(1, best, True)
    choice = grouped.masked_fill(~kept[..., None], 0.0).view(N, -1)
    idx = torch.topk(choice, moe.num_experts_per_tok, dim=-1).indices
    w = scores.gather(1, idx)
    if moe.norm_topk_prob:
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
    return w * moe.routed_scaling_factor, idx


def _swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def _shared(lp: Params, x: torch.Tensor) -> torch.Tensor:
    if "ws_gate" not in lp:
        return torch.zeros_like(x)
    return _swiglu(x, lp["ws_gate"], lp["ws_up"], lp["ws_down"])


def routed_experts(lp: Params, cfg: ModelConfig, x: torch.Tensor, w: torch.Tensor,
                   idx: torch.Tensor, live: Optional[torch.Tensor] = None):
    """Each row's k routed experts, weighted and summed: x [N, D], the
    routing (w, idx) [N, k] -> ([N, D] in x's dtype, the expert offsets [E]).

    The N k (row, expert) pairs are sorted by expert (stably) and the three
    products of every expert run as grouped GEMMs over its run of rows
    (``torch._grouped_mm``, the offsets ``offs`` on the device): one launch
    a product for all experts, no host sync and static shapes, so a decode
    step is captured whole, and an expert no row picks is not read. Rows
    where ``live`` [N] is False take no expert (their pairs sort last,
    past ``offs[-1]``, and are zeroed): a padded row of a prefill costs no
    expert work and changes no other row. The outputs go back to (row,
    slot) order and are weighted and summed over the k slots in float32,
    as HF's ``moe_infer``.

    Under a share (``ep_size`` > 1) ``idx`` counts the router's experts:
    the held block's ids become local ones, and a pair whose expert is
    held elsewhere is not live (it sorts last and is zeroed); the held
    pairs keep their weights."""
    N, k = idx.shape
    moe = cfg.moe
    E = moe.n_routed_experts
    flat = idx.reshape(-1)
    if moe.ep_size > 1:
        flat = flat - moe.ep_rank * E
        flat = torch.where((flat >= 0) & (flat < E), flat, E)
    if live is not None:
        flat = torch.where(live.repeat_interleave(k), flat, E)
    order = torch.argsort(flat, stable=True)
    offs = torch.searchsorted(flat[order], torch.arange(E, device=x.device),
                              right=True).to(torch.int32)
    xs = x[order // k]
    h = F.silu(torch._grouped_mm(xs, lp["w_gate"], offs=offs)) * torch._grouped_mm(
        xs, lp["w_up"], offs=offs)
    y = torch._grouped_mm(h, lp["w_down"], offs=offs)
    if live is not None or moe.ep_size > 1:
        y = torch.where((torch.arange(N * k, device=x.device) < offs[-1])[:, None], y, 0)
    back = torch.empty_like(y)
    back[order] = y
    out = (back.view(N, k, -1).float() * w[..., None]).sum(dim=1).to(x.dtype)
    return out, offs


def ffn(lp: Params, cfg: ModelConfig, x: torch.Tensor, chunk: int = 0, tp=None,
        valid: Optional[torch.Tensor] = None, layer: Optional[int] = None) -> torch.Tensor:
    """A prefill layer's MLP over x [b, s, D]: the dense SwiGLU (``chunk``
    as ``models.llama.mlp``), or the experts (``moe_prefill``)."""
    if "router" not in lp:
        return llama.mlp(lp, x, chunk=chunk)
    return moe_prefill(lp, cfg, x, valid, layer)


def moe_prefill(lp: Params, cfg: ModelConfig, x: torch.Tensor,
                valid: Optional[torch.Tensor] = None, layer: Optional[int] = None) -> torch.Tensor:
    """The expert layer over a prefill's rows x [b, s, D], under a
    ``prefill.moe`` span: the router (a ``prefill.route`` span), the routed
    experts (``routed_experts``; rows where ``valid`` [b, s] is False take
    none), the shared experts; over row chunks whose float32 weighted sum
    stays within ``MOE_SUM_BYTES`` (a row's result is its own either way).
    While the profiler records, the span counts ``experts_hit``,
    ``max_load`` (rows of the busiest expert) and ``pairs_here`` (the
    (row, expert) pairs on the experts held here), read from the offsets
    then only: an untraced prefill never waits for the device here."""
    b, s, D = x.shape
    N, k = b * s, cfg.moe.num_experts_per_tok
    rows = max(MOE_SUM_BYTES // (4 * k * D), 1)
    with profiling.span("prefill.moe", device=True, layer=layer, rows=s) as sp:
        xf = x.reshape(N, D)
        live = None if valid is None else valid.reshape(-1)
        routed, loads = [], 0
        for r0 in range(0, N, rows):
            xc = xf[r0:r0 + rows]
            with profiling.span("prefill.route", device=True, layer=layer, rows=xc.shape[0]):
                w, idx = route(lp, cfg, xc)
            out_c, offs = routed_experts(lp, cfg, xc, w, idx,
                                         None if live is None else live[r0:r0 + rows])
            routed.append(out_c)
            if sp is not None:
                loads = loads + torch.diff(offs, prepend=offs.new_zeros(1))
        routed = routed[0] if len(routed) == 1 else torch.cat(routed)
        out = routed.view(b, s, D) + _shared(lp, x)
        if sp is not None:
            counts = loads.tolist()
            sp.counts.update(experts_hit=sum(c > 0 for c in counts), max_load=max(counts),
                             pairs_here=sum(counts))
    return out


def decode_ffn(lp: Params, cfg: ModelConfig, x: torch.Tensor, tp=None) -> torch.Tensor:
    """A decode step's MLP over x [b, 1, D]: the dense SwiGLU, or the
    router, the routed experts from ids that stay on the device
    (``routed_experts``: static shapes, so the step is captured whole, and
    only the picked experts' weights are read) and the shared experts."""
    if "router" not in lp:
        return llama.mlp(lp, x)
    with profiling.span("decode.moe"):
        b, _, D = x.shape
        xf = x.reshape(b, D)
        with profiling.span("decode.route"):
            w, idx = route(lp, cfg, xf)
        routed, _ = routed_experts(lp, cfg, xf, w, idx)
        return routed[:, None] + _shared(lp, x)
