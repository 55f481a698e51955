"""Plain float32 reference of a DeepSeek-V2 decoder under FastKV (or FullKV).

Written from the published description (HF's ``modeling_deepseek.py``:
``DeepseekV2Attention`` without query LoRA, ``DeepseekV2YarnRotaryEmbedding``,
``MoEGate`` with softmax scoring and greedy top k, ``DeepseekV2MoE``,
``DeepseekV2MLP``) and FastKV's (observation-window scores, max pooling, a
sum over the query heads that share a cache head, top-k, Token-Selective
Propagation), in plain ``torch`` operations, importing nothing of the
program. It reads the benchmark's own weights (bf16, made from the seed by
``perfbench/arch/deepseek_v2.py``: stacked by layer and layer kind, stored
[in, out]) and upcasts one layer at a time.

The attention is MLA in its expanded form: every token's latent goes
through ``kv_b`` to each head's nope key and value, and a key is [nope key,
the shared rope key] (q/k 192 wide, v 128 at the published widths). One
latent row is cached a token, so a layer has one cache head (CH = 1): its
window scores sum all query heads, and the program's kept set of that head
is followed in decode. The experts are routed here, in float32, from the
reference's own hidden states, as ``MoEGate`` routes.

As ``reference/mistral.py``, it follows the program where the method
chooses (the kept positions of each layer, the TSP set), judges those
choices by its own scores (``scores``) and returns its own top-k sets
(``own_keep``, ``own_tsp``) for the control. ``precision``: ``"float32"``
(TF32 off), or ``"float8"``, the control: every matrix product's operands
(the router's and the experts' too) rounded to float8 e4m3 with a scale
per row of activations and per output column of weights.

Departures from ``modeling_deepseek.py``, each on purpose:
  * float32 throughout (the published model runs bf16: its softmax is
    float32 and cast back to bf16 before P @ V, its cos/sin tables bf16);
  * RMSNorm multiplies by its weight in float32 (HF casts the normed state
    to the input dtype first);
  * YaRN's frequencies are computed in float64 and rounded to float32 once
    (HF computes them in float32);
  * causal attention over query blocks, the dense MLP over row blocks, the
    experts one at a time over the rows routed to them, with each row's
    weighted expert outputs summed in float32 (HF's ``moe_infer`` sorts
    the rows by expert too);
  * the attention of each layer sees the program's kept set (FastKV), and
    layers after the TSP layer see the program's TSP set, at the original
    positions; HF has no cache compression;
  * only what the configuration uses: no query LoRA, no attention bias,
    greedy top k, softmax scoring, expert weights neither renormalised
    (``norm_topk_prob`` false) nor scaled (``routed_scaling_factor`` 1),
    every layer from ``first_k_dense_replace`` on an expert layer.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

NEG = float("-inf")
FP8_MAX = 448.0


class Follow(NamedTuple):
    """The program's choices that the reference follows: ``kept[l][h]`` the
    positions cache head h of layer l holds, in slot order (one head here);
    ``tsp`` the positions the TSP layer hands on, ascending (None for
    FullKV)."""

    kept: List[List[torch.Tensor]]
    tsp: Optional[torch.Tensor]


class LayerScores(NamedTuple):
    """One layer's selection inputs as the reference computes them."""

    positions: torch.Tensor  # [s] layout positions
    scores: torch.Tensor  # [CH, s] pooled, head-summed; -inf where not selectable
    budget: int  # non-window tokens a cache head keeps
    own_keep: List[torch.Tensor]  # per cache head: the reference's own kept positions


class RefResult(NamedTuple):
    logits: torch.Tensor  # [m, V] float32: row i predicts served token i
    layers: List[LayerScores]
    tsp_scores: Optional[torch.Tensor]  # [s] summed over the heads; -inf where not selectable
    tsp_budget: int
    own_tsp: Optional[torch.Tensor]  # the reference's own TSP positions, ascending


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def topk_positions(scores: torch.Tensor, positions: torch.Tensor, k: int) -> torch.Tensor:
    """The positions of the k best selectable scores, ties to the lower index."""
    k = min(k, int(torch.isfinite(scores).sum()))
    order = torch.sort(scores, descending=True, stable=True).indices[:k]
    return positions[order]


def budget(n: int, rate: float, W: int) -> int:
    """Non-window tokens kept of n: floor(n * rate) in float32, less the window."""
    keep = int(math.floor(torch.tensor(float(n), dtype=torch.float32)
                          * torch.tensor(rate, dtype=torch.float32)))
    return max(min(keep, n) - W, 0)


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_inv_freq(cfg: dict) -> torch.Tensor:
    """The rope part's inverse frequencies [r/2] under YaRN (float64, then
    float32), or plain RoPE's without ``rope_scaling``."""
    r = cfg["qk_rope_head_dim"]
    base = float(cfg["rope_theta"])
    pos_freqs = base ** (torch.arange(0, r, 2, dtype=torch.float64) / r)
    extra = 1.0 / pos_freqs
    rs = cfg.get("rope_scaling")
    if not rs:
        return extra.float()
    factor, orig = float(rs["factor"]), rs["original_max_position_embeddings"]
    inter = 1.0 / (factor * pos_freqs)

    def corr(rot):
        return r * math.log(orig / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr(rs.get("beta_fast", 32))), 0)
    high = min(math.ceil(corr(rs.get("beta_slow", 1))), r - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(r // 2, dtype=torch.float64) - low) / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    return (inter * (1 - mask) + extra * mask).float()


def softmax_scale(cfg: dict) -> float:
    """(qk_nope + qk_rope)^-0.5, times yarn_mscale(factor, mscale_all_dim)^2."""
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    rs = cfg.get("rope_scaling")
    if rs and rs.get("mscale_all_dim"):
        m = yarn_mscale(float(rs["factor"]), float(rs["mscale_all_dim"]))
        scale = scale * m * m
    return scale


class Model:
    """The decoder's arithmetic at one precision over the benchmark's weights."""

    def __init__(self, weights: Dict, cfg: dict, precision: str = "float32"):
        if precision not in ("float32", "float8"):
            raise ValueError(f"precision {precision!r}")
        if cfg.get("norm_topk_prob") or cfg.get("routed_scaling_factor", 1) != 1:
            raise ValueError("the reference weights the experts by their scores as they are")
        self.w, self.cfg, self.fp8 = weights, cfg, precision == "float8"
        dev = weights["embed"].device
        self.inv_freq = yarn_inv_freq(cfg).to(dev)
        rs = cfg.get("rope_scaling") or {}
        self.rope_m = (yarn_mscale(float(rs["factor"]), float(rs.get("mscale", 1)))
                       / yarn_mscale(float(rs["factor"]), float(rs.get("mscale_all_dim", 0)))
                       if rs else 1.0)
        self.scale = softmax_scale(cfg)
        self.eps = cfg["rms_norm_eps"]
        self.H = cfg["num_attention_heads"]
        self.n, self.r = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
        self.R, self.vd = cfg["kv_lora_rank"], cfg["v_head_dim"]
        self.k_dense = min(cfg.get("first_k_dense_replace", 0), cfg["num_hidden_layers"])

    def weight(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(torch.float32)
        return _fp8(t, -2) if self.fp8 and t.dim() >= 2 else t  # a scale per output column

    def layer(self, l: int) -> Dict[str, torch.Tensor]:
        """Layer l's attention and dense or shared weights in float32; the
        routed experts stay in the served dtype (``expert`` upcasts one)."""
        out = {k: self.weight(v[l]) for k, v in self.w["layers"].items()}
        if l < self.k_dense:
            out.update({k: self.weight(v[l]) for k, v in self.w["dense"].items()})
        else:
            i = l - self.k_dense
            for k, v in self.w["moe"].items():
                out[k] = v[i] if k in ("w_gate", "w_up", "w_down") else self.weight(v[i])
        return out

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            x = _fp8(x, -1)  # a scale per row
        return x @ w

    def rms(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * g.float()

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x [heads, s, r] at positions pos [s]: the interleaved pairs
        regrouped (evens, then odds), then rotate-half, as HF's
        ``apply_rotary_pos_emb`` in ``modeling_deepseek.py``."""
        h, s, r = x.shape
        x = x.view(h, s, r // 2, 2).transpose(-1, -2).reshape(h, s, r)
        ang = pos.float()[:, None] * self.inv_freq[None, :]
        emb = torch.cat([ang, ang], dim=-1)
        cos, sin = emb.cos() * self.rope_m, emb.sin() * self.rope_m
        rot = torch.cat([-x[..., r // 2:], x[..., :r // 2]], dim=-1)
        return x * cos + rot * sin

    def qkv(self, lp, x: torch.Tensor, pos: torch.Tensor):
        """x [s, D] -> q, k [H, s, n + r], v [H, s, v]: MLA expanded."""
        H, n, r, R, vd = self.H, self.n, self.r, self.R, self.vd
        s = x.shape[0]
        xn = self.rms(x, lp["ln_attn"])
        q = self.mm(xn, lp["wq"]).view(s, H, n + r).transpose(0, 1)
        kv_a = self.mm(xn, lp["w_kv_a"])
        c = self.rms(kv_a[:, :R], lp["kv_norm"])
        k_pe = self.rope(kv_a[None, :, R:], pos)  # [1, s, r]
        kv = self.mm(c, lp["w_kv_b"]).view(s, H, n + vd).transpose(0, 1)
        q = torch.cat([q[..., :n], self.rope(q[..., n:], pos)], dim=-1)
        k = torch.cat([kv[..., :n], k_pe.expand(H, s, r)], dim=-1)
        v = kv[..., n:]
        if self.fp8:
            q, k, v = _fp8(q, -1), _fp8(k, -1), _fp8(v, -1)
        return q, k, v

    def expert(self, lp, name: str, e: int) -> torch.Tensor:
        return self.weight(lp[name][e])

    def mlp(self, lp, x: torch.Tensor, rows: int = 4096) -> torch.Tensor:
        """The layer's MLP over x [s, D] (normed): dense SwiGLU, or the
        routed experts (float32 softmax router, greedy top k, weighted by
        their scores) plus the shared experts."""
        if "router" not in lp:
            out = torch.empty_like(x)
            for r0 in range(0, x.shape[0], rows):
                xb = x[r0:r0 + rows]
                out[r0:r0 + rows] = self.mm(F.silu(self.mm(xb, lp["w_gate"]))
                                            * self.mm(xb, lp["w_up"]), lp["w_down"])
            return out
        cfg = self.cfg
        k = cfg["num_experts_per_tok"]
        scores = torch.softmax(self.mm(x, lp["router"]), dim=-1)
        w, idx = torch.topk(scores, k, dim=-1)
        out = torch.zeros_like(x)
        for e in range(cfg["n_routed_experts"]):
            hit = idx == e  # [s, k]
            rows_e = hit.any(dim=-1).nonzero()[:, 0]
            if rows_e.numel() == 0:
                continue
            xe = x[rows_e]
            y = self.mm(F.silu(self.mm(xe, self.expert(lp, "w_gate", e)))
                        * self.mm(xe, self.expert(lp, "w_up", e)), self.expert(lp, "w_down", e))
            out[rows_e] += y * (w * hit)[rows_e].sum(dim=-1, keepdim=True)
        if "ws_gate" in lp:
            out = out + self.mm(F.silu(self.mm(x, lp["ws_gate"])) * self.mm(x, lp["ws_up"]),
                                lp["ws_down"])
        return out

    def out_mlp(self, lp, x: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
        """x + attn-out, then + MLP; attn [H, s, v]."""
        s = x.shape[0]
        h = x + self.mm(attn.transpose(0, 1).reshape(s, -1), lp["wo"])
        return h + self.mlp(lp, self.rms(h, lp["ln_mlp"]))

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        hn = self.rms(h, self.w["final_norm"])
        return self.mm(hn, self.weight(self.w["lm_head"]))


def causal_attention(q, k, v, scale: float, block: int = 512) -> torch.Tensor:
    """q, k [H, s, qk], v [H, s, v] in layout order -> [H, s, v]; query i
    sees keys j <= i."""
    H, s, _ = q.shape
    out = q.new_empty((H, s, v.shape[-1]))
    for r0 in range(0, s, block):
        r1 = min(r0 + block, s)
        logits = torch.matmul(q[:, r0:r1], k[:, :r1].transpose(1, 2)).mul_(scale)
        rows = torch.arange(r0, r1, device=q.device)[:, None]
        cols = torch.arange(0, r1, device=q.device)[None, :]
        logits.masked_fill_(cols > rows, NEG)
        out[:, r0:r1] = torch.matmul(torch.softmax(logits, dim=-1), v[:, :r1])
    return out


def window_scores(q, k, positions: torch.Tensor, n: int, W: int, scale: float) -> torch.Tensor:
    """Pooled observation-window scores summed over every query head, [1, s]
    (the one latent cache head): -inf on the columns that cannot be
    selected (the last W positions of the prompt)."""
    s = q.shape[1]
    logits = torch.matmul(q[:, s - W:], k.transpose(1, 2)) * scale  # [H, W, s]
    vis = positions[None, :] <= positions[s - W:][:, None]  # causal by position
    p = torch.softmax(logits.masked_fill(~vis, NEG), dim=-1)
    raw = p.sum(dim=1)  # [H, s]
    selectable = positions < n - W
    raw = torch.where(selectable[None], raw, NEG)
    pooled = F.max_pool1d(raw[:, None], 7, stride=1, padding=3)[:, 0]
    return torch.where(selectable[None], pooled.sum(dim=0, keepdim=True), NEG)


def run(weights: Dict, cfg: dict, method: dict, prompt: Sequence[int], served: Sequence[int],
        follow: Follow, precision: str = "float32") -> RefResult:
    """Prefill ``prompt``, then decode the served tokens by teacher forcing,
    over the program's kept sets and TSP set; returns the logits before
    each served token and the reference's own view of every selection.
    FullKV keeps every position (its budget: the whole layout)."""
    if method["method"] not in ("fastkv", "fullkv"):
        raise ValueError("the reference runs FastKV and FullKV")
    fast = method["method"] == "fastkv"
    if precision == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    m = Model(weights, cfg, precision)
    dev = weights["embed"].device
    W, T = method["window_size"], method["tsp_idx"] if fast else -1
    n = len(prompt)
    with torch.no_grad():
        ids = torch.tensor(list(prompt), dtype=torch.long, device=dev)
        h = weights["embed"][ids].to(torch.float32)
        if m.fp8:
            h = _fp8(h, -1)
        pos = torch.arange(n, device=dev)
        layers: List[LayerScores] = []
        kept_kv = []
        tsp_scores, own_tsp, tsp_b = None, None, 0
        for l in range(cfg["num_hidden_layers"]):
            lp = m.layer(l)
            q, k, v = m.qkv(lp, h, pos)
            attn = causal_attention(q, k, v, m.scale)
            s = pos.shape[0]
            sc = window_scores(q, k, pos, n, W, m.scale)
            if fast:
                rate = (method["retain_rate"] / method["tsp_rate"] if l > T
                        else method["retain_rate"])
                kb = budget(s, rate, W)
            else:
                kb = s
            layers.append(LayerScores(pos, sc, kb, [topk_positions(sc[0], pos, kb)]))
            idx = torch.searchsorted(pos, follow.kept[l][0].to(dev))
            kept_kv.append((k[:, idx], v[:, idx]))
            h = m.out_mlp(lp, h, attn)
            del q, k, v, attn, lp
            if l == T:
                sel = pos < n - W
                tsp_scores = torch.where(sel, sc[0], NEG)
                tsp_b = budget(n, method["tsp_rate"], W)
                top = topk_positions(tsp_scores, pos, tsp_b)
                own_tsp = torch.sort(torch.cat([top, pos[max(n - W, 0):]])).values
                keep_idx = torch.searchsorted(pos, follow.tsp.to(dev))
                h, pos = h[keep_idx], pos[keep_idx]
        rows = [m.logits(h[-1:])]
        served = list(served)
        if len(served) > 1:
            rows.append(_decode(m, cfg, kept_kv, served[:-1], n))
        logits = torch.cat(rows, dim=0)
    return RefResult(logits, layers, tsp_scores, tsp_b, own_tsp)


def _decode(m: Model, cfg: dict, kept_kv, fed: Sequence[int], n: int) -> torch.Tensor:
    """Teacher-forced decode: token i of ``fed`` at position n + i attends
    to its layer's kept keys and values and to the decoded tokens up to
    itself -> logits [len(fed), V]."""
    dev = m.w["embed"].device
    t = len(fed)
    ids = torch.tensor(list(fed), dtype=torch.long, device=dev)
    h = m.w["embed"][ids].to(torch.float32)
    if m.fp8:
        h = _fp8(h, -1)
    pos = n + torch.arange(t, device=dev)
    for l in range(cfg["num_hidden_layers"]):
        lp = m.layer(l)
        q, k, v = m.qkv(lp, h, pos)  # [H, t, qk], [H, t, qk], [H, t, v]
        kk, vv = kept_kv[l]
        c0 = kk.shape[1]
        keys = torch.cat([kk, k], dim=1)
        vals = torch.cat([vv, v], dim=1)
        rank = torch.arange(c0 + t, device=dev)[None, :]
        row = torch.arange(t, device=dev)[:, None]
        vis = rank < c0 + row + 1  # the kept entries and decoded tokens up to itself
        lg = torch.matmul(q, keys.transpose(1, 2)) * m.scale
        attn = torch.matmul(torch.softmax(lg.masked_fill(~vis[None], NEG), dim=-1), vals)
        h = m.out_mlp(lp, h, attn)
    return m.logits(h)
