"""Plain float32 reference of a DeepSeek-V3 decoder at one device's share of
its experts, under FastKV (or FullKV).

Written from the published description (HF's ``modeling_deepseek.py`` of
DeepSeek-V3: ``DeepseekV3Attention`` with its query LoRA, ``MoEGate`` under
``topk_method`` ``noaux_tc``, ``DeepseekV3MoE``; YaRN as DeepSeek-V2's) and
FastKV's, in plain ``torch`` operations, importing nothing of the program
and nothing but ``torch``: what V3 shares with V2 (RoPE and YaRN, RMSNorm,
the dense MLP, the blocked causal attention, the window scores, the
selections and the float8 control's rounding) is written as
``reference/deepseek_v2.py`` writes it. It reads the benchmark's own
weights (bf16, made from the seed by ``perfbench/arch/deepseek_v3.py``) and
upcasts one layer at a time.

A layer: the query q = RMSNorm(x q_a, ``q_a_norm``) q_b; the latent (R,
RMS-normed) and the shared rope key (r) from ``kv_a``; each head's nope key
and value from the latent through ``kv_b``; keys [nope key, rope key] (q/k
192, v 128 at the published widths). The attention runs over blocks of
``HEAD_BLOCK`` heads, each expanded from the latent on its own, so that a
32768-token prompt at 128 heads fits beside the weights; the window scores
are summed over the blocks. A decode step keeps each layer's kept rows as
latent rows (R + r values a row) and expands them one layer at a time.

The router, in float32 from the reference's own hidden states: sigmoid
scores s; c = s + ``e_bias``; a group's score the sum of its two best c; c
set to 0 outside the ``topk_group`` best groups; the top k of c; the weights
the chosen s, over their sum plus 1e-20 (``norm_topk_prob``), times
``routed_scaling_factor``. The share: the configuration's
``n_routed_experts`` are the experts held here, the ``ep_rank``-th block
(0 unless given) of the router's ``n_routed_experts`` x ``ep_size``; only
the held experts' part is computed, with the weights computed over all of
them, and the shared expert is added once.

Departures from ``modeling_deepseek.py``, each on purpose: those of
``reference/deepseek_v2.py`` (float32 throughout, RMSNorm's weight in
float32, YaRN's frequencies in float64, blocked attention and MLP, the
program's kept and TSP sets followed), and:
  * the share: the absent experts' part of each expert layer is left out,
    as the program leaves it out on a device of the deployment, without the
    exchange between devices; with ``ep_size`` 1 every expert is computed;
  * the multi-token-prediction module (``num_nextn_predict_layers``) is not
    built: it drafts tokens for speculative decoding, and no next-token
    logit depends on it (HF's modeling code builds none either);
  * only what the configuration uses: no attention bias, ``noaux_tc`` over
    sigmoid scores, every layer from ``first_k_dense_replace`` on an expert
    layer.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F

HEAD_BLOCK = 16  # heads expanded from the latent at once
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
        if cfg.get("topk_method") != "noaux_tc" or cfg.get("scoring_func") != "sigmoid":
            raise ValueError("the reference routes as DeepSeek-V3's noaux_tc over sigmoid scores")
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
        self.held = cfg["n_routed_experts"]
        self.first = cfg.get("ep_rank", 0) * self.held

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

    def q_latent(self, lp, xn: torch.Tensor) -> torch.Tensor:
        """xn [s, D] -> the query LoRA's normed latent [s, Q]."""
        return self.rms(self.mm(xn, lp["q_a"]), lp["q_a_norm"])

    def query(self, lp, qa: torch.Tensor, pos: torch.Tensor, h0: int, h1: int) -> torch.Tensor:
        """The normed query latent qa [s, Q] -> q of heads [h0, h1) [h1 - h0, s,
        n + r], its rope part turned."""
        w = self.n + self.r
        q = self.mm(qa, lp["q_b"][:, h0 * w:h1 * w]).view(qa.shape[0], h1 - h0, w).transpose(0, 1)
        q = torch.cat([q[..., :self.n], self.rope(q[..., self.n:], pos)], dim=-1)
        return _fp8(q, -1) if self.fp8 else q

    def latent(self, lp, xn: torch.Tensor, pos: torch.Tensor):
        """xn [s, D] -> the normed latent [s, R] and the roped shared key [s, r]."""
        kv_a = self.mm(xn, lp["w_kv_a"])
        return self.rms(kv_a[:, :self.R], lp["kv_norm"]), self.rope(kv_a[None, :, self.R:], pos)[0]

    def expand(self, lp, c: torch.Tensor, k_pe: torch.Tensor, h0: int, h1: int):
        """Latent rows c [C, R] and their rope keys [C, r] -> keys [h1 - h0, C,
        n + r] and values [h1 - h0, C, v] of heads [h0, h1)."""
        w = self.n + self.vd
        C = c.shape[0]
        kv = self.mm(c, lp["w_kv_b"][:, h0 * w:h1 * w]).view(C, h1 - h0, w).transpose(0, 1)
        k = torch.cat([kv[..., :self.n], k_pe[None].expand(h1 - h0, C, self.r)], dim=-1)
        v = kv[..., self.n:]
        if self.fp8:
            k, v = _fp8(k, -1), _fp8(v, -1)
        return k, v

    def route(self, lp, x: torch.Tensor):
        """x [s, D] (normed) -> (weights [s, k], the router's expert ids [s, k])."""
        cfg = self.cfg
        scores = torch.sigmoid(self.mm(x, lp["router"]))
        choice = scores + lp["e_bias"].float()
        s, G = x.shape[0], cfg["n_group"]
        grouped = choice.view(s, G, -1)
        group_score = grouped.topk(2, dim=-1).values.sum(dim=-1)
        best = torch.topk(group_score, cfg["topk_group"], dim=-1).indices
        kept = torch.zeros((s, G), dtype=torch.bool, device=x.device).scatter_(1, best, True)
        choice = grouped.masked_fill(~kept[..., None], 0.0).view(s, -1)
        idx = torch.topk(choice, cfg["num_experts_per_tok"], dim=-1).indices
        w = scores.gather(1, idx)
        if cfg.get("norm_topk_prob"):
            w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        return w * float(cfg.get("routed_scaling_factor", 1.0)), idx

    def expert(self, lp, name: str, e: int) -> torch.Tensor:
        return self.weight(lp[name][e])

    def mlp(self, lp, x: torch.Tensor, rows: int = 4096) -> torch.Tensor:
        """The layer's MLP over x [s, D] (normed): the dense SwiGLU over row
        blocks, or the held experts' part of the routed experts plus the
        shared expert."""
        if "router" not in lp:
            out = torch.empty_like(x)
            for r0 in range(0, x.shape[0], rows):
                xb = x[r0:r0 + rows]
                out[r0:r0 + rows] = self.mm(F.silu(self.mm(xb, lp["w_gate"]))
                                            * self.mm(xb, lp["w_up"]), lp["w_down"])
            return out
        w, idx = self.route(lp, x)
        out = torch.zeros_like(x)
        for e in range(self.held):
            hit = idx == self.first + e  # [s, k]
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

    def finish(self, lp, h: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
        """h + attn [s, H v] through ``wo``, then + the MLP."""
        h = h + self.mm(attn, lp["wo"])
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
    H, vd = m.H, m.vd
    n = len(prompt)
    with torch.no_grad():
        ids = torch.tensor(list(prompt), dtype=torch.long, device=dev)
        h = weights["embed"][ids].to(torch.float32)
        if m.fp8:
            h = _fp8(h, -1)
        pos = torch.arange(n, device=dev)
        layers: List[LayerScores] = []
        kept_rows = []  # each layer's kept latent rows and rope keys
        tsp_scores, own_tsp, tsp_b = None, None, 0
        for l in range(cfg["num_hidden_layers"]):
            lp = m.layer(l)
            s = pos.shape[0]
            xn = m.rms(h, lp["ln_attn"])
            qa = m.q_latent(lp, xn)
            c, k_pe = m.latent(lp, xn, pos)
            attn = h.new_empty((s, H * vd))
            sc = None
            for h0 in range(0, H, HEAD_BLOCK):
                h1 = min(h0 + HEAD_BLOCK, H)
                q = m.query(lp, qa, pos, h0, h1)
                k, v = m.expand(lp, c, k_pe, h0, h1)
                attn[:, h0 * vd:h1 * vd] = causal_attention(q, k, v, m.scale).transpose(
                    0, 1).reshape(s, -1)
                part = window_scores(q, k, pos, n, W, m.scale)
                sc = part if sc is None else sc + part
                del q, k, v
            if fast:
                rate = (method["retain_rate"] / method["tsp_rate"] if l > T
                        else method["retain_rate"])
                kb = budget(s, rate, W)
            else:
                kb = s
            layers.append(LayerScores(pos, sc, kb, [topk_positions(sc[0], pos, kb)]))
            idx = torch.searchsorted(pos, follow.kept[l][0].to(dev))
            kept_rows.append((c[idx], k_pe[idx]))
            h = m.finish(lp, h, attn)
            del attn, qa, c, k_pe, lp
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
            rows.append(_decode(m, cfg, kept_rows, served[:-1], n))
        logits = torch.cat(rows, dim=0)
    return RefResult(logits, layers, tsp_scores, tsp_b, own_tsp)


def _decode(m: Model, cfg: dict, kept_rows, fed: Sequence[int], n: int) -> torch.Tensor:
    """Teacher-forced decode: token i of ``fed`` at position n + i attends
    to its layer's kept rows and to the decoded tokens up to itself, each
    layer's rows expanded from their latents there -> logits [len(fed), V]."""
    dev = m.w["embed"].device
    t = len(fed)
    H, vd = m.H, m.vd
    ids = torch.tensor(list(fed), dtype=torch.long, device=dev)
    h = m.w["embed"][ids].to(torch.float32)
    if m.fp8:
        h = _fp8(h, -1)
    pos = n + torch.arange(t, device=dev)
    for l in range(cfg["num_hidden_layers"]):
        lp = m.layer(l)
        xn = m.rms(h, lp["ln_attn"])
        qa = m.q_latent(lp, xn)
        c, k_pe = m.latent(lp, xn, pos)
        kc, kp = kept_rows[l]
        c0 = kc.shape[0]
        c_all, kp_all = torch.cat([kc, c]), torch.cat([kp, k_pe])
        rank = torch.arange(c0 + t, device=dev)[None, :]
        row = torch.arange(t, device=dev)[:, None]
        vis = rank < c0 + row + 1  # the kept entries and decoded tokens up to itself
        attn = h.new_empty((t, H * vd))
        for h0 in range(0, H, HEAD_BLOCK):
            h1 = min(h0 + HEAD_BLOCK, H)
            q = m.query(lp, qa, pos, h0, h1)
            keys, vals = m.expand(lp, c_all, kp_all, h0, h1)
            lg = torch.matmul(q, keys.transpose(1, 2)) * m.scale
            out = torch.matmul(torch.softmax(lg.masked_fill(~vis[None], NEG), dim=-1), vals)
            attn[:, h0 * vd:h1 * vd] = out.transpose(0, 1).reshape(t, -1)
        h = m.finish(lp, h, attn)
    return m.logits(h)
