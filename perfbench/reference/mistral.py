"""Plain float32 reference of a Mistral-family decoder under FastKV.

Written from the published descriptions (Mistral's decoder as HF's
``MistralForCausalLM`` computes it; FastKV's observation-window scores,
max pooling, GQA group sums, top-k and Token-Selective Propagation), in
plain ``torch`` operations, importing nothing of the program. It reads the
benchmark's own weights (bf16, made from the seed, stacked by layer and
stored [in, out]) and upcasts one layer at a time.

The program's kept sets on random weights change under any change of
rounding (near-equal scores swap places), so a reference that picked its
own sets would judge its own choices, not the program's tokens. The
reference therefore follows the program's state where the method chooses:
it attends over the key positions the program kept in each layer and cache
head, and propagates the token set the program's TSP layer chose. It
checks those choices by themselves: every layer also returns its own
scores (``scores``), against which the program's choice is judged
(``perfbench.check``), and its own top-k sets (``own_keep``, ``own_tsp``),
which is what the control judges when a lower precision runs in the
program's place.

``precision``: ``"float32"`` (TF32 off), or ``"float8"``, the control: every
matrix product's operands rounded to float8 e4m3 with a scale per row of
activations and per output column of weights, as an fp8 path would.

Semantics kept from the method as published and run:
  * RoPE (rotate-half, HF's float32 angles) at the original positions;
  * causal attention in layout order, a sliding window counted in layout
    entries (the post-TSP sequence is handed to attention contiguously);
  * observation-window scores: the last W rows' causal softmax over every
    earlier position (no window term), summed over the rows; columns of the
    window and padding score 0 and cannot be selected;
  * max pooling (kernel 7, stride 1, -inf padding) over layout order, a sum
    over each kv head's query heads, top-k by a stable descending sort
    (ties to the lower index), budgets floor(n * rate) in float32;
  * decode: token t at position n + t attends to its cache head's kept
    entries and to the decoded tokens up to itself; under a window only the
    last W entries in cache order.
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
    positions cache head h of layer l holds, in slot order; ``tsp`` the
    positions the TSP layer hands on, ascending (None for FullKV)."""

    kept: List[List[torch.Tensor]]
    tsp: Optional[torch.Tensor]


class LayerScores(NamedTuple):
    """One layer's selection inputs as the reference computes them."""

    positions: torch.Tensor  # [s] layout positions
    scores: torch.Tensor  # [CH, s] pooled, group-summed; -inf where not selectable
    budget: int  # non-window tokens a cache head keeps
    own_keep: List[torch.Tensor]  # per cache head: the reference's own kept positions


class RefResult(NamedTuple):
    logits: torch.Tensor  # [m, V] float32: row i predicts served token i
    layers: List[LayerScores]
    tsp_scores: Optional[torch.Tensor]  # [s] summed over kv heads; -inf where not selectable
    tsp_budget: int
    own_tsp: Optional[torch.Tensor]  # the reference's own TSP positions, ascending


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


class Model:
    """The decoder's arithmetic at one precision over the benchmark's weights."""

    def __init__(self, weights: Dict, cfg: dict, precision: str = "float32"):
        if precision not in ("float32", "float8"):
            raise ValueError(f"precision {precision!r}")
        self.w, self.cfg, self.fp8 = weights, cfg, precision == "float8"
        d = cfg["head_dim"]
        dev = weights["embed"].device
        self.inv_freq = 1.0 / (cfg["rope_theta"] ** (
            torch.arange(0, d, 2, dtype=torch.int64, device=dev).float() / d))
        self.eps = cfg["rms_norm_eps"]

    def layer(self, l: int) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in self.w["layers"].items():
            t = v[l].to(torch.float32)
            if self.fp8 and t.dim() == 2:
                t = _fp8(t, 0)  # a scale per output column
            out[k] = t
        return out

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            x = _fp8(x, -1)  # a scale per row
        return x @ w

    def rms(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + self.eps) * g.float()

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x [heads, s, d] at positions pos [s]."""
        ang = pos.float()[:, None] * self.inv_freq[None, :]
        emb = torch.cat([ang, ang], dim=-1)
        cos, sin = emb.cos(), emb.sin()
        h = x.shape[-1] // 2
        rot = torch.cat([-x[..., h:], x[..., :h]], dim=-1)
        return x * cos + rot * sin

    def qkv(self, lp, x: torch.Tensor, pos: torch.Tensor):
        """x [s, D] -> q [H, s, d], k, v [KH, s, d] (RoPE on q and k)."""
        cfg = self.cfg
        H, KH, d = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
        xn = self.rms(x, lp["ln_attn"])
        s = x.shape[0]
        q = self.mm(xn, lp["wq"]).view(s, H, d).transpose(0, 1)
        k = self.mm(xn, lp["wk"]).view(s, KH, d).transpose(0, 1)
        v = self.mm(xn, lp["wv"]).view(s, KH, d).transpose(0, 1)
        q, k = self.rope(q, pos), self.rope(k, pos)
        if self.fp8:
            q, k, v = _fp8(q, -1), _fp8(k, -1), _fp8(v, -1)
        return q, k, v

    def out_mlp(self, lp, x: torch.Tensor, attn: torch.Tensor, rows: int = 4096) -> torch.Tensor:
        """x + attn-out, then + MLP, over row blocks; attn [H, s, d]."""
        s = x.shape[0]
        a = attn.transpose(0, 1).reshape(s, -1)
        out = torch.empty_like(x)
        for r0 in range(0, s, rows):
            h = x[r0:r0 + rows] + self.mm(a[r0:r0 + rows], lp["wo"])
            hn = self.rms(h, lp["ln_mlp"])
            g = self.mm(hn, lp["w_gate"])
            u = self.mm(hn, lp["w_up"])
            out[r0:r0 + rows] = h + self.mm(F.silu(g) * u, lp["w_down"])
        return out

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        hn = self.rms(h, self.w["final_norm"])
        return self.mm(hn, self.w["lm_head"].to(torch.float32)
                       if not self.fp8 else _fp8(self.w["lm_head"].to(torch.float32), 0))


def causal_attention(q, k, v, window: Optional[int], block: int = 512) -> torch.Tensor:
    """q [H, s, d], k/v [KH, s, d] in layout order -> [H, s, d]; query i sees
    keys j <= i (and j > i - window)."""
    H, s, d = q.shape
    KH = k.shape[0]
    g = H // KH
    out = torch.empty_like(q)
    scale = d ** -0.5
    for r0 in range(0, s, block):
        r1 = min(r0 + block, s)
        c0 = 0 if window is None else max(0, r0 - window + 1)
        qb = q[:, r0:r1].reshape(KH, g * (r1 - r0), d)
        logits = torch.matmul(qb, k[:, c0:r1].transpose(1, 2)).view(KH, g, r1 - r0, r1 - c0)
        rows = torch.arange(r0, r1, device=q.device)[:, None]
        cols = torch.arange(c0, r1, device=q.device)[None, :]
        vis = cols <= rows
        if window is not None:
            vis = vis & (cols > rows - window)
        logits = logits.mul_(scale).masked_fill_(~vis, NEG)
        p = torch.softmax(logits, dim=-1).view(KH, g * (r1 - r0), r1 - c0)
        out[:, r0:r1] = torch.matmul(p, v[:, c0:r1]).view(H, r1 - r0, d)
    return out


def window_scores(q, k, positions: torch.Tensor, n: int, W: int, groups: int) -> torch.Tensor:
    """Pooled, group-summed observation-window scores [KH, s]: -inf on the
    columns that cannot be selected (the last W positions of the prompt)."""
    H, s, d = q.shape
    KH = k.shape[0]
    qw = q[:, s - W:]  # the last W rows of the layout
    logits = torch.matmul(qw.reshape(KH, groups * W, d), k.transpose(1, 2))
    logits = logits.view(H, W, s) * d ** -0.5
    qpos = positions[s - W:]
    vis = positions[None, :] <= qpos[:, None]  # [W, s] causal by position, no window
    p = torch.softmax(logits.masked_fill(~vis, NEG), dim=-1)
    raw = p.sum(dim=1)  # [H, s]
    selectable = positions < n - W
    raw = torch.where(selectable[None], raw, NEG)
    pooled = F.max_pool1d(raw[:, None], 7, stride=1, padding=3)[:, 0]
    summed = pooled.view(KH, groups, s).sum(dim=1)
    return torch.where(selectable[None], summed, NEG)


def topk_positions(scores: torch.Tensor, positions: torch.Tensor, k: int) -> torch.Tensor:
    """The positions of the k best selectable scores, ties to the lower index."""
    k = min(k, int(torch.isfinite(scores).sum()))
    order = torch.sort(scores, descending=True, stable=True).indices[:k]
    return positions[order]


def floor_rate(n: int, rate: float) -> int:
    return int(math.floor(torch.tensor(float(n), dtype=torch.float32)
                          * torch.tensor(rate, dtype=torch.float32)))


def budget(n: int, rate: float, W: int) -> int:
    return max(min(floor_rate(n, rate), n) - W, 0)


def run(weights: Dict, cfg: dict, method: dict, prompt: Sequence[int], served: Sequence[int],
        follow: Follow, precision: str = "float32") -> RefResult:
    """Prefill ``prompt``, then decode the served tokens by teacher forcing,
    over the program's kept sets and TSP set; returns the logits before
    each served token and the reference's own view of every selection."""
    if method["method"] != "fastkv":
        raise ValueError("the reference runs FastKV")
    if precision == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    m = Model(weights, cfg, precision)
    dev = weights["embed"].device
    L = cfg["num_hidden_layers"]
    H, KH = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    g = H // KH
    W, T = method["window_size"], method["tsp_idx"]
    win = cfg.get("sliding_window")
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
        for l in range(L):
            lp = m.layer(l)
            q, k, v = m.qkv(lp, h, pos)
            attn = causal_attention(q, k, v, win)
            s = pos.shape[0]
            post = l > T
            sc = window_scores(q, k, pos, n, W, g)
            rate = method["retain_rate"] / method["tsp_rate"] if post else method["retain_rate"]
            kb = budget(s, rate, W)
            own = [topk_positions(sc[c], pos, kb) for c in range(KH)]
            layers.append(LayerScores(pos, sc, kb, own))
            idx = [torch.searchsorted(pos, follow.kept[l][c].to(dev)) for c in range(KH)]
            kept_kv.append([(k[c, i], v[c, i]) for c, i in enumerate(idx)])
            h = m.out_mlp(lp, h, attn)
            del q, k, v, attn, lp
            if l == T:
                tsp_scores = sc.sum(dim=0)
                sel = pos < n - W
                tsp_scores = torch.where(sel, tsp_scores, NEG)
                tsp_b = budget(n, method["tsp_rate"], W)
                top = topk_positions(tsp_scores, pos, tsp_b)
                own_tsp = torch.sort(torch.cat([top, pos[max(n - W, 0):]])).values
                keep_idx = torch.searchsorted(pos, follow.tsp.to(dev))
                h, pos = h[keep_idx], pos[keep_idx]
        rows = [m.logits(h[-1:])]
        served = list(served)
        if len(served) > 1:
            rows.append(_decode(m, cfg, kept_kv, served[:-1], n, win))
        logits = torch.cat(rows, dim=0)
    return RefResult(logits, layers, tsp_scores, tsp_b, own_tsp)


def _decode(m: Model, cfg: dict, kept_kv, fed: Sequence[int], n: int,
            win: Optional[int]) -> torch.Tensor:
    """Teacher-forced decode: token i of ``fed`` at position n + i -> logits [len(fed), V]."""
    dev = m.w["embed"].device
    H, KH, d = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    g = H // KH
    t = len(fed)
    ids = torch.tensor(list(fed), dtype=torch.long, device=dev)
    h = m.w["embed"][ids].to(torch.float32)
    if m.fp8:
        h = _fp8(h, -1)
    pos = n + torch.arange(t, device=dev)
    for l in range(cfg["num_hidden_layers"]):
        lp = m.layer(l)
        q, k, v = m.qkv(lp, h, pos)  # q [H, t, d], k/v [KH, t, d]
        attn = torch.empty_like(q)
        for c in range(KH):
            kk, vv = kept_kv[l][c]
            c0 = kk.shape[0]
            keys = torch.cat([kk, k[c]], dim=0)
            vals = torch.cat([vv, v[c]], dim=0)
            rank = torch.arange(c0 + t, device=dev)[None, :]
            row = torch.arange(t, device=dev)[:, None]
            vis = rank < c0 + row + 1  # the kept entries and decoded tokens up to itself
            if win is not None:
                vis = vis & (rank > c0 + row - win)
            qc = q[c * g:(c + 1) * g]  # [g, t, d]
            lg = torch.matmul(qc, keys.T) * d ** -0.5
            p = torch.softmax(lg.masked_fill(~vis[None], NEG), dim=-1)
            attn[c * g:(c + 1) * g] = torch.matmul(p, vals)
        h = m.out_mlp(lp, h, attn)
    return m.logits(h)
