"""The comparison that decides ``correct``: the program's served tokens and
its selections, each judged against the plain reference.

For each sampled request the reference (``reference/<name>.py``) runs once
over the prompt and the served tokens, following the program's kept sets
and TSP set. The numbers compared, each against its own limit
(``limits/<workload>.json``):

  * ``logit_gap``: the widest gap by which a served token's reference logit
    lies below the reference's best at that position (greedy tokens only);
  * ``keep_regret``: the reference score mass a kept set misses against
    the reference's best k of its layer and cache head, as a share of the
    best k's mass (near-ties that swap places cost nearly nothing; a kept
    position that cannot be selected adds nothing), the worst over layers
    and cache heads;
  * ``tsp_regret``: the same for the TSP layer's hand-on set;
  * ``set_misses``: exact: layers and cache heads whose kept set does not
    hold the reference's budget of selectable tokens plus the whole window,
    or holds a position that layer never saw, and a TSP set of the wrong
    size or without the window (limit 0);
  * ``token_misses``: exact: requests that served another number of tokens
    than they asked for (limit 0).

``judge`` returns the numbers of one request; ``worst`` folds requests.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import torch


def logit_gap(logits: torch.Tensor, served: Sequence[int]) -> float:
    """max over positions of (best reference logit - served token's)."""
    tok = torch.tensor(list(served), dtype=torch.long, device=logits.device)
    best = logits.max(dim=-1).values
    got = logits.gather(1, tok[:, None])[:, 0]
    return float((best - got).max())


def regret(scores: torch.Tensor, positions: torch.Tensor, chosen: torch.Tensor,
           k: int) -> float:
    """1 - (the chosen set's score mass) / (the best k's); a chosen position
    that is not selectable adds nothing."""
    if k <= 0:
        return 0.0
    finite = scores[torch.isfinite(scores)]
    best = torch.topk(finite, min(k, finite.numel())).values.sum()
    idx = torch.searchsorted(positions, chosen).clamp(max=positions.numel() - 1)
    got = scores[idx]
    ok = (positions[idx] == chosen) & torch.isfinite(got)
    return float(1.0 - torch.where(ok, got, 0.0).sum() / best) if best > 0 else 0.0


def judge(ref, served: Sequence[int], asked: int, kept, tsp: Optional[torch.Tensor], n: int,
          window: int) -> Dict[str, float]:
    """The numbers of one request. ``kept[l][h]``: the program's kept
    positions of layer l, cache head h (window included); ``tsp``: its TSP
    set; ``n``: the prompt length. The reference ``ref`` followed them."""
    out = {"logit_gap": logit_gap(ref.logits, served),
           "token_misses": float(len(served) != asked)}
    win = torch.arange(max(n - window, 0), n)
    lost, misses = 0.0, 0
    for l, lay in enumerate(ref.layers):
        dev = lay.positions.device
        w = win.to(dev)
        for c, pos_kept in enumerate(kept[l]):
            pk = pos_kept.to(dev)
            in_win = torch.isin(pk, w)
            chosen = torch.sort(pk[~in_win]).values
            selectable = int(torch.isfinite(lay.scores[c]).sum())
            if (chosen.numel() != min(lay.budget, selectable) or int(in_win.sum()) != w.numel()
                    or not bool(torch.isin(pk, lay.positions).all())):
                misses += 1
            lost = max(lost, regret(lay.scores[c], lay.positions, chosen, lay.budget))
    out["keep_regret"] = lost
    tsp_lost = 0.0
    if ref.tsp_scores is not None:
        dev = ref.tsp_scores.device
        t = tsp.to(dev)
        w = win.to(dev)
        in_win = torch.isin(t, w)
        chosen = t[~in_win]
        pos0 = torch.arange(n, device=dev)
        selectable = int(torch.isfinite(ref.tsp_scores).sum())
        if chosen.numel() != min(ref.tsp_budget, selectable) or int(in_win.sum()) != w.numel():
            misses += 1
        tsp_lost = regret(ref.tsp_scores, pos0, torch.sort(chosen).values, ref.tsp_budget)
    out["tsp_regret"] = tsp_lost
    out["set_misses"] = float(misses)
    return out


def decode_misses(pos: torch.Tensor, valid: torch.Tensor, cap: int, n: int,
                  served: int) -> float:
    """The decoded positions that some cache head of some layer does not
    hold once the request is done: every served token but the last is fed
    back, at positions n .. n + served - 2, and a step keeps its key and
    value. ``pos``, ``valid``: the program's cache [L, CH, C] after its last
    step; slots from ``cap`` on are the decode part."""
    want = torch.arange(n, n + max(served - 1, 0), dtype=torch.long)
    p, v = pos[..., cap:].long(), valid[..., cap:]
    held = ((p[..., None] == want) & v[..., None]).any(dim=2).all(dim=1).all(dim=0)
    return float((~held).sum())


def worst(per_request: Iterable[Dict[str, float]]) -> Dict[str, float]:
    """The worst reading of each number over requests (misses add up)."""
    out: Dict[str, float] = {}
    for rec in per_request:
        for k, v in rec.items():
            if k.endswith("misses"):
                out[k] = out.get(k, 0.0) + v
            else:
                out[k] = max(out.get(k, 0.0), v)
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every limited number read, and at or under its limit. A number with
    no limit is printed and decides nothing."""
    return all(k in numbers and numbers[k] <= lim for k, lim in limits.items())
