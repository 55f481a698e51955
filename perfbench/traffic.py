"""The one traffic generator: every mix is a data file ``traffic/<name>.json``
of parameters that this module reads.

A mix fixes the loop (``closed``: one client sends its next request when
the last one returned; ``open``: requests are due on a schedule whatever the
system does), the distributions of prompt and output lengths, the arrival
rate of an open loop, and the server's settings that shape the cell
(``engine``: EngineConfig fields; ``scheduler``: Scheduler arguments).

Every seed gets the same set of sizes and gaps, in another order: sizes are
the distribution's quantiles at (i + 1/2) / K for K ``strata`` (or for the
K requests an open window holds), and gaps the exponential distribution's,
so a seed changes which tokens are sent and in what order, never how much
work a run holds. In an open loop the order is one fixed sequence of
(gap, prompt, output) that every seed shares, turned by a phase drawn from
the seed: how the load bunches sets the queue, and with an order drawn per
seed a seed's mean TTFT read 0.39-0.59 s where two runs of one seed
differed by 0.03-0.06 s. Token ids are uniform over the vocabulary, from
the seed.

Distributions: ``{"dist": "fixed", "value": v}``, ``{"dist": "uniform",
"lo": a, "hi": b}`` (integers, both ends included), ``{"dist": "lognormal",
"median": m, "sigma": s, "lo": a, "hi": b}`` (clipped to [a, b]).
"""

from __future__ import annotations

import json
import math
import statistics
from pathlib import Path
from typing import Iterator, List, NamedTuple

import numpy as np


class Req(NamedTuple):
    index: int
    due_s: float  # seconds after the window opens (0 in a closed loop)
    prompt: List[int]
    new_tokens: int


def load(root: Path, name: str) -> dict:
    return json.loads((Path(root) / "perfbench" / "traffic" / f"{name}.json").read_text())


def quantile(dist: dict, u: float) -> int:
    """The distribution's value at quantile u in (0, 1), as an integer."""
    kind = dist["dist"]
    if kind == "fixed":
        return int(dist["value"])
    if kind == "uniform":
        lo, hi = dist["lo"], dist["hi"]
        return min(hi, lo + int(u * (hi - lo + 1)))
    if kind == "lognormal":
        z = statistics.NormalDist().inv_cdf(u)
        x = dist["median"] * math.exp(dist["sigma"] * z)
        return int(min(max(round(x), dist["lo"]), dist["hi"]))
    raise ValueError(f"unknown distribution {kind!r}")


def sizes(dist: dict, k: int) -> List[int]:
    return [quantile(dist, (i + 0.5) / k) for i in range(k)]


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 63), *stream])


def _prompt(seed: int, index: int, n: int, vocab: int) -> List[int]:
    return _rng(seed, 1, index).integers(0, vocab, size=n).tolist()


def closed_requests(mix: dict, seed: int, vocab: int) -> Iterator[Req]:
    """An endless closed-loop sequence: each round of ``strata`` requests
    holds every stratum's size once, in an order drawn from the seed."""
    k = mix["strata"]
    prompts, outs = sizes(mix["prompt"], k), sizes(mix["new_tokens"], k)
    i, rnd = 0, 0
    while True:
        order = _rng(seed, 2, rnd).permutation(k)
        for j in order:
            yield Req(i, 0.0, _prompt(seed, i, prompts[j], vocab), outs[j])
            i += 1
        rnd += 1


def open_schedule(mix: dict, seed: int, vocab: int, seconds: float) -> List[Req]:
    """The requests due in an open window of ``seconds``: rate * seconds of
    them, their gaps the exponential quantiles at the mix's rate and their
    sizes the quantiles of each distribution, in the one shuffled sequence
    every seed shares. The sequence is laid on a circle as long as the
    window and turned by a phase drawn from the seed, so every seed holds
    all of it, bunched alike."""
    rate = mix["rate_per_s"]
    k = max(1, int(round(rate * seconds)))
    fixed = np.random.default_rng(0)
    gaps = np.array([-math.log(1.0 - (i + 0.5) / k) / rate for i in range(k)])[fixed.permutation(k)]
    prompts = np.array(sizes(mix["prompt"], k))[fixed.permutation(k)]
    outs = np.array(sizes(mix["new_tokens"], k))[fixed.permutation(k)]
    at = (np.cumsum(gaps) / gaps.sum() + _rng(seed, 3).random()) % 1.0
    order = np.argsort(at, kind="stable")
    return [Req(i, float(seconds * at[j]), _prompt(seed, i, int(prompts[j]), vocab), int(outs[j]))
            for i, j in enumerate(order)]
