"""The Scheduler's decode-to-decode intervals, from its events log: each
("decode", t) stamp is taken after the step's tokens reached the host, and
("prefill" | "chunk" | "finish", id) entries mark admission work done
between two steps. Intervals from the profiled stretch on are left out:
the profiler's stop holds the loop for seconds, and the backlog it leaves
would read as admission gaps."""

from typing import List, Tuple

ADMISSIONS = ("prefill", "chunk", "finish")


def intervals(rec) -> List[Tuple[float, bool]]:
    """(seconds, whether an admission step lies inside) per interval."""
    out, last, admitted = [], None, False
    until = min((a for a, _ in rec.get("traced_host", [])), default=float("inf"))
    for kind, val in rec.get("events", []):
        if kind == "decode":
            if val > until:
                break
            if last is not None:
                out.append((val - last, admitted))
            last, admitted = val, False
        elif kind in ADMISSIONS:
            admitted = True
    return out
