"""decode.graph_share: the share of the traced stretch's ``decode.step``
spans that replayed a captured CUDA graph (the count ``graph`` 1) rather
than launching the step eagerly (0). None where no span carries the count
(a program that has none)."""

from perfbench.program_spans import inside


def read(rec):
    steps = [s for s in inside(rec, "decode.step") if "graph" in s.counts]
    if not steps:
        return None
    return sum(s.counts["graph"] == 1 for s in steps) / len(steps)
