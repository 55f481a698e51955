"""itl_p95_ms: the 95th percentile of every inter-token gap of every
request in the window (the first gap from its first token), each token
stamped when it reached the host (open loop only)."""

import statistics


def read(rec):
    if rec["loop"] != "open":
        return None
    gaps = [b - a for r in rec["requests"] for a, b in zip(r.times, r.times[1:])]
    if len(gaps) < 2:
        return None
    return 1000.0 * statistics.quantiles(gaps, n=100)[94]
