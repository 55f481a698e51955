"""tpot_ms: time per output token after the first: all decode time of the
window's finished requests over all their tokens after the first, on the
harness's clock (stalls for other requests' admissions included)."""


def read(rec):
    done = [r for r in rec["requests"]
            if r.end is not None and r.first is not None and not r.traced and len(r.tokens) > 1]
    steps = sum(len(r.tokens) - 1 for r in done)
    if not steps:
        return None
    return 1000.0 * sum(r.end - r.first for r in done) / steps
