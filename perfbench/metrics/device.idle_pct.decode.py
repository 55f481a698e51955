"""device.idle_pct.decode: share of the traced request's decode (the
harness's span around the program's greedy decode loop, which starts after
the prefill's device sync) with nothing running on the device."""

from perfbench.trace import idle_pct


def read(rec):
    tr = rec["trace"]
    if tr is None or not tr.recorded:
        return None
    lo, hi = tr.window
    spans = [s for s in rec["spans"] if s.name == "decode" and lo <= s.start and s.end <= hi]
    if not spans:
        return None
    return idle_pct(tr.device, spans[0].start, spans[0].end)
