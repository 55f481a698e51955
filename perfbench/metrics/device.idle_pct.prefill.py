"""device.idle_pct.prefill: share of the traced request's prefill (from
the harness's call into Engine.generate to the start of its decode loop)
with nothing running on the device."""

from perfbench.trace import idle_pct


def read(rec):
    tr = rec["trace"]
    if tr is None or not tr.recorded:
        return None
    lo, hi = tr.window
    gen = [s for s in rec["spans"] if s.name == "generate" and lo <= s.start and s.end <= hi]
    dec = [s for s in rec["spans"] if s.name == "decode" and lo <= s.start and s.end <= hi]
    if not gen or not dec:
        return None
    return idle_pct(tr.device, gen[0].start, dec[0].start)
