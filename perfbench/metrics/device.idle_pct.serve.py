"""device.idle_pct.serve: share of the traced stretch of the Scheduler's
loop (``run.TRACE_ITERATIONS`` iterations from ``run.TRACE_AT`` of the
window) with nothing running on the device."""

from perfbench.trace import idle_pct


def read(rec):
    tr = rec["trace"]
    if tr is None or not tr.recorded:
        return None
    return idle_pct(tr.device, *tr.window)
