"""sched.decode_gap_ms.serve: the median of the Scheduler's
decode-to-decode intervals that hold no admission step (events log),
before the profiled stretch."""

import statistics

from perfbench.sched_gaps import intervals


def read(rec):
    gaps = [g for g, admitted in intervals(rec) if not admitted]
    if not gaps:
        return None
    return 1000.0 * statistics.median(gaps)
