"""sched.admit_gap_ms.serve: the mean of the Scheduler's decode-to-decode
intervals that hold an admission step (a prefill, chunk or finish event in
its events log), before the profiled stretch."""

from perfbench.sched_gaps import intervals


def read(rec):
    gaps = [g for g, admitted in intervals(rec) if admitted]
    if not gaps:
        return None
    return 1000.0 * sum(gaps) / len(gaps)
