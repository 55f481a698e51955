"""sched.admit_device_ms.serve: the mean device busy time of the Scheduler's
``sched.admit_step`` spans in the traced stretch, in ms: the length of the
union of the device trace's operations from the step's entry until the
stream reached its exit (the later of the span's host exit and its entry
plus its CUDA-event time). An admission step follows a decode step, which
ends by reading its tokens to the host, so the stream is idle at the step's
entry and what runs in that stretch is the step's own work; the device's
idle time inside the step does not count."""

from perfbench.program_spans import inside
from perfbench.trace import busy_ns


def read(rec):
    tr = rec["trace"]
    steps = inside(rec, "sched.admit_step")
    if tr is None or not tr.recorded or not steps or any(s.device_ms is None for s in steps):
        return None
    busy = [busy_ns(tr.device, s.start_ns, max(s.end_ns, s.start_ns + int(s.device_ms * 1e6)))
            for s in steps]
    return sum(busy) / len(busy) / 1e6
