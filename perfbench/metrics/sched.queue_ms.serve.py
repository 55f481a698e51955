"""sched.queue_ms.serve: the mean time the window's served requests waited
in the Scheduler's queue (``Request.admitted_at - submitted_at``), in ms,
over those admitted before the traced stretch began: the profiler's stop
leaves a backlog behind it (``perfbench.sched_gaps`` cuts there too)."""


def read(rec):
    if rec["loop"] != "open":
        return None
    until = min((a for a, _ in rec.get("traced_host", [])), default=float("inf"))
    waits = [r.req.admitted_at - r.req.submitted_at for r in rec["requests"]
             if r.req is not None and 0.0 < getattr(r.req, "admitted_at", 0.0) < until]
    if not waits:
        return None
    return 1000.0 * sum(waits) / len(waits)
