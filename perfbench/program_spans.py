"""The program's own spans (``fastkv_tpu_torch.utils.profiling.records``)
inside a run's traced stretch, for the readers in ``perfbench/metrics``.

The program records its spans only while a ``torch.profiler`` session
runs, on the clock of the device trace, so the spans of a run are those of
its traced stretch (``rec["trace"].window``). A program without the
recorder gives no span, and its readers None.
"""

from typing import List, Optional


def inside(rec, name: str) -> List:
    """The spans named ``name`` that lie inside the traced stretch, by start."""
    tr = rec["trace"]
    if tr is None or tr.window is None:
        return []
    try:
        from fastkv_tpu_torch.utils.profiling import records
    except ImportError:
        return []
    lo, hi = tr.window
    return [s for s in records(lo, hi) if s.name == name]


def of_traced_call(rec, name: str) -> List:
    """The spans named ``name`` of the stretch's first ``Engine.generate``
    call (a closed loop's traced request)."""
    calls = inside(rec, "engine.generate")
    if not calls:
        return []
    return [s for s in inside(rec, name) if s.req == calls[0].req]


def mean_ms(spans, device: bool) -> Optional[float]:
    """The spans' mean host duration, or device time, in ms (None for no
    span, or a device time not taken)."""
    ms = [s.device_ms if device else (s.end_ns - s.start_ns) / 1e6 for s in spans]
    if not ms or None in ms:
        return None
    return sum(ms) / len(ms)
