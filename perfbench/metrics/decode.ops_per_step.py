"""decode.ops_per_step: the device operations (kernels, copies, sets) of the
traced request's decode per step: those starting from the first
``decode.step`` span's start to the end of its ``engine.generate`` span,
over the number of ``decode.step`` spans."""

from perfbench.program_spans import of_traced_call


def read(rec):
    tr = rec["trace"]
    steps = of_traced_call(rec, "decode.step")
    calls = of_traced_call(rec, "engine.generate")
    if tr is None or not tr.recorded or not steps or not calls:
        return None
    lo, hi = steps[0].start_ns, calls[0].end_ns
    return sum(lo <= i.start < hi for i in tr.device) / len(steps)
