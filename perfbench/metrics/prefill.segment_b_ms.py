"""prefill.segment_b_ms: the device ms of the traced request's
``prefill.segment_b`` span (FastKV's layers after the TSP layer, at
``tsp_capacity`` rows, and the LM head): CUDA events on the stream at its
entry and exit."""

from perfbench.program_spans import mean_ms, of_traced_call


def read(rec):
    spans = of_traced_call(rec, "prefill.segment_b")
    return mean_ms(spans[:1], device=True)
