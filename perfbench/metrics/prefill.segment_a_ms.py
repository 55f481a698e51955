"""prefill.segment_a_ms: the device ms of the traced request's
``prefill.segment_a`` span (FastKV's layers before the TSP layer, at the
bucket's rows): CUDA events on the stream at its entry and exit."""

from perfbench.program_spans import mean_ms, of_traced_call


def read(rec):
    spans = of_traced_call(rec, "prefill.segment_a")
    return mean_ms(spans[:1], device=True)
