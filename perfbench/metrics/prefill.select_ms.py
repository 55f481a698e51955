"""prefill.select_ms: the summed device ms of the traced request's
``prefill.select`` spans, one a layer: the observation-window scores, the
keep-set and the gather of the kept K/V into the cache."""

from perfbench.program_spans import mean_ms, of_traced_call


def read(rec):
    spans = of_traced_call(rec, "prefill.select")
    mean = mean_ms(spans, device=True)
    return None if mean is None else mean * len(spans)
