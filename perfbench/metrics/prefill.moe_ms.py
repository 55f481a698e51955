"""prefill.moe_ms: the summed device ms of the traced request's
``prefill.moe`` spans (one an expert layer: the router, the routed experts'
products over their rows and the shared experts): CUDA events on the stream
at each span's entry and exit. None where the program records no such span."""

from perfbench.program_spans import of_traced_call


def read(rec):
    ms = [s.device_ms for s in of_traced_call(rec, "prefill.moe")]
    if not ms or None in ms:
        return None
    return sum(ms)
