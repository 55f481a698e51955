"""prefill.route_ms: the summed device ms of the traced request's
``prefill.route`` spans (the router of each expert layer's row chunks,
inside ``prefill.moe``: the float32 router product, its scores, the
correction bias, the group limit and the top k): CUDA events on the stream
at each span's entry and exit. None where the program records no such span."""

from perfbench.program_spans import of_traced_call


def read(rec):
    ms = [s.device_ms for s in of_traced_call(rec, "prefill.route")]
    if not ms or None in ms:
        return None
    return sum(ms)
