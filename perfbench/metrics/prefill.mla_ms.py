"""prefill.mla_ms: the summed device ms of the traced request's
``prefill.mla`` spans (one a latent-attention layer: the latent projections,
the ``kv_b`` expansion, RoPE and the flash call): CUDA events on the stream
at each span's entry and exit. None where the program records no such span."""

from perfbench.program_spans import of_traced_call


def read(rec):
    ms = [s.device_ms for s in of_traced_call(rec, "prefill.mla")]
    if not ms or None in ms:
        return None
    return sum(ms)
