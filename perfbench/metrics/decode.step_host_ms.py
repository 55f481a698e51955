"""decode.step_host_ms: the mean host duration of the program's
``decode.step`` spans (``engine.decode.decode_step``, from its call to its
return: the launches of one step, no device sync) in the traced stretch.
Spans record only under ``torch.profiler``, so the value holds CUPTI's cost
of each launch (about 1.4 times the untraced step on the H100): a change
that cuts launches, such as a CUDA graph per step, shows a larger gain here
than in ``tpot_ms``, which judges it."""

from perfbench.program_spans import inside, mean_ms


def read(rec):
    return mean_ms(inside(rec, "decode.step"), device=False)
