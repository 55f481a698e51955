"""sched.admit_host_ms.serve: the mean host duration of the Scheduler's
``sched.admit_step`` spans (a monolithic admission's prefill and install,
or one chunk of a chunked admission, with its finish and install on the
last) in the traced stretch. Spans record only under ``torch.profiler``, so
the value holds CUPTI's cost of each launch."""

from perfbench.program_spans import inside, mean_ms


def read(rec):
    return mean_ms(inside(rec, "sched.admit_step"), device=False)
