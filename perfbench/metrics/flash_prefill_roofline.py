"""flash_prefill_roofline: the flash prefill kernel's share of its bound
in the traced request's prefill: the mean least time of a layer's call
(the FLOPs of the causal, window-limited pairs of the true prompt at each
layer's length, or its bytes, at the card's peaks; counted by the
configuration's architecture through ``perfbench.work``) over
the mean device time of the kernels named below."""

from perfbench import work
from perfbench.trace import kernel_durations

KERNELS = ("flash_prefill_sm90_kernel", "flash_prefill_kernel")


def read(rec):
    tr = rec["trace"]
    traced = [r for r in rec["requests"] if r.traced]
    if tr is None or not tr.recorded or not traced:
        return None
    lo, hi = tr.window
    gen = [s for s in rec["spans"] if s.name == "generate" and lo <= s.start and s.end <= hi]
    dec = [s for s in rec["spans"] if s.name == "decode" and lo <= s.start and s.end <= hi]
    if not gen or not dec:
        return None
    durs = kernel_durations(tr.device, KERNELS, gen[0].start, dec[0].start)
    calls = work.flash_calls(rec["cfg"], rec["method"], len(traced[0].prompt), rec["arch"])
    if not durs or not calls:
        return None
    bound = sum(work.least_seconds(f, b) for f, b in calls) / len(calls)
    return work.share(bound, sum(durs) / 1e9 / len(durs))
