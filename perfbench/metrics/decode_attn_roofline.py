"""decode_attn_roofline: the decode-attention kernel's share of
its bound in the traced request: the mean least time of a call (q, the
live K/V rows of every cache head read once, the output written, at 3.35
TB/s; the live rows from the method's budgets, each counted by the
configuration's architecture through ``perfbench.work``) over the
mean device time of the kernels named below. The work does not depend on
which kernel runs."""

from perfbench import work
from perfbench.trace import kernel_durations

KERNELS = ("decode_attn_tc_kernel",)


def read(rec):
    tr = rec["trace"]
    traced = [r for r in rec["requests"] if r.traced]
    if tr is None or not tr.recorded or not traced:
        return None
    r = traced[0]
    lo, hi = tr.window
    spans = [s for s in rec["spans"] if s.name == "decode" and lo <= s.start and s.end <= hi]
    if not spans:
        return None
    durs = kernel_durations(tr.device, KERNELS, spans[0].start, spans[0].end)
    cfg, method, arch = rec["cfg"], rec["method"], rec["arch"]
    kept = work.kept_per_layer(cfg, method, len(r.prompt))
    ch = work.cache_rows(cfg, arch)
    bounds = [work.decode_attn_bytes(cfg, [ch * (k + t + 1)], arch=arch) / work.PEAK_BYTES
              for t in range(len(r.tokens) - 1) for k in kept]
    if not durs or not bounds:
        return None
    return work.share(sum(bounds) / len(bounds), sum(durs) / 1e9 / len(durs))
