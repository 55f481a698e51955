"""step.mfu.prefill: the prefill's share of the card's bf16 peak: the FLOPs
the true prompts need (every projection, MLP and attention pair at each
layer's length, the window respected, the LM head once; bucket padding is
no work; counted by the configuration's architecture through
``perfbench.work``) over the window's time to first token times
989 TFLOP/s, summed over the untraced requests of a closed loop."""

from perfbench import work


def read(rec):
    if rec["loop"] != "closed":
        return None
    done = [r for r in rec["requests"] if r.first is not None and not r.traced]
    t = sum(r.first - r.start for r in done)
    if not done or t <= 0:
        return None
    flops = sum(work.prefill_flops(rec["cfg"], rec["method"], len(r.prompt), rec["arch"])
                for r in done)
    return 100.0 * flops / (t * work.PEAK_BF16_FLOPS)
