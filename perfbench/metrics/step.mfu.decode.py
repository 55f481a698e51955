"""step.mfu.decode: the decode step's share of the card's roofline: per
step the larger of its FLOPs over 989 TFLOP/s and its bytes (every layer's
weights and the LM head read once, the live cache; counted by the
configuration's architecture through ``perfbench.work``)
over 3.35 TB/s, summed over the untraced requests' steps, over their
decode time on the harness's clock."""

from perfbench import work


def read(rec):
    if rec["loop"] != "closed":
        return None
    done = [r for r in rec["requests"]
            if r.end is not None and r.first is not None and not r.traced and len(r.tokens) > 1]
    t = sum(r.end - r.first for r in done)
    if not done or t <= 0:
        return None
    cfg, method, arch = rec["cfg"], rec["method"], rec["arch"]
    ch = work.cache_rows(cfg, arch)
    least = 0.0
    for r in done:
        kept = work.kept_per_layer(cfg, method, len(r.prompt))
        for step in range(len(r.tokens) - 1):
            f, b = work.decode_step_work(cfg, [ch * (k + step + 1) for k in kept], arch=arch)
            least += work.least_seconds(f, b)
    return work.share(least, t)
