"""ttft_s.serve: time to first token in an open loop, the mean over the
window's completed requests, on the harness's clock: from the moment the
request was due (not when it was submitted: a stall delays later arrivals'
submission too) to its first token on the host."""


def read(rec):
    if rec["loop"] != "open":
        return None
    done = [r for r in rec["requests"] if r.first is not None]
    if not done:
        return None
    return sum(r.first - r.start for r in done) / len(done)
