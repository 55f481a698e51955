"""ttft_s: time to first token in a closed loop, the mean over the window's
completed requests (a traced one left out), on the harness's clock: from
the call into the program to the first token on the host."""


def read(rec):
    if rec["loop"] != "closed":
        return None
    done = [r for r in rec["requests"] if r.first is not None and not r.traced]
    if not done:
        return None
    return sum(r.first - r.start for r in done) / len(done)
