"""Share of the traced evaluation window (whole splits) in which no
kernel, copy or set ran on the card, in %."""


def read(r):
    if r.trace is None or r.kind != "eval_split":
        return None
    lo, hi = r.trace.window
    if hi <= lo:
        return None
    return 100.0 * (1.0 - r.trace.busy_ns() / (hi - lo))
