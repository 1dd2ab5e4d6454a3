"""Kernels launched per train step over the traced epoch's steps (the
span ``bench.epoch``)."""


def read(r):
    if r.trace is None or r.kind != "train_epochs" or not r.counts["steps"]:
        return None
    n = 0
    for lo, hi in r.trace.spans("bench.epoch"):
        n += sum(1 for s, e, _, k, _, _ in r.trace.in_window(lo, hi)
                 if k == "kernel" and s >= lo)
    return n / r.counts["steps"]
