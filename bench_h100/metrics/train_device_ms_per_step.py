"""Device busy ms per train step over the traced epoch's steps (the span
``bench.epoch``, which ends in a device sync): the union of kernels,
copies and sets, over the steps."""


def read(r):
    if r.trace is None or r.kind != "train_epochs" or not r.counts["steps"]:
        return None
    spans = r.trace.spans("bench.epoch")
    ns = sum(r.trace.busy_ns(lo, hi) for lo, hi in spans)
    return ns / 1e6 / r.counts["steps"]
