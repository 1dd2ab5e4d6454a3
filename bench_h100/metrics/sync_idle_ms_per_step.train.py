"""Device idle ms per train step in the gaps inside the traced epoch
(``bench.epoch``) that begin under the program's ``unet.sync`` span (the
innermost program span open on the host at the gap's first
nanosecond), over its steps."""

from harness.program_spans import sync_idle_ns


def read(r):
    if r.trace is None or r.kind != "train_epochs" or not r.counts["steps"]:
        return None
    ns = sync_idle_ns(r.trace, "bench.epoch")
    return None if ns is None else ns / 1e6 / r.counts["steps"]
