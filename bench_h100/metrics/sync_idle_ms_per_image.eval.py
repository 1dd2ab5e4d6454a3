"""Device idle ms per evaluated image in the gaps that begin under the
program's ``unet.sync`` span (the innermost program span open on the host
at the gap's first nanosecond), over the traced splits."""

from harness.program_spans import sync_idle_ns


def read(r):
    if r.trace is None or r.kind != "eval_split" or not r.counts["images"]:
        return None
    ns = sync_idle_ns(r.trace)
    return None if ns is None else ns / 1e6 / r.counts["images"]
