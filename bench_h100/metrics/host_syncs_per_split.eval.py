"""Host syncs per split: the program's ``unet.sync`` spans (each a point
where the host waits for the card) inside the traced splits
(``bench.split``), over the splits."""

from harness.program_spans import sync_count


def read(r):
    if r.trace is None or r.kind != "eval_split" or not r.counts["splits"]:
        return None
    n = sync_count(r.trace, "bench.split")
    return None if n is None else n / r.counts["splits"]
