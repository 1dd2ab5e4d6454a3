"""Host syncs per train step: the program's ``unet.sync`` spans inside
the traced epoch (``bench.epoch``), over its steps."""

from harness.program_spans import sync_count


def read(r):
    if r.trace is None or r.kind != "train_epochs" or not r.counts["steps"]:
        return None
    n = sync_count(r.trace, "bench.epoch")
    return None if n is None else n / r.counts["steps"]
