"""Replays of the train step's CUDA graph per step: the program's
``unet.train.graph`` spans inside the traced epoch (``bench.epoch``),
over its steps; nothing where the program records no such span."""

from harness.program_spans import inside, spans

GRAPH = "unet.train.graph"


def read(r):
    if r.trace is None or r.kind != "train_epochs" or not r.counts["steps"]:
        return None
    n = len(inside(spans(r.trace), GRAPH, r.trace.spans("bench.epoch")))
    return n / r.counts["steps"] if n else None
