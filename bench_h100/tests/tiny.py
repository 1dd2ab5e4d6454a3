"""Tiny sizes of the benchmark's traffic, for runs on the CPU: the same
drivers, protocols and checks as a cell on the card, on 48 x 48 images
and 32^2 patches (evaluation) or 96 x 96 images, 64^2 patches and batch
8 (training, so that a batch's mean gradient is steady enough for the
cell's limits)."""

from __future__ import annotations

from harness import common

SEED = 2**31 + 12345  # above 32 signed bits: a run takes any whole number


def traffic(cell_name: str) -> dict:
    cell = common.cell(common.benchmark(), cell_name)
    tr = common.traffic(cell["traffic"])
    if tr["kind"] == "eval_split":
        tr.update(images_per_split=2, height=48, width=48, pool_splits=2,
                  patch=32, inference_batch=4, warmup_splits=1,
                  check_splits=1, trace_start=0, trace_units=1)
    else:
        tr.update(images=4, height=96, width=96, val_percent=0.25, patch=64,
                  batch=8, steps=3, trace_start=0, trace_units=1)
    return tr


def run(cell_name: str, seed: int = SEED, trace: bool = False):
    """(result, checks) of one tiny run of the cell on the CPU, with the
    cell's own limits."""
    from harness.run_cell import run as run_cell

    cell = common.cell(common.benchmark(), cell_name)
    return run_cell(cell, seed, 0.2, trace, "cpu",
                    common.limits(cell_name), traffic=traffic(cell_name))
