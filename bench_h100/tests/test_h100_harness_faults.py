"""Each cell's check must fail on what it exists to catch.  A tiny run on
the CPU drives the whole of a run but the look for a card, with the timed
path broken underneath (the driver's ``FAULTS``, from ``harness.faults``),
and ``correct`` must come out false; so must the control, the plain
reference computed in FP8 put in the program's place.  (Every cell takes
one chip, so there is no exchange between chips to leave out.)"""

import pytest

import readings
import tiny
from harness import common
from harness.run_cell import RunContext

EVAL = ["unet.eval_tiled", "nestedunet.eval_tiled"]
TRAIN = ["unet.train"]


def _faults(cell):
    return common.driver(tiny.traffic(cell)["kind"]).FAULTS


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in EVAL + TRAIN for f in _faults(c)])
def test_fault_is_caught(cell, fault):
    with _faults(cell)[fault]():
        result, checks = tiny.run(cell)
    assert not result["correct"], checks


@pytest.mark.parametrize("cell", EVAL + TRAIN)
def test_control_is_caught(cell):
    c = common.cell(common.benchmark(), cell)
    ctx = RunContext(c, tiny.SEED, "cpu", tiny.traffic(cell))
    kind = ctx.traffic["kind"]
    drv = common.driver(kind).Driver(ctx)
    drv.setup()
    checks = readings.control_checks(drv, kind, ctx.reference_model(),
                                     ctx.reference_model(),
                                     common.limits(cell))
    assert not all(c["ok"] for c in checks), checks
