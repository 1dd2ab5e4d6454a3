"""A tiny run of each cell's traffic on the CPU, through the same
drivers, program entry points, reference and checks as on the card.  A
CPU run reports no metric: its timings are not the card's."""

import math

import pytest

import tiny

CELLS = ["unet.eval_tiled", "nestedunet.eval_tiled", "unet.train"]


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_is_correct_and_reports_no_device_metric(cell):
    result, checks = tiny.run(cell, trace=True)
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert result["metrics"] == {}
    assert result["device"]["platform"] == "cpu"
    assert "breakdown" not in result
    assert all(math.isfinite(c["value"]) for c in checks)


def test_same_seed_same_numbers():
    a = [c["value"] for c in tiny.run("unet.train")[1]]
    b = [c["value"] for c in tiny.run("unet.train")[1]]
    assert a == b
