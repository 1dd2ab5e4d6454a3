"""``metrics/train_graph_replays_per_step.train.py`` on traces made by
hand: the ``unet.train.graph`` spans inside ``bench.epoch`` over the
steps, and nothing where the program records no such span (an eager
step, or a program without the graph)."""

from harness import common
from harness.reader_input import Readings
from harness.trace import Trace

NAME = "train_graph_replays_per_step.train"


def _span(s, e, name):
    return (s, e, name, "user_annotation", 1, 0)


def _readings(graph_steps, kind="train_epochs"):
    host = [_span(0, 9000, "bench.traced"), _span(0, 6000, "bench.epoch"),
            _span(6000, 9000, "bench.val_pass")]
    for k, lo in enumerate((0, 3000)):
        host.append(_span(lo + 10, lo + 2900, "unet.train.step"))
        host.append(_span(lo + 20, lo + 900, "unet.train.graph"
                          if k < graph_steps else "unet.train.forward"))
    host.append(_span(6100, 6200, "unet.train.graph"))  # outside the epoch
    dev = [(0, 9000, "k", "kernel", 0, 0)]
    return Readings(kind=kind, dtype="bfloat16", flops_per_patch=1,
                    convs=[], trace=Trace(dev, sorted(host), (0, 9000)),
                    counts={"steps": 2, "train_patches": 64, "val_passes": 1,
                            "val_patches": 144})


def _read(r):
    return common.metric_reader(NAME).read(r)


def test_replays_per_step_inside_the_epoch():
    assert _read(_readings(2)) == 1.0
    assert _read(_readings(1)) == 0.5


def test_no_graph_span_reads_nothing():
    assert _read(_readings(0)) is None
    assert _read(_readings(2, kind="eval_split")) is None
