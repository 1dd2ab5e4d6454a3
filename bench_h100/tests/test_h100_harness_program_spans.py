"""The readers of the program's spans (``harness/program_spans.py`` and
the six ``metrics/`` files that use it) on traces made by hand: known
spans and device events give known counts, idle ms and host us, and a
window without a ``unet.`` span reads as nothing."""

from harness import common, program_spans
from harness.reader_input import Readings
from harness.trace import Trace

EVAL = ("host_syncs_per_split.eval", "sync_idle_ms_per_image.eval",
        "conv3x3_host_us_per_call.eval")
TRAIN = ("host_syncs_per_step.train", "sync_idle_ms_per_step.train",
         "conv3x3_host_us_per_call.val")


def _span(s, e, name):
    return (s, e, name, "user_annotation", 1, 0)


def _kernel(s, e):
    return (s, e, "k", "kernel", 0, 0)


def _eval_trace(program=True):
    host = [_span(0, 10000, "bench.traced"), _span(100, 5000, "bench.split"),
            (120, 130, "aten::add", "cpu_op", 1, 0)]
    if program:
        host += [
            _span(110, 4900, "unet.eval"),
            _span(200, 300, "unet.sync"),          # a copy in
            _span(900, 1600, "unet.eval.auc"),
            _span(1000, 1500, "unet.sync"),        # an AUC's read
            _span(2000, 2040, "unet.kernel1"),
            _span(2100, 2180, "unet.kernel1"),
            _span(6000, 6100, "unet.sync"),        # outside the split
        ]
    # idle: [0, 50) none, [210, 400) sync, [1100, 1550) sync,
    # [1560, 1600) auc, [9000, 9500) none
    dev = [_kernel(50, 210), _kernel(400, 1100), _kernel(1550, 1560),
           _kernel(1600, 9000), _kernel(9500, 10000)]
    return Trace(sorted(dev), sorted(host), (0, 10000))


def _eval_readings(trace):
    return Readings(kind="eval_split", dtype="bfloat16", flops_per_patch=1,
                    convs=[], trace=trace,
                    counts={"splits": 1, "images": 2, "patches": 4,
                            "chunks": [4]})


def _train_trace(program=True, syncs=True):
    host = [_span(0, 9000, "bench.traced"), _span(0, 6000, "bench.epoch"),
            _span(6000, 9000, "bench.val_pass")]
    if program:
        for lo in (0, 3000):
            host += [_span(lo + 10, lo + 2900, "unet.train.step"),
                     _span(lo + 1000, lo + 2000, "unet.train.nan_guard")]
            if syncs:
                host.append(_span(lo + 1000, lo + 1900, "unet.sync"))
        host += [_span(6100, 8900, "unet.val"),
                 _span(6200, 6300, "unet.kernel1"),
                 _span(6400, 6420, "unet.kernel1"),
                 _span(6500, 6600, "unet.kernel1")]
    # idle in the epoch: [1200, 1800) and [4500, 4700) under the syncs,
    # [2950, 3100) under none; in the validation pass [7000, 8000)
    dev = [_kernel(0, 1200), _kernel(1800, 2950), _kernel(3100, 4500),
           _kernel(4700, 7000), _kernel(8000, 9000)]
    return Trace(sorted(dev), sorted(host), (0, 9000))


def _train_readings(trace):
    return Readings(kind="train_epochs", dtype="bfloat16", flops_per_patch=1,
                    convs=[], trace=trace,
                    counts={"steps": 2, "train_patches": 64, "val_passes": 1,
                            "val_patches": 144})


def _read(name, r):
    return common.metric_reader(name).read(r)


def test_innermost_span_at_each_time():
    program = program_spans.spans(_eval_trace())
    assert program_spans.innermost(program, [50, 250, 1001, 1550, 1700,
                                             2020, 5500, 6050]) == [
        None, "unet.sync", "unet.sync", "unet.eval.auc", "unet.eval",
        "unet.kernel1", None, "unet.sync"]


def test_eval_readers_on_a_hand_trace():
    r = _eval_readings(_eval_trace())
    assert _read("host_syncs_per_split.eval", r) == 2.0
    # the gaps that begin under a sync: 190 + 450 ns over 2 images
    assert abs(_read("sync_idle_ms_per_image.eval", r)
               - 640 / 1e6 / 2) < 1e-15
    assert abs(_read("conv3x3_host_us_per_call.eval", r) - 0.06) < 1e-12
    assert _read("conv3x3_host_us_per_call.val", r) is None  # eval cell


def test_train_readers_on_a_hand_trace():
    r = _train_readings(_train_trace())
    assert _read("host_syncs_per_step.train", r) == 1.0
    assert abs(_read("sync_idle_ms_per_step.train", r)
               - 800 / 1e6 / 2) < 1e-15
    assert abs(_read("conv3x3_host_us_per_call.val", r)
               - (100 + 20 + 100) / 3 / 1e3) < 1e-12
    assert _read("host_syncs_per_split.eval", r) is None  # train cell


def test_program_spans_without_a_sync_read_zero():
    r = _train_readings(_train_trace(syncs=False))
    assert _read("host_syncs_per_step.train", r) == 0.0
    assert _read("sync_idle_ms_per_step.train", r) == 0.0


def test_a_window_without_program_spans_reads_nothing():
    for name in EVAL:
        assert _read(name, _eval_readings(_eval_trace(program=False))) is None
    for name in TRAIN:
        assert _read(name, _train_readings(
            _train_trace(program=False))) is None
    for name in EVAL + TRAIN:
        assert _read(name, _eval_readings(None)) is None
