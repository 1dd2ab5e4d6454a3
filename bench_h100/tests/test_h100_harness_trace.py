"""The trace reduction on events made by hand and on a small recorded CPU
capture."""

import torch

from harness.reader_input import Readings
from harness.trace import Trace
from harness import common

CONV = "jcfszxc_unet::conv3x3_affine_relu"


def _hand_trace():
    # host: (start, end, name, kind, thread, correlation)
    host = [
        (0, 1000, "bench.traced", "user_annotation", 1, 1),
        (10, 200, CONV, "cpu_op", 1, 2),
        (20, 30, "cudaLaunchKernel", "cuda_runtime", 1, 100),
        (300, 400, "aten::add", "cpu_op", 1, 3),
        (310, 320, "cudaLaunchKernel", "cuda_runtime", 1, 101),
        (500, 700, "aten::copy_", "cpu_op", 1, 4),
        (510, 520, "cudaMemcpyAsync", "cuda_runtime", 1, 102),
    ]
    # device: (start, end, name, kind, correlation, linked)
    dev = [
        (100, 300, "wgmma_conv::conv_kernel", "kernel", 100, 2),
        (350, 450, "vectorized_elementwise_kernel", "kernel", 101, 3),
        (400, 500, "Memcpy HtoD (Pageable -> Device)", "memcpy", 102, 4),
        (2000, 2100, "late", "kernel", 103, 5),  # outside the window
    ]
    return Trace(sorted(dev), sorted(host), (0, 1000))


def test_busy_idle_and_gaps():
    t = _hand_trace()
    assert t.busy_ns() == 200 + 150          # [100, 300] and [350, 500]
    assert t.idle_gaps() == [(0, 100), (300, 350), (500, 1000)]
    assert t.busy_ns(350, 420) == 70


def test_operator_attribution_and_breakdown():
    t = _hand_trace()
    assert t.op_device_ns(CONV) == (200, 1)
    b = t.breakdown()
    assert b["device_ops"][0] == ["wgmma_conv::conv_kernel", 200e-9]
    assert len(b["device_ops"]) == 3
    # longest first, named by the span and the operator under way
    assert b["idle_gaps"][0] == ["bench.traced / aten::copy_", 500e-9]
    assert b["idle_gaps"][1] == ["bench.traced / python", 100e-9]


def test_readers_on_hand_trace():
    t = _hand_trace()
    r = Readings(kind="eval_split", dtype="bfloat16",
                 flops_per_patch=10**9, convs=[(512, 512, 64, 64)], trace=t,
                 counts={"splits": 1, "images": 2, "patches": 4,
                         "chunks": [4]})
    idle = common.metric_reader("device_idle_share.eval").read(r)
    assert abs(idle - 65.0) < 1e-9          # 350 of 1000 ns busy
    copy = common.metric_reader("host_copy_ms_per_image.eval").read(r)
    assert abs(copy - 100 / 1e6 / 2) < 1e-15
    stock = common.metric_reader("stock_ops_ms_per_image.eval").read(r)
    assert abs(stock - 100 / 1e6 / 2) < 1e-15   # the add, not the conv
    assert common.metric_reader("train_mfu").read(r) is None


def test_recorded_cpu_capture_spans():
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    with torch.profiler.record_function("bench.traced"):
        with torch.profiler.record_function("bench.split"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    prof.stop()
    t = Trace.from_profiler(prof)
    assert len(t.spans("bench.split")) == 1
    lo, hi = t.window
    (slo, shi), = t.spans("bench.split")
    assert lo <= slo <= shi <= hi
    assert t.device == []                 # no card: no device activity
    assert any(n == "aten::matmul" for _, _, n, _, _, _ in t.host)
