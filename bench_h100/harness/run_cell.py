"""One run of one cell: set-up, the measured window, the check against the
plain reference, the readers, and the result."""

from __future__ import annotations

import gc
import sys
import time

import torch

from harness import common
from harness.model_cost import forward_cost
from harness.reader_input import Readings
from harness.tracer import Tracer
from harness.weights import make_state_dict
from reference.protocol import plain_precision

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class RunContext:
    """What a driver needs of the run: the configuration and traffic, the
    device, the seed, the compute dtype and the weights (a state dict
    under the reference's names, made from the seed)."""

    def __init__(self, cell: dict, seed: int, device, traffic=None):
        self.config = common.config(cell["config"])
        self.traffic = traffic or common.traffic(cell["traffic"])
        self.seed = seed
        self.device = torch.device(device)
        self.dtype_name = self.config["compute_dtype"]
        self.compute_dtype = DTYPES[self.dtype_name]
        self.reference = common.reference_module(self.config["reference"])
        with plain_precision():
            sd = make_state_dict(self.reference.build, self.config, seed,
                                 self.device)
        # The initial weights stay on the host for the reference.
        self.state_dict = {k: v.cpu() for k, v in sd.items()}
        self._sd_device = sd

    def program_model(self):
        """The configuration's model from the program's registry, holding
        the run's weights, on the device in channels_last."""
        from jcfszxc_unet_tpu_torch.models import create_model

        with torch.device(self.device):
            model = create_model(self.config["model"],
                                 **self.config.get("model_kwargs", {}))
        model.load_state_dict(self._sd_device, strict=True)
        self._sd_device = None
        return model.to(memory_format=torch.channels_last)

    def reference_model(self):
        """The plain reference in float32 holding the run's initial
        weights."""
        with torch.device("meta"):
            model = self.reference.build()
        model = model.to_empty(device=self.device)
        model.load_state_dict(self.state_dict, strict=True)
        return model


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        limits: dict, traffic=None, t_start=None):
    """(result dict without ``checks``, checks).  On the CPU the result
    carries no metric: a CPU run's timings are not the card's."""
    t_start = time.perf_counter() if t_start is None else t_start
    on_device = torch.device(device).type == "cuda"
    t_ctx = time.perf_counter()
    ctx = RunContext(cell, seed, device, traffic)
    if on_device:
        # The weights' calibration runs the reference in f32, whose cuDNN
        # workspace is no part of the program's memory.
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_drv = time.perf_counter()
    drv = common.driver(ctx.traffic["kind"]).Driver(ctx)
    drv.setup()
    if on_device:
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    setup_s = t_end - t_start
    print(f"setup {setup_s:.3f} s: start and imports {t_ctx - t_start:.3f}, "
          f"weights {t_drv - t_ctx:.3f}, program set-up and warm-up "
          f"{t_end - t_drv:.3f}", file=sys.stderr)
    tr = ctx.traffic
    tracer = Tracer(trace, tr["trace_start"], tr["trace_units"], on_device)
    drv.window(seconds, tracer)
    peak = torch.cuda.max_memory_allocated() if on_device else 0
    drv.release()
    gc.collect()
    if on_device:
        torch.cuda.empty_cache()
    checks = drv.verify(ctx.reference_model(), limits)
    result = {"correct": all(c["ok"] for c in checks),
              "attempted": drv.attempted, "failed": drv.failed,
              "metrics": {}, "device": {"platform": "cpu", "kind": "cpu",
                                        "count": 1, "memory_peak_bytes": 0}}
    if not on_device:
        return result, checks
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        "count": cell["chips"], "memory_peak_bytes": peak}
    bench = common.benchmark()
    if not trace:
        values = dict(drv.e2e, setup_s=setup_s)
        for m in bench["end_to_end"]:
            if cell["name"] in m.get("workloads", [cell["name"]]):
                result["metrics"][m["name"]] = {"value": values[m["name"]],
                                                "unit": m["unit"]}
        return result, checks
    flops, convs = forward_cost(ctx.reference.build, tr["patch"],
                                ctx.config["in_channels"])
    t = tracer.trace()
    readings = Readings(kind=tr["kind"], dtype=ctx.dtype_name,
                        flops_per_patch=flops, convs=convs, trace=t,
                        counts=drv.counts, host=drv.host)
    reported = {m["name"] for m in bench["end_to_end"]
                if cell["name"] in m.get("workloads", [cell["name"]])}
    for m in bench["per_layer"]:
        cells = m.get("workloads")
        if (cell["name"] not in cells) if cells else (
                m["moves"] not in reported):
            continue
        value = common.metric_reader(m["name"]).read(readings)
        if value is not None:
            result["metrics"][m["name"]] = {"value": value,
                                            "unit": m["unit"]}
    if t is not None:
        result["device"]["busy_s"] = t.busy_ns() / 1e9
        result["device"]["window_s"] = (t.window[1] - t.window[0]) / 1e9
        result["breakdown"] = t.breakdown()
    return result, checks
