"""Host us per kernel-1 call in the traced splits: the mean length of the
program's ``unet.kernel1`` spans (plan, workspace, tensor-map encodes and
launch in the operator's CUDA implementation) inside ``bench.split``."""

from harness.program_spans import kernel1_host_us


def read(r):
    if r.trace is None or r.kind != "eval_split":
        return None
    return kernel1_host_us(r.trace, "bench.split")
