"""Host us per kernel-1 call in the traced validation pass: the mean
length of the program's ``unet.kernel1`` spans inside
``bench.val_pass``."""

from harness.program_spans import kernel1_host_us


def read(r):
    if r.trace is None or r.kind != "train_epochs":
        return None
    return kernel1_host_us(r.trace, "bench.val_pass")
