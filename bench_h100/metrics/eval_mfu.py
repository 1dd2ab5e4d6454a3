"""The evaluation's share of the card's peak over the traced splits, in %:
the forward's FLOPs per patch (counted on the plain reference) times the
patches evaluated, over the traced window's seconds, over the peak of the
configuration's dtype (989 TFLOP/s in bf16)."""

from harness.roofline import PEAK_FLOPS


def read(r):
    if r.trace is None or r.kind != "eval_split" or not r.counts["patches"]:
        return None
    lo, hi = r.trace.window
    seconds = (hi - lo) / 1e9
    return (100.0 * r.flops_per_patch * r.counts["patches"] / seconds
            / PEAK_FLOPS[r.dtype])
