"""Training's share of the card's peak over the traced epoch, in %:
3 x the forward's FLOPs per patch for each trained patch (forward and
backward) plus 1 x for each validation patch, over the traced window's
seconds, over the peak of the configuration's dtype."""

from harness.roofline import PEAK_FLOPS


def read(r):
    if r.trace is None or r.kind != "train_epochs" or not r.counts["steps"]:
        return None
    lo, hi = r.trace.window
    seconds = (hi - lo) / 1e9
    flops = r.flops_per_patch * (3 * r.counts["train_patches"]
                                 + r.counts["val_patches"])
    return 100.0 * flops / seconds / PEAK_FLOPS[r.dtype]
