"""Device ms per evaluated image of the kernels that are not the
program's own (launched inside neither of its operators) over the traced
splits: upsampling, concatenation, pooling, casts, the patch gather, the
stitch, the histograms.  Copies and sets are not kernels and are left
out."""

OPS = ("jcfszxc_unet::conv3x3_affine_relu", "jcfszxc_unet::dice_sums")


def read(r):
    if r.trace is None or r.kind != "eval_split" or not r.counts["images"]:
        return None
    total = sum(e - s for s, e, _, k, _, _ in r.trace.in_window()
                if k == "kernel")
    own = sum(r.trace.op_device_ns(op)[0] for op in OPS)
    return (total - own) / 1e6 / r.counts["images"]
