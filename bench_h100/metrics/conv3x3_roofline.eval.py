"""Kernel 1's share of its roofline over the traced splits, in %.

Numerator: the least time of every 3x3 conv of the forward (the
configuration's shapes at the traffic's patch, counted on the plain
reference) at each chunk's batch, by ``harness.roofline``, whatever body
runs it.  Denominator: the device time of the kernels launched inside the
program's operator ``jcfszxc_unet::conv3x3_affine_relu``."""

from harness.roofline import convs_bound_s

OP = "jcfszxc_unet::conv3x3_affine_relu"


def read(r):
    if r.trace is None or r.kind != "eval_split" or not r.counts["splits"]:
        return None
    ns, n = r.trace.op_device_ns(OP)
    if not n:
        return None
    bound = sum(convs_bound_s(r.convs, b, r.dtype) for b in r.counts["chunks"])
    return 100.0 * bound * r.counts["splits"] / (ns / 1e9)
