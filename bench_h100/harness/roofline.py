"""Peaks of one NVIDIA H100 SXM (data sheet, dense, at the 700 W limit)
and the arithmetic of a 3x3 conv's least time, copied from the port's
``chip_smoke.py`` (``conv_cost``, ``bound_ms``): operations 2 M N K plus a
3-op epilogue; input, weights, scale and shift read once, output written
once."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12
PEAK_FLOPS = {"bfloat16": BF16_FLOPS, "float32": F32_FLOPS}
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def conv_cost(b, h, w, cin, cout, itemsize):
    """(flops, bytes) of one fused 3x3 conv + scale/shift + ReLU."""
    m = b * h * w
    flops = 2 * m * cout * 9 * cin + 3 * m * cout
    nbytes = (m * cin + 9 * cin * cout + m * cout) * itemsize + 2 * cout * 4
    return flops, nbytes


def bound_s(flops, nbytes, peak_flops):
    return max(nbytes / HBM_BYTES_PER_S, flops / peak_flops)


def convs_bound_s(convs, batch: int, dtype: str) -> float:
    """Least time of one forward's 3x3 convs, ``convs`` a list of
    (h, w, cin, cout), at ``batch``."""
    return sum(bound_s(*conv_cost(batch, h, w, cin, cout, ITEMSIZE[dtype]),
                       PEAK_FLOPS[dtype]) for h, w, cin, cout in convs)


def chunks(total: int, batch: int) -> list[int]:
    """The batch sizes of ``total`` items cut in chunks of ``batch``."""
    return [min(batch, total - i) for i in range(0, total, batch)]
