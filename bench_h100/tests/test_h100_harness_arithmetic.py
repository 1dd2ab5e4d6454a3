"""The yardstick's arithmetic against values worked out by hand."""

import math

import pytest

from harness import common
from harness.model_cost import forward_cost
from harness.roofline import (
    BF16_FLOPS,
    HBM_BYTES_PER_S,
    bound_s,
    chunks,
    conv_cost,
    convs_bound_s,
)


def test_one_conv_512_64_to_64():
    flops, nbytes = conv_cost(1, 512, 512, 64, 64, 2)
    m = 512 * 512
    assert flops == 2 * m * 64 * 9 * 64 + 3 * m * 64 == 19_377_684_480
    assert nbytes == (2 * m * 64 + 9 * 64 * 64) * 2 + 2 * 64 * 4 \
        == 67_183_104
    # bytes bound: 67 183 104 / 3.35e12 s is above 19.38 GFLOP / 989 TFLOP/s
    assert bound_s(flops, nbytes, BF16_FLOPS) == pytest.approx(
        67_183_104 / HBM_BYTES_PER_S, rel=1e-12)
    assert bound_s(flops, nbytes, BF16_FLOPS) == pytest.approx(2.00546e-5,
                                                               rel=1e-5)


def _unet_flops(p):
    """UNet's forward FLOPs at a p x p patch, from its architecture."""
    total = 0
    widths = [64, 128, 256, 512, 1024]
    cin, s = 3, p
    for w in widths:                        # encoder: two 3x3 a level
        total += 2 * s * s * 9 * (cin * w + w * w)
        cin, s = w, s // 2
    s = p // 16
    for w in reversed(widths[:-1]):         # decoder
        total += 2 * s * s * (2 * w) * w * 4  # ConvTranspose k2 s2
        s *= 2
        total += 2 * s * s * 9 * (2 * w * w + w * w)
    return total + 2 * p * p * 64 * 1       # 1x1 head


def _nested_flops(p):
    nb = [32, 64, 128, 256, 512]
    total = 0
    for i in range(5):
        s = p >> i
        for j in range(5 - i):
            cin = (3 if i == 0 else nb[i - 1]) if j == 0 \
                else nb[i] * j + nb[i + 1]
            total += 2 * s * s * 9 * (cin * nb[i] + nb[i] * nb[i])
    return total + 2 * p * p * 32 * 1


@pytest.mark.parametrize("name,flops_fn,n_convs", [
    ("unet", _unet_flops, 18), ("nestedunet", _nested_flops, 30)])
def test_forward_flops_and_convs(name, flops_fn, n_convs):
    build = common.reference_module(name).build
    flops, convs = forward_cost(build, 512)
    assert flops == flops_fn(512)
    assert len(convs) == n_convs
    assert sum(2 * h * w * 9 * cin * cout for h, w, cin, cout in convs) \
        <= flops


def test_published_totals():
    assert _unet_flops(512) == 385_339_097_088     # ~385 GFLOP a patch
    assert _nested_flops(512) == 275_884_539_904   # ~276 GFLOP a patch


def test_split_chunks_and_bound_scale():
    assert chunks(80, 32) == [32, 32, 16]
    convs = [(512, 512, 64, 64)]
    one = convs_bound_s(convs, 1, "bfloat16")
    assert one == pytest.approx(2.00546e-5, rel=1e-5)
    # the weights are read once a call, so 16 patches cost under 16 x one
    assert convs_bound_s(convs, 16, "bfloat16") < 16 * one
    assert math.isclose(convs_bound_s(convs, 16, "bfloat16"),
                        bound_s(*conv_cost(16, 512, 512, 64, 64, 2),
                                BF16_FLOPS))
