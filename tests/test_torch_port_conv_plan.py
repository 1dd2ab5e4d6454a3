"""The launch plan of the 3x3 conv kernels, and the ``wgmma`` body's
addressing emulated on the CPU.

The ``wgmma`` body (csrc/conv3x3_wgmma.cuh) runs only on the card.  What
it reads is set by the plan (``ops/kernels/conv_plan.py``), so these tests
replay the kernel's loads in torch from the same plan: per tile (in the
persistent blocks' order) and K step, a TMA box read with zero fill
outside the tensor, for x at (c0, x0 + dx - halo, y0 + dy - halo, b0) and
for the K-major weights at (c0, tap, n0); then the epilogue's map of tile
rows back to (b, y, x), with its masks.  The result is held against the
plain versions, and every output value must be written exactly once.
"""

import math

import numpy as np
import pytest
import torch

from jcfszxc_unet_tpu_torch.ops.kernels.conv_fused import (
    conv3x3_affine_relu_torch,
)
from jcfszxc_unet_tpu_torch.ops.kernels.conv_imcol import (
    conv3x3_relu_imcol_torch,
    pad_inputs,
)
from jcfszxc_unet_tpu_torch.ops.kernels.conv_plan import (
    BK,
    WGMMA_CONFIGS,
    choose_box,
    plan_conv,
    wgmma_plan,
    wgmma_route,
)


def _box(t, start, size):
    """A TMA tiled load: ``t[start:start + size]`` along every dim, with
    zeros where the box leaves ``t`` (coordinates may be negative)."""
    out = t
    mask = torch.ones((), dtype=torch.bool)
    for d, (s, n) in enumerate(zip(start, size)):
        i = torch.arange(s, s + n)
        ok = (i >= 0) & (i < t.shape[d])
        out = out.index_select(d, i.clamp(0, t.shape[d] - 1))
        shape = [1] * t.dim()
        shape[d] = n
        mask = mask & ok.view(shape)
    return out * mask


def _emulate(plan, src, w_kmaj, h, w, scale, shift, relu, halo):
    """The wgmma body's loads and epilogue.  src: x (B, H, W, C) with
    halo 1, or the padded xp (B, H+2, W+2, C) with halo 0; w_kmaj
    (Cout, 9, C).  Returns (out, hits) in float64."""
    tw, th, tb = plan.box
    tiles_w, tiles_h, tiles_b, tiles_n = plan.tiles
    bsz, c = src.shape[0], src.shape[3]
    cout = w_kmaj.shape[0]
    src, w_kmaj = src.double(), w_kmaj.double()
    out = torch.zeros((bsz, h, w, cout), dtype=torch.float64)
    hits = torch.zeros((bsz, h, w, cout), dtype=torch.int64)
    chunks = math.ceil(c / BK)
    bm = plan.bm
    r = torch.arange(bm)
    for block in range(plan.grid[0]):
        for tile in range(block, plan.n_tiles, plan.grid[0]):
            nt, m = tile % tiles_n, tile // tiles_n
            bx, m = m % tiles_w, m // tiles_w
            by, bb = m % tiles_h, m // tiles_h
            x0, y0, b0, n0 = bx * tw, by * th, bb * tb, nt * plan.bn
            acc = torch.zeros((bm, plan.bn), dtype=torch.float64)
            for kt in range((3 if plan.strip else 9) * chunks):
                step, c0 = kt // chunks, (kt % chunks) * BK
                if plan.strip:
                    # rows y0 + dy - halo .. of 130 pixels from x0 - halo;
                    # tap dx reads them from row dx on
                    a = _box(src, (b0, y0 + step - halo, x0 - halo, c0),
                             (1, th, tw + 2, BK)).reshape(-1, BK)
                    for dx in range(3):
                        win = (r // tw) * (tw + 2) + r % tw + dx
                        b = _box(w_kmaj, (n0, 3 * step + dx, c0),
                                 (plan.bn, 1, BK))
                        acc += a[win] @ b.reshape(plan.bn, BK).T
                    continue
                dy, dx = divmod(step, 3)
                a = _box(src, (b0, y0 + dy - halo, x0 + dx - halo, c0),
                         (tb, th, tw, BK)).reshape(bm, BK)
                b = _box(w_kmaj, (n0, step, c0), (plan.bn, 1, BK))
                acc += a @ b.reshape(plan.bn, BK).T
            xs = x0 + r % tw
            ys = y0 + (r // tw) % th
            bs = b0 + r // (tw * th)
            ns = n0 + torch.arange(plan.bn)
            rows = (xs < w) & (ys < h) & (bs < bsz)
            cols = ns < cout
            v = acc[rows][:, cols]
            if scale is not None:
                v = v * scale.double()[ns[cols]] + shift.double()[ns[cols]]
            if relu:
                v = v.clamp(min=0)
            idx = (bs[rows][:, None], ys[rows][:, None], xs[rows][:, None],
                   ns[cols][None, :])
            out[idx] = v
            hits[idx] += 1
    return out, hits


def _inputs(b, h, w, cin, cout, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, h, w, cin).astype(np.float32))
    wt = torch.from_numpy(
        (rng.randn(3, 3, cin, cout) / math.sqrt(9 * cin)).astype(np.float32))
    scale = torch.from_numpy((0.5 + rng.rand(cout)).astype(np.float32))
    shift = torch.from_numpy((0.1 * rng.randn(cout)).astype(np.float32))
    return x, wt, scale, shift


# (B, H, W, Cin, Cout, relu): boxes spanning images, a ragged W and H,
# Cin not a multiple of 64, Cout not a multiple of BN, one single tile,
# and row strips (Cout 64, W >= 128) with a ragged edge; the zoo's Cout 32
# and Cout 1 under one 64-wide tile, Cin 96 and 160, SegNet's 19 x 18
# whole-image bottom, MultiResUNet's Cin 8 (a 16-byte TMA box) to the odd
# Cout 17, BCDU-Net's Cout-2 head with ReLU and a ConvLSTM gate conv on the
# two steps stacked on the batch; TransFuseNet's Cin 24 and 48 (part of one
# 64-channel K step) to Cout 16 and 32, and its 8 -> 8 and 8 -> 16.
# Space-to-depth execution (4x the channels at half the map): FRUNet's
# 32 -> 32 row as 128 -> 128 with ReLU off, its FeatureFuse 64 -> 32 as
# 256 -> 128, on rows of 256 pixels as at a 512^2 patch; NestedUNet's row-0
# nodes 160 -> 32 as 640 -> 128 and row-1 ones 64 -> 64 as 256 -> 256 and
# 320 -> 64 as 1280 -> 256; MultiResUNet's Cin 32 (8 -> 17 as 32 -> 68)
# and Cin 128 (its Respath 32 -> 32 as 128 -> 128, and 64 -> 8 as
# 256 -> 32).
CASES = [
    (4, 8, 8, 64, 64, True),
    (2, 37, 29, 16, 64, True),
    (2, 37, 29, 72, 96, False),
    (1, 8, 16, 64, 64, True),
    (2, 8, 8, 64, 160, False),
    (1, 3, 130, 72, 64, True),
    (2, 8, 8, 96, 32, True),
    (2, 8, 8, 64, 1, False),
    (1, 19, 18, 160, 64, True),
    (2, 13, 11, 8, 17, True),
    (2, 8, 8, 64, 2, True),
    (4, 8, 8, 256, 512, False),
    (2, 8, 8, 24, 16, True),
    (2, 8, 8, 48, 32, True),
    (2, 13, 11, 8, 8, True),
    (2, 8, 8, 8, 16, True),
    (1, 2, 256, 128, 128, False),
    (2, 8, 8, 256, 128, False),
    (1, 8, 8, 640, 128, True),
    (2, 8, 8, 256, 256, True),
    (1, 4, 8, 1280, 256, True),
    (2, 13, 11, 32, 68, True),
    (2, 8, 8, 128, 128, True),
    (2, 8, 8, 256, 32, True),
]


@pytest.mark.parametrize("b,h,w,cin,cout,relu", CASES)
def test_fused_conv_addressing_matches_plain(b, h, w, cin, cout, relu):
    x, wt, scale, shift = _inputs(b, h, w, cin, cout, seed=cin + h)
    # the wgmma body's own plan: plan_conv routes the narrow shapes among
    # these (Cout <= 32, or Cin <= 32 into Cout <= 128) to the narrow body
    # (tests/test_torch_port_conv_narrow.py)
    plan = wgmma_route(b, h, w, cin, cout, sm_count=3)
    assert plan.body == "wgmma"
    w_kmaj = wt.permute(3, 0, 1, 2).reshape(cout, 9, cin)  # the kernel's B
    got, hits = _emulate(plan, x, w_kmaj, h, w, scale, shift, relu, halo=1)
    want = conv3x3_affine_relu_torch(x, wt, scale, shift, relu=relu)
    assert bool((hits == 1).all())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("b,h,w,cin,cout", [
    (4, 8, 8, 64, 64), (2, 37, 29, 72, 96), (2, 13, 11, 3, 8),
    (1, 3, 130, 16, 64)])
def test_imcol_addressing_matches_plain(b, h, w, cin, cout):
    x, wt, _, _ = _inputs(b, h, w, cin, cout, seed=cin + w)
    xp, w2 = pad_inputs(x, wt)
    c8 = xp.shape[3]
    plan = plan_conv(b, h, w, c8, cout, torch.bfloat16, True, sm_count=3,
                     imcol=True)
    assert plan.body == "wgmma"
    got, hits = _emulate(plan, xp, w2.reshape(cout, 9, c8), h, w, None, None,
                         True, halo=0)
    assert bool((hits == 1).all())
    np.testing.assert_allclose(got.numpy(),
                               conv3x3_relu_imcol_torch(x, wt).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,h,w,box", [
    (16, 512, 512, (128, 1, 1)),   # eval patches
    (64, 8, 8, (8, 8, 2)),         # val chunk at the bottom of the UNet
    (64, 16, 16, (16, 8, 1)),
    (64, 128, 128, (128, 1, 1)),   # the probe
    (1, 584, 565, (8, 16, 1)),     # a whole DRIVE image: 0.8 % padded work
])
def test_box_choice(b, h, w, box):
    tw, th, tb = choose_box(b, h, w)
    assert (tw, th, tb) == box and tw * th * tb == 128
    tiles = -(-w // tw) * -(-h // th) * -(-b // tb)
    # no power-of-two box covers the maps in fewer tiles
    assert all(tiles <= -(-w // (1 << i)) * -(-h // (1 << j))
               * -(-b // (128 >> (i + j)))
               for i in range(8) for j in range(8 - i))
    tw, th, tb = choose_box(b, h, w, bm=256)
    assert tw * th * tb == 256


def test_body_choice():
    def body(cin, dtype, aligned=True, imcol=False):
        return plan_conv(2, 16, 16, cin, 64, dtype, aligned,
                         imcol=imcol).body

    bf16, f32 = torch.bfloat16, torch.float32
    assert body(64, bf16) == "wgmma"
    assert body(3, bf16) == "mma_sync"             # UNet's first conv
    assert body(8, bf16) == "wgmma"                # MultiResUNet's Cin 8
    assert body(32, bf16) == "narrow"              # BCDU's 32 -> 64
    assert body(128, bf16) == "wgmma"
    assert body(17, bf16) == "mma_sync"            # and its odd widths
    for cin in (12, 68, 204):                      # and its s2d widths
        assert body(cin, bf16) == "mma_sync"
    assert body(64, bf16, aligned=False) == "mma_sync"
    assert body(64, f32) == "f32_box"               # every f32 call
    assert body(3, f32) == "f32_box"
    assert body(17, f32, aligned=False) == "f32_box"
    assert body(8, bf16, imcol=True) == "wgmma"
    assert body(8, f32, imcol=True) == "fma"
    with pytest.raises(ValueError):
        body(8, bf16, aligned=False, imcol=True)


def test_wgmma_plan_is_persistent_and_covers_the_output():
    plan = plan_conv(16, 512, 512, 64, 64, torch.bfloat16, True, sm_count=132)
    assert (plan.bn, plan.grid) == (64, (132, 1))
    assert plan.n_tiles * plan.bm == 16 * 512 * 512
    small = plan_conv(1, 8, 16, 64, 96, torch.bfloat16, True, sm_count=132)
    # Cin 64 into Cout <= 128: 256 x 64 ping-pong tiles, one per channel
    # tile here, one block each
    assert (small.bn, small.n_tiles, small.grid) == (64, 2, (2, 1))
    ints = list(plan.ints())
    assert len(ints) == 19 and ints[0] == 3  # wgmma_conv::Plan, body code


@pytest.mark.parametrize("config", [c for c in WGMMA_CONFIGS
                                    if c[0] == 256 or c[3]])
def test_other_tile_configurations_addressing(config):
    """256-pixel tiles (each consumer warpgroup takes 128 rows) and stages
    of row strips."""
    b, h, w, cin, cout = 2, 37, 29, 72, 96
    x, wt, scale, shift = _inputs(b, h, w, cin, cout, seed=7)
    plan = wgmma_plan(b, h, w, cout, config, sm_count=2)
    assert np.prod(plan.box) == plan.bm
    w_kmaj = wt.permute(3, 0, 1, 2).reshape(cout, 9, cin)
    got, hits = _emulate(plan, x, w_kmaj, h, w, scale, shift, True, halo=1)
    want = conv3x3_affine_relu_torch(x, wt, scale, shift)
    assert bool((hits == 1).all())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def _make_divisor(d):
    """``wgmma_conv::make_divisor``: (mul, shift) with n / d ==
    (mulhi(n, mul) + n) >> shift for 0 <= n < 2^31."""
    shift = max(d - 1, 0).bit_length()
    return ((((1 << shift) - d) << 32) // d + 1, shift)


def _divide(n, mul, shift):
    """``Divisor::div`` in 32-bit arithmetic, as the card does it."""
    total = ((n * mul) >> 32) + n
    assert total < 2 ** 32  # the 32-bit sum does not wrap
    return total >> shift


@pytest.mark.parametrize("d", [1, 2, 3, 5, 7, 64, 97, 132, 4096, 65535,
                               2 ** 30 - 1, 2 ** 30, 2 ** 31 - 1])
def test_tile_divisor_is_exact(d):
    """The divisors that the launcher works out for the tile loops (the
    tile counts along Cout, W and H) divide every tile index exactly:
    the neighbourhoods of multiples of d across the range, and spread
    indices up to 2^31 - 1."""
    mul, shift = _make_divisor(d)
    assert 0 <= mul < 2 ** 32
    rng = np.random.default_rng(d)
    ns = {0, 1, 2 ** 31 - 1}
    for q in range(0, 2 ** 31 // d, max(1, 2 ** 31 // d // 200)):
        ns |= {q * d + r for r in (-1, 0, 1, d - 1)}
    ns |= set(int(n) for n in rng.integers(0, 2 ** 31, 2000))
    for n in ns:
        if 0 <= n < 2 ** 31:
            assert _divide(n, mul, shift) == n // d, n
