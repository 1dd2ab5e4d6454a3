"""The ``mma_sync`` body of kernel 1 (``csrc/conv3x3_affine_relu.cu``,
namespace ``bf16``) emulated on the CPU from its plan.

The body runs only on the card.  Its addressing is set by the plan
(``ops/kernels/conv_plan.box_plan``) and by a few constants that the
source and the plan module share (``BOX_MAX``, the chunk, the units), so
these tests replay it in float64 torch from the same plan: per block of
the persistent grid, its (tile, chunk) steps; for each step, the
box units (8 channels of one haloed-box pixel) with their zero fill
outside the image and past Cin, written into a two-stage ring laid out as
the kernel's shared memory (planes of 8 channels); the weights, laid out
once per call by ``pad_weights`` (its index decode replayed) into a
workspace of (channel tile, chunk, 9, chunk / 8, BN, 8) runs, each copied
whole into a stage unless the stage already holds it; the nine taps read
as fixed row offsets into the box, over the planes the products read
(``wgmma`` pairs an odd last plane with the zero plane after it); the
epilogue's bf16 tile overwriting the finished stage's box planes (for
``wgmma``); and the epilogue's store units mapped back to (b, y, x, n).
The ring starts as NaN, so a read of anything the loader did not write
shows in the result.  The result is held against the plain version
within 1e-5, and every output value must be written exactly once.
"""

import math

import numpy as np
import pytest
import torch

from jcfszxc_unet_tpu_torch.ops.kernels.conv_fused import (
    conv3x3_affine_relu_torch,
)
from jcfszxc_unet_tpu_torch.ops.kernels.conv_plan import (
    BOX_BM,
    BOX_BNS,
    BOX_CHUNKS,
    BOX_MAX,
    BOX_STAGES,
    box_blocks_per_sm,
    box_plan,
    box_plane,
    box_workspace_bytes,
    plan_conv,
)


def _vec(c):
    """bf16 a global access for c channels from a 16-byte-aligned base
    (``bf16::vec_of``)."""
    return next(v for v in (8, 4, 2, 1) if c % v == 0)


def _pad_weights(w_kmaj, plan, chunks):
    """``bf16::pad_weights``: element i of the workspace from its index
    decode (lane, n, group, tap, chunk, channel tile), zero past Cout and
    Cin."""
    cout, _, cin = w_kmaj.shape
    bn, ck = plan.bn, plan.chunk
    i = torch.arange(plan.tiles[3] * chunks * 9 * bn * ck)
    e, r = i % 8, i // 8
    n, r = r % bn, r // bn
    j, r = r % (ck // 8), r // (ck // 8)
    tap, r = r % 9, r // 9
    c, nt = r % chunks, r // chunks
    nn, ch = nt * bn + n, c * ck + 8 * j + e
    ok = (nn < cout) & (ch < cin)
    v = w_kmaj.double()[nn.clamp(max=cout - 1), tap, ch.clamp(max=cin - 1)]
    return torch.where(ok, v, torch.zeros(()))


def _emulate(plan, x, w_kmaj, scale, shift, relu):
    """x (B, H, W, Cin), w_kmaj (Cout, 9, Cin).  Returns (out, hits)."""
    tw, th, tb = plan.box
    tiles_w, tiles_h, _, tiles_n = plan.tiles
    bsz, h, w, cin = x.shape
    cout = w_kmaj.shape[0]
    bn, ck = plan.bn, plan.chunk
    n8max = ck // 8
    plane = box_plane(bn, ck)
    a_elems = n8max * plane * 8
    b_elems = 9 * n8max * bn * 8
    cst = BOX_BM * (bn + 8)
    bw, bh = tw + 2, th + 2
    box_px = tb * bh * bw
    chunks = math.ceil(cin / ck)
    n_tiles = plan.n_tiles
    grid = plan.grid[0]
    xs = x.double()
    wp = _pad_weights(w_kmaj, plan, chunks)
    assert 2 * wp.numel() == box_workspace_bytes(plan, cin)

    # the box units: u -> (box pixel e, 8-channel group j), stored at
    # (j * plane + e) * 8
    u = torch.arange(box_px * n8max)
    e, j = u // n8max, u % n8max
    pb, py, px = e // (bw * bh), (e // bw) % bh, e % bw
    lanes = torch.arange(8)
    # tile row r -> its box pixel at tap (0, 0)
    r = torch.arange(BOX_BM)
    rx = r % tw
    ry = (r // tw) % th
    rb = r // (tw * th)
    box_pixel = (rb * bh + ry) * bw + rx

    def tile_at(t):
        nt, m = t % tiles_n, t // tiles_n
        return (m % tiles_w) * tw, (m // tiles_w % tiles_h) * th, \
            (m // (tiles_w * tiles_h)) * tb, nt

    out = torch.zeros((bsz, h, w, cout), dtype=torch.float64)
    hits = torch.zeros((bsz, h, w, cout), dtype=torch.int64)
    for block in range(grid):
        steps = len(range(block, n_tiles, grid)) * chunks
        ring = [torch.full((a_elems + b_elems,), float("nan"),
                           dtype=torch.float64) for _ in range(BOX_STAGES)]
        wtag = [-1, -1]

        def fill(step, st):
            k, c = divmod(step, chunks)
            x0, y0, b0, nt = tile_at(block + k * grid)
            tag = nt * chunks + c
            if tag != wtag[st]:
                ring[st][a_elems:] = wp[tag * b_elems:(tag + 1) * b_elems]
                wtag[st] = tag
            ch = c * ck + 8 * j[:, None] + lanes                # (units, 8)
            yy, xx, bb = y0 - 1 + py, x0 - 1 + px, b0 + pb
            inside = ((bb < bsz) & (yy >= 0) & (yy < h) & (xx >= 0)
                      & (xx < w))[:, None] & (ch < cin)
            va = xs[bb.clamp(max=bsz - 1)[:, None], yy.clamp(0, h - 1)[:, None],
                    xx.clamp(0, w - 1)[:, None], ch.clamp(max=cin - 1)]
            ring[st][(j * plane + e)[:, None] * 8 + lanes] = torch.where(
                inside, va, torch.zeros(()))

        fill(0, 0)
        acc = torch.zeros((BOX_BM, bn), dtype=torch.float64)
        for i in range(steps):
            cur = i & 1
            k, c = divmod(i, chunks)
            # the groups read: wgmma in pairs (an odd last one with the
            # plane after it), mma.sync the one
            n8 = min(n8max, math.ceil((cin - c * ck) / 8))
            groups = torch.arange(2 * math.ceil(n8 / 2) if ck == 32 else 1)
            stage = ring[cur]
            for tap in range(9):
                dy, dx = divmod(tap, 3)
                rows = box_pixel + dy * bw + dx
                a = stage[((groups[None, :, None] * plane + rows[:, None, None])
                           * 8 + lanes).reshape(BOX_BM, -1)]
                nrow = (tap * n8max + groups[None, :, None]) * bn \
                    + torch.arange(bn)[:, None, None]
                b = stage[(a_elems + nrow * 8 + lanes).reshape(bn, -1)]
                acc += a @ b.T
            if c == chunks - 1:
                x0, y0, b0, nt = tile_at(block + k * grid)
                n0 = nt * bn
                ns = n0 + torch.arange(bn)
                sc = torch.where(ns < cout,
                                 scale.double()[ns.clamp(max=cout - 1)], 0.)
                sh = torch.where(ns < cout,
                                 shift.double()[ns.clamp(max=cout - 1)], 0.)
                v = acc * sc + sh
                if relu:
                    v = v.clamp(min=0)
                if ck == 32:  # the bf16 tile overwrites the box planes
                    assert cst <= a_elems
                    stage[:cst] = float("nan")
                # store units: tile row, then vec_out channels
                vec = _vec(cout)
                per_row = min(bn, cout - n0) // vec
                su = torch.arange(BOX_BM * per_row)
                sr, sj = su // per_row, su % per_row
                ox, oy, ob = x0 + rx[sr], y0 + ry[sr], b0 + rb[sr]
                ok = (ox < w) & (oy < h) & (ob < bsz)
                col = (sj * vec)[:, None] + torch.arange(vec)
                idx = (ob[ok][:, None], oy[ok][:, None], ox[ok][:, None],
                       n0 + col[ok])
                out[idx] = v[sr[ok][:, None], col[ok]]
                hits[idx] += 1
                acc = torch.zeros((BOX_BM, bn), dtype=torch.float64)
            if i + 1 < steps:
                fill(i + 1, cur ^ 1)
    return out, hits


def _inputs(b, h, w, cin, cout, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, h, w, cin).astype(np.float32))
    wt = torch.from_numpy(
        (rng.randn(3, 3, cin, cout) / math.sqrt(9 * cin)).astype(np.float32))
    scale = torch.from_numpy((0.5 + rng.rand(cout)).astype(np.float32))
    shift = torch.from_numpy((0.1 * rng.randn(cout)).astype(np.float32))
    return x, wt, scale, shift


# (B, H, W, Cin, Cout, relu, sm_count).  Cin 3 (every model's stem, one
# 8-lane group), 12 (s2d of the stem), 17 (three groups, one chunk), 51
# and 68 (a partial last chunk of one and of two groups), 204 (s2d) and
# 427 (18 chunks); Cout 1, 8, 17, 26, 64 and 427 (seven channel tiles);
# maps 13 x 11, 37 x 29, a 22-row slab of the row-sharded forward (22 x 36,
# and a full-width 22 x 576) and a whole DRIVE image (584 x 565); batch
# tails (3 and 5 images in boxes of 2 or more).  sm_count 3 makes each
# block walk many tiles, so stages alternate across tiles and a block's
# weights stay in a stage; 132 is the card's grid.
CASES = [
    (1, 584, 565, 3, 64, True, 132),
    (2, 13, 11, 3, 8, True, 3),
    (3, 13, 11, 12, 17, True, 3),
    (2, 37, 29, 17, 26, True, 3),
    (1, 22, 36, 51, 64, True, 3),
    (2, 13, 11, 68, 1, False, 3),
    (1, 37, 29, 204, 17, True, 3),
    (1, 13, 11, 427, 427, True, 3),
    (3, 22, 36, 3, 64, False, 3),
    (5, 8, 8, 17, 26, True, 3),
    (2, 37, 29, 12, 427, False, 132),
    (1, 22, 576, 3, 64, True, 3),
    (2, 13, 11, 51, 8, True, 132),
    (1, 37, 29, 68, 64, True, 3),
    (2, 4, 4, 204, 26, True, 3),
    (2, 37, 29, 427, 1, False, 3),
    (3, 22, 36, 17, 427, True, 3),
    (1, 37, 29, 3, 17, True, 3),
    (5, 13, 11, 204, 64, False, 132),
    (1, 22, 36, 427, 26, True, 132),
]


@pytest.mark.parametrize("b,h,w,cin,cout,relu,sms", CASES)
def test_box_addressing_matches_plain(b, h, w, cin, cout, relu, sms):
    x, wt, scale, shift = _inputs(b, h, w, cin, cout, seed=cin + h + cout)
    plan = plan_conv(b, h, w, cin, cout, torch.bfloat16, True, sm_count=sms)
    assert plan.body == "mma_sync"
    w_kmaj = wt.permute(3, 0, 1, 2).reshape(cout, 9, cin)
    got, hits = _emulate(plan, x, w_kmaj, scale, shift, relu)
    want = conv3x3_affine_relu_torch(x, wt, scale, shift, relu=relu)
    assert bool((hits == 1).all())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_box_addressing_of_an_unaligned_view():
    """Cin % 8 == 0 on an operand that is not 16-byte aligned also takes
    this body; its addressing is the same."""
    x, wt, scale, shift = _inputs(2, 13, 11, 64, 64, seed=3)
    plan = plan_conv(2, 13, 11, 64, 64, torch.bfloat16, False, sm_count=3)
    assert plan.body == "mma_sync" and plan.chunk == 32
    got, hits = _emulate(plan, x, wt.permute(3, 0, 1, 2).reshape(64, 9, 64),
                         scale, shift, True)
    assert bool((hits == 1).all())
    np.testing.assert_allclose(
        got.numpy(), conv3x3_affine_relu_torch(x, wt, scale, shift).numpy(),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,h,w,cin,cout", [
    (16, 512, 512, 3, 64),     # UNet's stem at the eval chunk
    (1, 608, 576, 3, 64),      # the whole-image stem
    (2, 584, 565, 3, 32),      # the fractal extractor's stacked 3 -> 32
    (16, 512, 512, 51, 32),    # MultiResUNet's heaviest odd-width conv
    (16, 256, 256, 12, 32),    # its s2d stem
    (16, 32, 32, 284, 427),
    (1, 22, 576, 3, 64),       # a 22-row slab
    (64, 8, 8, 3, 64),
    (2, 4, 4, 284, 427),
])
def test_box_plan_fits_the_body(b, h, w, cin, cout):
    """The plan names an instantiated (BN, chunk), a box that covers the
    maps within BOX_MAX haloed pixels, a persistent grid that the SMs hold
    at once and whose blocks keep one channel tile, and shared memory that
    lets that many blocks share an SM (228 KB, 1 KB of it each block's)."""
    plan = box_plan(b, h, w, cin, cout, sm_count=132)
    tw, th, tb = plan.box
    assert plan.bn in BOX_BNS and plan.chunk in BOX_CHUNKS
    assert tw * th * tb == BOX_BM == plan.bm
    assert tb * (th + 2) * (tw + 2) <= BOX_MAX
    tiles_w, tiles_h, tiles_b, tiles_n = plan.tiles
    assert tiles_w * tw >= w and tiles_h * th >= h and tiles_b * tb >= b
    assert tiles_n * plan.bn >= cout > (tiles_n - 1) * plan.bn
    blocks = box_blocks_per_sm(plan.chunk)
    assert plan.grid[1] == 1 and plan.grid[0] <= max(blocks * 132, tiles_n)
    assert plan.grid[0] == plan.n_tiles or plan.grid[0] % tiles_n == 0
    assert blocks * (plan.smem + 1024) <= 228 * 1024
    ints = list(plan.ints())
    assert ints[0] == 2 and ints[-2:] == [plan.chunk, plan.smem]


def test_box_plan_refuses_a_box_over_its_limit():
    with pytest.raises(ValueError):
        box_plan(1, 8, 256, 3, 64, sm_count=132, box=(128, 1, 1))
