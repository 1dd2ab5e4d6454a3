"""The ``f32_box`` body of kernel 1 (``csrc/conv3x3_affine_relu.cu``,
namespace ``f32``) replayed on the CPU from its plan.

The body runs only on the card.  Its addressing is set by the plan
(``ops/kernels/conv_plan.f32_plan``) and by constants that the source and
the plan module share (``F32_CHUNK``, ``F32_STAGES``, ``F32_PLANE``,
``F32_TILES``), so these tests replay it in float64 torch from the same
plan, for every block of the grid at once: the tile a block decodes from
its index (channel tile fastest); the weights laid out once per call by
``pad_weights`` (its index decode replayed, every workspace element
written once) into (channel tile, chunk, 9, chunk, BN) runs; the box
pixels' table (source pixel, plane offset) and the loader's units
(channel ``tid % 4`` of box pixels ``tid / 4 + 64 i``, each (pixel,
channel) once), copied with zero fill outside the image and past Cin
into a ring of
``F32_STAGES`` stages laid out as the kernel's shared memory (channel
planes of rows TW + 4 floats, then the stage's weights), the next chunks
loaded before the current one is read, as the kernel issues them; the
products of each thread (TM pixels of one box row by its TN channels, the
pixel groups numbered down the tile's rows): per channel and tap row the
TM + 2 box pixels read once and the three horizontal taps taken as slices
[0..TM-1], [1..TM], [2..TM+1] of them, against the weights at the
thread's 4-channel columns; and the epilogue's store mapping
back to (b, y, x, n).  The ring starts as NaN, so a read of anything the
loader did not write shows in the result.  The result is held against the
plain version, run in float64 on the same inputs, within 1e-6, and every
output value must be written exactly once.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from jcfszxc_unet_tpu_torch.ops.kernels import conv_fused, conv_plan
from jcfszxc_unet_tpu_torch.ops.kernels.conv_fused import (
    conv3x3_affine_relu_torch,
)
from jcfszxc_unet_tpu_torch.ops.kernels.conv_plan import (
    F32_CHUNK,
    F32_PLANE,
    F32_STAGES,
    F32_THREADS,
    F32_TILES,
    box_workspace_bytes,
    f32_plan,
    f32_plane,
    f32_smem,
    f32_tm,
    plan_conv,
)

TILE_BATCH = 64  # blocks replayed together


def _pad_weights(w_kmaj, plan, chunks):
    """``f32::pad_weights``: element i taken in (tile, chunk, tap, n, c)
    order, c fastest, written at ((tile * chunks + chunk) * 9 + tap) *
    chunk + c) * BN + n, zero past Cout and Cin."""
    cout, _, cin = w_kmaj.shape
    bn, ck = plan.bn, plan.chunk
    total = plan.tiles[3] * chunks * 9 * ck * bn
    i = torch.arange(total)
    c, r = i % ck, i // ck
    n, r = r % bn, r // bn
    tap, r = r % 9, r // 9
    k, nt = r % chunks, r // chunks
    nn, ch = nt * bn + n, k * ck + c
    ok = (nn < cout) & (ch < cin)
    v = w_kmaj.double()[nn.clamp(max=cout - 1), tap, ch.clamp(max=cin - 1)]
    dst = ((r * 9 + tap) * ck + c) * bn + n
    wp = torch.full((total,), float("nan"), dtype=torch.float64)
    wp[dst] = torch.where(ok, v, torch.zeros(()))
    assert bool((torch.bincount(dst, minlength=total) == 1).all())
    assert 4 * total == box_workspace_bytes(plan, cin)
    return wp


def _threads(plan):
    """Each thread's (pixel group, channel group), its box offset at the
    top-left tap and its weight columns (``conv_kernel``'s roles): TM
    pixels of a box row, the groups numbered down the tile's rows first."""
    tw, th, _ = plan.box
    tm = f32_tm((plan.bm, plan.bn), tw)
    groups = plan.bm // tm
    cgs = F32_THREADS // groups
    tn = plan.bn // cgs
    tid = torch.arange(F32_THREADS)
    lane, warp = tid % 32, tid // 32
    wc = cgs // 8
    cg = (warp % wc) * 8 + lane % 8
    pg = (warp // wc) * 4 + lane // 8
    # the thread roles are a bijection onto the tile
    assert len(set(zip(pg.tolist(), cg.tolist()))) == F32_THREADS
    assert int(pg.max()) == groups - 1 and int(cg.max()) == cgs - 1
    rows = plan.bm // tw
    row, xl = pg % rows, (pg // rows) * tm
    bl, yl = row // th, row % th
    a_off = (bl * (th + 2) + yl) * (tw + 4) + xl
    j = torch.arange(tn)
    cols = 4 * cg[:, None] + (j // 4) * (plan.bn // 2) + j % 4
    return tm, bl, yl, xl, a_off, cols


def _emulate(plan, x, w_kmaj, scale, shift, relu):
    """x (B, H, W, Cin), w_kmaj (Cout, 9, Cin).  Returns (out, hits)."""
    tw, th, tb = plan.box
    tiles_w, tiles_h, _, tiles_n = plan.tiles
    bsz, h, w, cin = x.shape
    cout = w_kmaj.shape[0]
    bm, bn, ck, stages = plan.bm, plan.bn, plan.chunk, plan.stages
    assert (ck, stages) == (F32_CHUNK, F32_STAGES)
    plane = F32_PLANE[bm]
    a_floats, b_floats = ck * plane, 9 * ck * bn
    stage = a_floats + b_floats
    assert 4 * stages * stage + 8 * plane == plan.smem  # ring, then table
    rs, bw, bh = tw + 4, tw + 2, th + 2
    chunks = math.ceil(cin / ck)
    assert plan.grid == (plan.n_tiles, 1)
    wp = _pad_weights(w_kmaj, plan, chunks).view(tiles_n, chunks, b_floats)
    xs = x.double().reshape(-1, cin)

    # the table: thread tid writes box pixels tid + 256 j; then the
    # loader's units: channel tid % 4 of box pixels tid / 4 + 64 i
    box_px = tb * bh * bw
    tid = torch.arange(F32_THREADS)
    e = (tid[:, None] + F32_THREADS
         * torch.arange(math.ceil(plane / F32_THREADS))).reshape(-1)
    assert sorted(e[e < box_px].tolist()) == list(range(box_px))
    ue = (tid[:, None] // ck + (F32_THREADS // ck)
          * torch.arange(math.ceil(plane * ck / F32_THREADS))).reshape(-1)
    uc = (tid[:, None] % ck).expand(-1, ue.numel() // F32_THREADS)
    units = {(int(a), int(b)) for a, b in zip(ue, uc.reshape(-1))
             if a < box_px}
    assert len(units) == box_px * ck  # every (pixel, channel) once
    e = torch.arange(box_px)
    r = e // bw
    px, pb = e - r * bw, r // bh
    py = r - pb * bh
    dst_off = r * rs + px
    assert int(dst_off.max()) < plane

    tm, bl, yl, xl, a_off, cols = _threads(plan)
    taps = torch.arange(tm + 2)
    out = torch.zeros((bsz, h, w, cout), dtype=torch.float64)
    hits = torch.zeros((bsz, h, w, cout), dtype=torch.int64)
    for first in range(0, plan.n_tiles, TILE_BATCH):
        t = torch.arange(first, min(first + TILE_BATCH, plan.n_tiles))
        nt, m = t % tiles_n, t // tiles_n
        x0 = (m % tiles_w) * tw
        m = m // tiles_w
        y0 = (m % tiles_h) * th
        b0 = (m // tiles_h) * tb
        xx, yy = x0[:, None] - 1 + px, y0[:, None] - 1 + py
        bb = b0[:, None] + pb
        inside = ((bb < bsz) & (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w))
        src = ((bb * h + yy) * w + xx).clamp(0, bsz * h * w - 1)
        ring = torch.full((len(t), stages, stage), float("nan"),
                          dtype=torch.float64)

        def load(k, slot):
            for c in range(ck):
                ch = k * ck + c
                # past Cin there is nothing to read: NaN unless zero-filled
                v = xs[src, ch] if ch < cin else torch.full(
                    src.shape, float("nan"), dtype=torch.float64)
                ring[:, slot, c * plane + dst_off] = torch.where(
                    inside & (ch < cin), v, torch.zeros(()))
            ring[:, slot, a_floats:] = wp[nt, k]

        for s in range(min(stages - 1, chunks)):
            load(s, s)
        acc = torch.zeros((len(t), F32_THREADS, tm, cols.shape[1]),
                          dtype=torch.float64)
        for k in range(chunks):
            if k + stages - 1 < chunks:  # issued before chunk k is read
                load(k + stages - 1, (k + stages - 1) % stages)
            st = ring[:, k % stages]
            # (tile, c, dy, thread, TM + 2): the box row a thread reads
            # once per channel and tap row
            ia = (a_off[None, None, :, None]
                  + (torch.arange(ck) * plane)[:, None, None, None]
                  + (torch.arange(3) * rs)[None, :, None, None] + taps)
            a = st[:, ia]
            # (tile, dy, dx, c, thread, TN): the weights of tap (dy, dx)
            ib = (a_floats + (torch.arange(9)[:, None, None, None] * ck
                              + torch.arange(ck)[None, :, None, None]) * bn
                  + cols[None, None]).view(3, 3, ck, F32_THREADS, -1)
            b = st[:, ib]
            for dx in range(3):
                acc += torch.einsum("tcdpi,tdcpj->tpij",
                                    a[..., dx:dx + tm], b[:, :, dx])
        # epilogue: thread p's pixel i, channel column j
        n = nt[:, None, None] * bn + cols[None]                 # (t, p, j)
        nc = n.clamp(max=cout - 1)
        v = (acc * torch.where(n < cout, scale.double()[nc], 0.)[:, :, None]
             + torch.where(n < cout, shift.double()[nc], 0.)[:, :, None])
        if relu:
            v = v.clamp(min=0)
        ob = (b0[:, None] + bl)[:, :, None, None].expand_as(v)
        oy = (y0[:, None] + yl)[:, :, None, None].expand_as(v)
        ox = (x0[:, None, None] + xl[None, :, None]
              + torch.arange(tm))[..., None].expand_as(v)
        on = n[:, :, None, :].expand_as(v)
        ok = (ob < bsz) & (oy < h) & (ox < w) & (on < cout)
        idx = (ob[ok], oy[ok], ox[ok], on[ok])
        out[idx] = v[ok]
        hits.index_put_(idx, torch.ones_like(idx[0]), accumulate=True)
    return out, hits


def _inputs(b, h, w, cin, cout, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, h, w, cin).astype(np.float32))
    wt = torch.from_numpy(
        (rng.randn(3, 3, cin, cout) / math.sqrt(9 * cin)).astype(np.float32))
    scale = torch.from_numpy((0.5 + rng.rand(cout)).astype(np.float32))
    shift = torch.from_numpy((0.1 * rng.randn(cout)).astype(np.float32))
    return x, wt, scale, shift


def _check(plan, x, wt, scale, shift, relu):
    cout, cin = wt.shape[3], wt.shape[2]
    w_kmaj = wt.permute(3, 0, 1, 2).reshape(cout, 9, cin)
    got, hits = _emulate(plan, x, w_kmaj, scale, shift, relu)
    # the plain version in f64 too: in f32 it is itself ~4e-6 off at Cin 64
    want = conv3x3_affine_relu_torch(x.double(), wt.double(), scale.double(),
                                     shift.double(), relu=relu)
    assert bool((hits == 1).all())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


# UNet's 18 convs (Cin -> Cout) at a 16^2 input, batch 2: 16^2 down to
# 1^2 (boxes spanning images, all three tiles).
UNET_F32 = [
    (16, 3, 64), (16, 64, 64), (8, 64, 128), (8, 128, 128), (4, 128, 256),
    (4, 256, 256), (2, 256, 512), (2, 512, 512), (1, 512, 1024),
    (1, 1024, 1024), (2, 1024, 512), (2, 512, 512), (4, 512, 256),
    (4, 256, 256), (8, 256, 128), (8, 128, 128), (16, 128, 64),
    (16, 64, 64),
]

# (B, H, W, Cin, Cout, relu): Cin 3 (every model's stem: one partial
# chunk); MultiResUNet's odd widths 17 -> 26, 51 -> 32, 105 -> 64 and a
# partial last channel tile (35 -> 71, 213 -> 142); a 322-row slab of the
# row-sharded forward; ragged H and W (37 x 29, 13 x 11, a whole 58 x 57
# image) and batch tails; Cout 1 and 8; ReLU off.
CASES = [
    (2, 16, 16, 3, 64, True),
    (1, 37, 29, 3, 64, False),
    (2, 13, 11, 17, 26, True),
    (1, 37, 29, 51, 32, True),
    (2, 13, 11, 105, 64, True),
    (3, 8, 8, 35, 71, True),
    (1, 6, 5, 213, 142, False),
    (1, 322, 96, 3, 64, True),
    (1, 58, 57, 64, 64, True),
    (5, 4, 4, 64, 128, True),
    (2, 13, 11, 64, 1, False),
    (1, 37, 29, 17, 8, True),
]


@pytest.mark.parametrize("hw,cin,cout", UNET_F32)
def test_f32_box_replay_unet_list(hw, cin, cout):
    """On 3 SMs, where the plan weighs rounds of blocks as at UNet's eval
    chunk, and so takes the tiles of that chunk (132 SMs would take the
    32-channel tile at these few pixels)."""
    x, wt, scale, shift = _inputs(2, hw, hw, cin, cout, seed=cin + hw)
    plan = plan_conv(2, hw, hw, cin, cout, torch.float32, True, sm_count=3)
    assert plan.body == "f32_box"
    _check(plan, x, wt, scale, shift, True)


@pytest.mark.parametrize("b,h,w,cin,cout,relu", CASES)
def test_f32_box_replay_matches_plain(b, h, w, cin, cout, relu):
    x, wt, scale, shift = _inputs(b, h, w, cin, cout, seed=cin + h + cout)
    plan = plan_conv(b, h, w, cin, cout, torch.float32, True)
    assert plan.body == "f32_box"
    _check(plan, x, wt, scale, shift, relu)


def test_f32_box_replay_of_an_unaligned_view():
    """An f32 view that starts 4 bytes past a 16-byte boundary takes the
    same body and plan: every copy of x is 4 bytes."""
    x, wt, scale, shift = _inputs(2, 13, 11, 65, 64, seed=3)
    view = x[..., 1:]
    assert view.data_ptr() % 16 and not view.is_contiguous()
    view = view.contiguous()[..., :]
    plan = plan_conv(2, 13, 11, 64, 64, torch.float32, False)
    assert plan == plan_conv(2, 13, 11, 64, 64, torch.float32, True)
    _check(plan, view, wt[:, :, 1:], scale, shift, True)


@pytest.mark.parametrize("tile", F32_TILES)
@pytest.mark.parametrize("tw,th", [(8, 4), (16, 4), (32, 2)])
def test_f32_box_replay_other_tiles_and_boxes(tile, tw, th):
    """Every instantiated tile with boxes 8 wide (8-pixel thread rows) and
    16 and 32 wide (16-pixel rows but at 256 x 32), spanning images,
    beside the ones the plan picks: all five kernels of the body."""
    bm, _ = tile
    b, h, w, cin, cout = 9, 11, 19, 9, 70
    box = (tw, th, bm // (tw * th))
    x, wt, scale, shift = _inputs(b, h, w, cin, cout, seed=bm + tw)
    plan = f32_plan(b, h, w, cout, tile=tile, box=box)
    _check(plan, x, wt, scale, shift, True)


@pytest.mark.parametrize("b,h,w,cin,cout", [
    (16, 512, 512, 3, 64),     # UNet's stem at the eval chunk
    (16, 512, 512, 64, 64),
    (16, 256, 256, 128, 128),
    (16, 32, 32, 1024, 1024),
    (1, 608, 576, 64, 64),     # whole image
    (2, 322, 576, 3, 64),      # a 322-row slab
    (2, 22, 36, 512, 1024),    # its deepest slab
    (64, 8, 8, 512, 512),      # the train path's validation
    (16, 512, 512, 17, 26),    # MultiResUNet
    (2, 4, 4, 284, 427),
])
def test_f32_plan_fits_the_body(b, h, w, cin, cout):
    """The plan names an instantiated tile, a box whose channel plane fits
    F32_PLANE and that covers the maps, one block a tile, and shared
    memory that lets two blocks share an SM (228 KB, 1 KB of it each
    block's)."""
    plan = plan_conv(b, h, w, cin, cout, torch.float32, True)
    assert plan.body == "f32_box"
    tw, th, tb = plan.box
    assert (plan.bm, plan.bn) in F32_TILES and tw * th * tb == plan.bm
    assert tw >= f32_tm((plan.bm, plan.bn), tw) >= 8
    assert f32_plane(plan.box) <= F32_PLANE[plan.bm]
    tiles_w, tiles_h, tiles_b, tiles_n = plan.tiles
    assert tiles_w * tw >= w and tiles_h * th >= h and tiles_b * tb >= b
    assert tiles_n * plan.bn >= cout > (tiles_n - 1) * plan.bn
    assert plan.grid == (plan.n_tiles, 1) and plan.n_tiles < 2 ** 31
    assert (plan.chunk, plan.stages) == (F32_CHUNK, F32_STAGES)
    assert plan.smem == f32_smem(plan.bm, plan.bn)
    assert 2 * (plan.smem + 1024) <= 228 * 1024
    assert F32_PLANE[plan.bm] % 32 == 8  # the four planes in distinct banks
    ints = list(plan.ints())
    assert ints[0] == conv_plan.BODIES["f32_box"]
    assert ints[-2:] == [F32_CHUNK, plan.smem]


@pytest.mark.parametrize("b,h,w,cout,tile,box", [
    # UNet at the eval chunk: the fastest tiles of the sweep
    (16, 512, 512, 64, (256, 64), (16, 16, 1)),
    (16, 256, 256, 128, (128, 128), (16, 8, 1)),
    (16, 32, 32, 1024, (128, 128), (16, 8, 1)),
    # narrow channel counts take the 32-wide tile
    (16, 512, 512, 26, (256, 32), (16, 16, 1)),
    (16, 512, 512, 8, (256, 32), (16, 16, 1)),
    # the deepest slab: 120 blocks of 8-wide boxes fit the 132 SMs once,
    # where 16-wide boxes would need 144
    (2, 22, 36, 1024, (128, 128), (8, 8, 2)),
])
def test_f32_plan_choice(b, h, w, cout, tile, box):
    plan = f32_plan(b, h, w, cout)
    assert ((plan.bm, plan.bn), plan.box) == (tile, box)
    assert f32_tm(tile, box[0]) == (16 if box[0] >= 16 and tile[1] > 32
                                    else 8)


def test_f32_plan_refuses_a_box_it_cannot_take():
    with pytest.raises(ValueError):
        f32_plan(1, 8, 512, 64, box=(256, 1, 1))     # plane over 616
    with pytest.raises(ValueError):
        f32_plan(1, 8, 512, 64, box=(4, 8, 8))       # narrower than 8
    with pytest.raises(ValueError):
        f32_plan(1, 8, 512, 64, tile=(128, 64))      # not instantiated


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


def _refused(plan, kind):
    tw, th, tb = plan.box
    tiles_w, tiles_h, tiles_b, tiles_n = plan.tiles
    return {
        "smem": dataclasses.replace(plan, smem=plan.smem - 16),
        "chunk": dataclasses.replace(plan, chunk=8),
        "stages": dataclasses.replace(plan, stages=3),
        "grid": dataclasses.replace(plan, grid=(plan.grid[0] - 1, 1)),
        "height": dataclasses.replace(
            plan, tiles=(tiles_w, tiles_h - 1, tiles_b, tiles_n),
            grid=(plan.n_tiles - tiles_w * tiles_b * tiles_n, 1)),
        "tile": dataclasses.replace(plan, bn=plan.bn // 2),
        "plane": dataclasses.replace(plan, box=(8, 1, plan.bm // 8)),
        "narrow": dataclasses.replace(plan, box=(4, tw * th // 4, tb)),
    }[kind]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["smem", "chunk", "stages", "grid",
                                  "height", "tile", "plane", "narrow"])
def test_f32_launcher_refuses_a_bad_plan(cuda_device, kind):
    x, wt, scale, shift = (t.to(cuda_device) for t in
                           _inputs(2, 16, 24, 64, 64, seed=6))
    w_km = wt.permute(3, 0, 1, 2).contiguous()
    plan = conv_fused.plan_for(x, w_km)
    assert plan.body == "f32_box"
    before = conv_fused.counter.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        conv_fused.launch(x, w_km, scale, shift, True, _refused(plan, kind))
    torch.cuda.synchronize()
    assert conv_fused.counter.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,cin,cout,relu", CASES)
def test_f32_box_matches_plain_on_gpu(cuda_device, b, h, w, cin, cout, relu):
    torch.backends.cudnn.allow_tf32 = False
    x, wt, scale, shift = (t.to(cuda_device) for t in
                           _inputs(b, h, w, cin, cout, seed=cin + h + cout))
    runs = conv_fused.counter.bodies.get("f32_box", 0)
    got = conv_fused.conv3x3_affine_relu(x, wt, scale, shift, relu=relu)
    again = conv_fused.conv3x3_affine_relu(x, wt, scale, shift, relu=relu)
    want = conv3x3_affine_relu_torch(x, wt, scale, shift, relu=relu)
    torch.cuda.synchronize()
    assert conv_fused.counter.bodies["f32_box"] == runs + 2
    assert torch.equal(got, again)  # one accumulation order, no atomics
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
