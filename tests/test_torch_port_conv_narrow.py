"""The ``narrow`` body of kernel 1 (``csrc/conv3x3_narrow.cu``) replayed on
the CPU from its plan, its routing, and the JAX reference at its shapes.

The body runs only on the card.  What it reads and writes is set by the
plan (``ops/kernels/conv_plan.narrow_plan``) and by a few constants that
the source and the plan module share (the tiles, the chunk, the stages,
the shared-memory layout), so these tests replay it in float64 torch from
the same plan, byte address by byte address of one block's dynamic shared
memory, which starts as NaN:

* per persistent block, its tiles (blockIdx.x, + gridDim.x, ...), walked
  along W, H, then the batch, tile j to consumer warpgroup j % 2 and its
  own ring of two stages;
* the weights' one-time layout, 16-byte unit ((tap * KT + ks) * 2 + half)
  * N + n, zero past Cin and Cout;
* per tile and chunk, the TMA box (CK, TW + 2, TH + 2, 1) at (chunk * CK,
  x0 - 1, y0 - 1, b) with zero fill outside the tensor, written with TMA's
  32- or 64-byte swizzle into a stage that is NaN before each fill;
* the products: per 8 x 8 pixel block, tap and k16 step, the descriptors'
  rows (start, then 8-row groups a box row apart, rows a pixel apart) read
  through the same swizzle, and the weights through no-swizzle core
  matrices;
* the epilogue: each thread's accumulator pairs into the warpgroup's
  staging tile (NaN before each tile) at the swizzle of its row width, then
  each TMA store box mapped back to (b, y, x, n) and clipped to the tensor;
  or, where Cout % 8 != 0, each thread's channels stored from registers,
  masked.

Every output value must be written exactly once, and the result is held
against the plain version within 1e-5.  A random interleaving of the
producer and the two consumers checks the rings' mbarrier parities.  The
``cuda`` cases compare the kernel itself with the plain version on the
card.
"""

import dataclasses
import math
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jcfszxc_unet_tpu.ops.pallas.conv_fused import conv3x3_affine_relu_xla
from jcfszxc_unet_tpu_torch.ops.kernels import conv_fused
from jcfszxc_unet_tpu_torch.ops.kernels.conv_fused import (
    conv3x3_affine_relu_torch,
)
from jcfszxc_unet_tpu_torch.ops.kernels.conv_plan import (
    NARROW_INSTANCES,
    NARROW_SHAPES,
    NARROW_STAGES,
    NARROW_STATIC_SMEM,
    NARROW_TILES,
    SMEM_LIMIT,
    narrow_chunk,
    narrow_pixels,
    narrow_plan,
    narrow_smem,
    plan_conv,
    sm_count,
    takes_narrow,
)
from jcfszxc_unet_tpu_torch.scripts.conv_body_lists import (
    NARROW,
    NARROW_MODELS,
    UNET,
)

SPW = NARROW_STAGES // 2  # stages a consumer warpgroup


def _swizzle(lin, span):
    """TMA's (and wgmma's) swizzle of rows ``span`` bytes wide on byte
    offsets from a 1024-byte boundary: 16-byte chunk bits 4.. XOR address
    bits 7.. for rows of 32, 64 or 128 bytes; none for other widths (16 or
    48 bytes), which TMA moves unswizzled."""
    if span not in (32, 64, 128):
        return lin
    return lin ^ (((lin >> 7) & (span // 16 - 1)) << 4)


def _inputs(b, h, w, cin, cout, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, h, w, cin).astype(np.float32))
    wt = torch.from_numpy(
        (rng.randn(3, 3, cin, cout) / math.sqrt(9 * cin)).astype(np.float32))
    scale = torch.from_numpy((0.5 + rng.rand(cout)).astype(np.float32))
    shift = torch.from_numpy((0.1 * rng.randn(cout)).astype(np.float32))
    return x, wt, scale, shift


class _Smem:
    """A block's dynamic shared memory from the 1024-byte-aligned ring
    base, as bf16 slots (float64 here), and the offsets of its parts."""

    def __init__(self, plan, cin, cout):
        tw, th, _ = plan.box
        n, ck = plan.bn, plan.chunk
        self.stage = math.ceil((tw + 2) * (th + 2) * ck * 2 / 1024) * 1024
        self.staging = tw * th * cout * 2 if plan.tma_store else 0
        self.kt = math.ceil(cin / ck) * ck // 16
        self.staging0 = NARROW_STAGES * self.stage
        self.wts = self.staging0 + 2 * self.staging
        size = self.wts + 9 * self.kt * n * 32 + 8 * n
        assert size + 1024 == plan.smem  # conv_plan.narrow_smem
        self.mem = torch.full((size // 2,), float("nan"), dtype=torch.float64)

    def write(self, byte, values):
        self.mem[byte // 2] = values

    def read(self, byte):
        return self.mem[byte // 2]


def _layout_weights(sm, w_kmaj, n):
    """Unit i = ((tap * KT + ks) * 2 + half) * N + nn: channels 16 ks +
    8 half .. + 7 of output channel nn, zero past Cin and Cout."""
    cout, _, cin = w_kmaj.shape
    i = torch.arange(18 * sm.kt * n)
    nn, r = i % n, i // n
    half, tk = r % 2, r // 2
    ks, tap = tk % sm.kt, tk // sm.kt
    ch = (16 * ks + 8 * half)[:, None] + torch.arange(8)
    ok = (nn < cout)[:, None] & (ch < cin)
    v = w_kmaj.double()[nn.clamp(max=cout - 1)[:, None], tap[:, None],
                        ch.clamp(max=cin - 1)]
    sm.write(sm.wts + 16 * i[:, None] + 2 * torch.arange(8),
             torch.where(ok, v, torch.zeros(())))


def _fill(sm, s, x, plan, c, x0, y0, b):
    """The TMA load of chunk c's haloed box into stage s (NaN first)."""
    tw, th, _ = plan.box
    ck = plan.chunk
    bw, bh = tw + 2, th + 2
    bsz, h, w, cin = x.shape
    base = s * sm.stage
    sm.mem[base // 2:(base + sm.stage) // 2] = float("nan")
    p = torch.arange(bw * bh)
    gx, gy = x0 - 1 + p % bw, y0 - 1 + p // bw
    ch = c * ck + torch.arange(ck)
    ok = (((gx >= 0) & (gx < w) & (gy >= 0) & (gy < h))[:, None]
          & (ch < cin))
    v = x.double()[b, gy.clamp(0, h - 1)[:, None], gx.clamp(0, w - 1)[:, None],
                   ch.clamp(max=cin - 1)]
    lin = p[:, None] * (2 * ck) + 2 * torch.arange(ck)
    sm.write(base + _swizzle(lin, 2 * ck), torch.where(ok, v, torch.zeros(())))


def _products(sm, plan, s, c, acc):
    """Chunk c's products on stage s: per tap, k16 step and 8 x 8 pixel
    block, the A descriptor's 64 rows x 16 channels and the weights'
    N x 16."""
    tw, _, _ = plan.box
    n, ck = plan.bn, plan.chunk
    row, bw = 2 * ck, tw + 2
    sbo = bw * row
    r = torch.arange(64)[:, None]
    e = torch.arange(16)
    nn = torch.arange(n)[:, None]
    a0 = s * sm.stage
    for tap in range(9):
        toff = (tap // 3) * bw + tap % 3
        for k in range(ck // 16):
            ks = c * (ck // 16) + k
            wb = (sm.wts + (tap * sm.kt + ks) * n * 32 + (e // 8) * n * 16
                  + (nn // 8) * 128 + (nn % 8) * 16 + (e % 8) * 2)
            bmat = sm.read(wb)
            for mb in range(len(acc)):
                blk = (mb // (tw // 8)) * 8 * bw + (mb % (tw // 8)) * 8
                lin = ((blk + toff) * row + 32 * k + (r // 8) * sbo
                       + (r % 8) * row + 2 * e)
                acc[mb] += sm.read(a0 + _swizzle(lin, row)) @ bmat.T


def _thread_rows():
    """Each consumer thread's (accumulator row, x in the block, y in the
    block, first channel of its pairs) for its h = 0, 1 rows: t (128),
    h (2)."""
    t = torch.arange(128)[:, None]
    h = torch.arange(2)
    wq, lane = t // 32, t % 32
    return 16 * wq + lane // 4 + 8 * h, lane // 4 + 0 * h, 2 * wq + h, \
        2 * (t % 4)


def _epilogue(sm, plan, g, acc, scale, shift, relu, out, hits, x0, y0, b):
    tw, th, _ = plan.box
    n = plan.bn
    bsz, h, w, cout = out.shape
    r, xb, yb, n2 = _thread_rows()
    sc = torch.where(torch.arange(n) < cout,
                     scale.double()[torch.arange(n).clamp(max=cout - 1)], 0.)
    sh = torch.where(torch.arange(n) < cout,
                     shift.double()[torch.arange(n).clamp(max=cout - 1)], 0.)
    if plan.tma_store:  # boxes of IN channels, rows of RB bytes
        inner = min(n, 64)
        rb = 2 * inner
        px_tile = tw * th
        st = sm.staging0 + g * sm.staging
        sm.mem[st // 2:(st + sm.staging) // 2] = float("nan")
    for mb in range(len(acc)):
        bx, by = (mb % (tw // 8)) * 8, (mb // (tw // 8)) * 8
        for jn in range(n // 8):
            for e in range(2):
                ch = 8 * jn + n2 + e                       # (128, 1)
                v = acc[mb][r, ch] * sc[ch] + sh[ch]       # (128, 2)
                if relu:
                    v = v.clamp(min=0)
                if plan.tma_store:
                    px = (by + yb) * tw + bx + xb
                    lin = ((ch // inner) * (px_tile * rb) + px * rb
                           + (ch % inner) * 2)
                    sm.write(st + _swizzle(lin, rb), v)
                    continue
                xx, yy = x0 + bx + xb, y0 + by + yb
                ok = (xx < w) & (yy < h) & (ch < cout)
                idx = (b, yy[ok], xx[ok], ch.expand_as(xx)[ok])
                out[idx] = v[ok]
                hits[idx] += 1
    if plan.tma_store:  # a TMA store a box (IN, TW, TH, 1) at q IN
        p = torch.arange(tw * th)[:, None]
        ch = torch.arange(inner)
        for q in range(n // inner):
            lin = q * (px_tile * rb) + p * rb + ch * 2
            v = sm.read(st + _swizzle(lin, rb))
            xx = (x0 + p % tw).expand_as(v)
            yy = (y0 + p // tw).expand_as(v)
            ok = (xx < w) & (yy < h)
            idx = (b, yy[ok], xx[ok], (q * inner + ch).expand_as(v)[ok])
            out[idx] = v[ok]
            hits[idx] += 1


def _replay(plan, x, w_kmaj, scale, shift, relu):
    """The narrow body's loads, products and stores from its plan.
    Returns (out, hits)."""
    bsz, h, w, cin = x.shape
    cout = w_kmaj.shape[0]
    tiles_w, tiles_h, tiles_b, _ = plan.tiles
    tw, th, _ = plan.box
    n_tiles = tiles_w * tiles_h * tiles_b
    chunks = math.ceil(cin / plan.chunk)
    mb_count = plan.bm // 64
    out = torch.zeros((bsz, h, w, cout), dtype=torch.float64)
    hits = torch.zeros((bsz, h, w, cout), dtype=torch.int64)
    for block in range(plan.grid[0]):
        sm = _Smem(plan, cin, cout)
        _layout_weights(sm, w_kmaj, plan.bn)
        for j, tl in enumerate(range(block, n_tiles, plan.grid[0])):
            g = j % 2
            q, bx = divmod(tl, tiles_w)
            b, by = divmod(q, tiles_h)
            x0, y0 = bx * tw, by * th
            acc = [torch.zeros((64, plan.bn), dtype=torch.float64)
                   for _ in range(mb_count)]
            for c in range(chunks):
                it = (j // 2) * chunks + c
                s = g * SPW + it % SPW
                _fill(sm, s, x, plan, c, x0, y0, b)
                _products(sm, plan, s, c, acc)
            _epilogue(sm, plan, g, acc, scale, shift, relu, out, hits, x0,
                      y0, b)
    return out, hits


PAIRS = sorted({(k[3], k[4]) for k in NARROW})


# Every distinct Cin -> Cout of the narrow list, on small maps with odd H
# and W (ragged tiles on both edges), batch 1-2, ReLU on and off; sm_count
# 3 so that blocks walk several tiles and both warpgroups' rings turn.
CASES = [(1 + (i % 2), 13 + 2 * (i % 3), 11 + 4 * (i % 4), cin, cout,
          i % 3 != 0) for i, (cin, cout) in enumerate(PAIRS)]


@pytest.mark.parametrize("b,h,w,cin,cout,relu", CASES)
def test_narrow_replay_matches_plain(b, h, w, cin, cout, relu):
    x, wt, scale, shift = _inputs(b, h, w, cin, cout, seed=cin + cout + h)
    plan = plan_conv(b, h, w, cin, cout, torch.bfloat16, True, sm_count=3)
    assert plan.body == "narrow"
    w_kmaj = wt.permute(3, 0, 1, 2).reshape(cout, 9, cin)
    got, hits = _replay(plan, x, w_kmaj, scale, shift, relu)
    want = conv3x3_affine_relu_torch(x, wt, scale, shift, relu=relu)
    assert bool((hits == 1).all())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("cin,cout,box", [
    (32, 32, (16, 16)), (32, 32, (8, 32)), (32, 128, (8, 16)),
    (64, 17, (8, 32)), (8, 24, None), (32, 24, None)])
def test_narrow_replay_of_every_tile_shape(cin, cout, box):
    """The tiles and widths that the sweep may force besides the plan's
    (scripts/conv_tile_sweep.py, NARROW_SWEEP_TILES).  Cout 24, which no
    plan routes here, stages rows of 48 bytes that TMA stores unswizzled,
    so its staging writes take no swizzle either."""
    b, h, w = 2, 21, 19
    x, wt, scale, shift = _inputs(b, h, w, cin, cout, seed=5)
    plan = narrow_plan(b, h, w, cin, cout, sm_count=2, box=box)
    got, hits = _replay(plan, x, wt.permute(3, 0, 1, 2).reshape(cout, 9, cin),
                        scale, shift, True)
    assert bool((hits == 1).all())
    np.testing.assert_allclose(
        got.numpy(), conv3x3_affine_relu_torch(x, wt, scale, shift).numpy(),
        rtol=1e-5, atol=1e-5)


def _parity_wait(completed, parity):
    """mbarrier.try_wait.parity: passes while the barrier's current phase
    has the other parity."""
    return (completed & 1) != parity


def _run_block(n_local, chunks, seed):
    """One block's producer and two consumers at a random interleaving,
    with the kernel's stage and parity arithmetic: each wait must pass
    exactly when what it waits for has happened, and no fill may
    overwrite a stage whose consumer has not freed it."""
    full = [0] * NARROW_STAGES
    empty = [0] * NARROW_STAGES
    content = [None] * NARROW_STAGES
    freed = [True] * NARROW_STAGES
    uses = [0] * NARROW_STAGES

    def check_empty(s, parity):
        passes = _parity_wait(empty[s], parity)
        assert passes == (empty[s] >= uses[s]), (s, empty[s], uses[s])
        return passes

    def producer():
        for j in range(n_local):
            g = j % 2
            for c in range(chunks):
                it = (j // 2) * chunks + c
                s = g * SPW + it % SPW
                yield lambda s=s, it=it: check_empty(
                    s, ((it // SPW) & 1) ^ 1)
                assert freed[s], f"fill {(j, c)} overwrites stage {s}"
                content[s], freed[s] = (j, c), False
                uses[s] += 1
                full[s] += 1

    def check_full(s, it, want):
        k = it // SPW
        passes = _parity_wait(full[s], k & 1)
        assert passes == (full[s] == k + 1), (s, full[s], k)
        assert not passes or content[s] == want
        return passes

    def consumer(g):
        def free(s):
            freed[s] = True
            empty[s] += 1

        for j in range(g, n_local, 2):
            prev = None
            for c in range(chunks):
                it = (j // 2) * chunks + c
                s = g * SPW + it % SPW
                yield lambda s=s, it=it, want=(j, c): check_full(s, it, want)
                if prev is not None:
                    free(prev)  # wgmma_wait<1>
                prev = s
            free(prev)          # wgmma_wait<0>

    agents = [producer(), consumer(0), consumer(1)]
    waits = {i: next(a, None) for i, a in enumerate(agents)}
    rng = random.Random(seed)
    while any(w is not None for w in waits.values()):
        ready = [i for i, w in waits.items() if w is not None and w()]
        assert ready, "deadlock"
        i = rng.choice(ready)
        waits[i] = next(agents[i], None)
    assert all(freed)


@pytest.mark.parametrize("n_local,chunks", [(1, 1), (7, 1), (6, 2), (5, 6)])
def test_narrow_ring_parities(n_local, chunks):
    for seed in range(40):
        _run_block(n_local, chunks, seed)


def test_narrow_list_routing():
    """Every shape of the narrow list takes the body PERF.md gives it, and
    so does each model's list; the body takes the list's widths and no
    other; the plan's tile is 32 x 8 (16 x 16 where that does not fit:
    192 -> 32), 16 x 8 at Cout 64 and 128."""
    assert NARROW_SHAPES == set(PAIRS)
    for b, h, w, cin, cout, _ in NARROW:
        plan = plan_conv(b, h, w, cin, cout, torch.bfloat16, True, 132)
        assert plan.body == "narrow", (cin, cout)
        assert plan.box[:2] == ((16, 8) if cout > 32 else (16, 16)
                                if cin == 192 else (32, 8)), (cin, cout)
        assert plan.grid == (132, 1) and plan.tiles[3] == 1
    assert sum(n for calls in NARROW_MODELS.values()
               for n in calls.values()) == 55
    # unaligned operands, f32 and the im2col kernel never take it
    assert plan_conv(2, 16, 16, 32, 32, torch.bfloat16, False).body \
        == "mma_sync"
    assert plan_conv(2, 16, 16, 32, 32, torch.float32, True).body \
        == "f32_box"
    assert plan_conv(2, 16, 16, 32, 32, torch.bfloat16, True,
                     imcol=True).body == "wgmma"
    # wider on both sides, widths without an instance, and widths that no
    # sweep timed keep wgmma
    for cin, cout in ((64, 64), (32, 256), (32, 68), (256, 32), (64, 40),
                      (8, 64), (16, 128), (8, 24), (32, 24), (64, 16)):
        assert not takes_narrow(cin, cout)
        assert plan_conv(2, 16, 16, cin, cout, torch.bfloat16, True,
                         132).body == "wgmma"


# UNet's 18 convs at the eval chunk (16 x 512^2) and the train path's
# validation chunk (64 x 128^2) keep the plans they had before the narrow
# body: (body, bm, box, bn, stages, strip, grid, tiles, chunk, smem,
# schedule, tma_store, cluster) by (level, Cin, Cout).
UNET_PLANS_EVAL = {
    (0, 3, 64): ('mma_sync', 128, (16, 8, 1), 64, 2, 0, (396, 1), (32, 64, 16,
        1), 8, 44608, 0, 0, 1),
    (0, 64, 64): ('wgmma', 128, (128, 1, 1), 64, 4, 1, (132, 1), (4, 512, 16,
        1), 0, 0, 2, 1, 1),
    (0, 128, 64): ('wgmma', 128, (128, 1, 1), 64, 4, 1, (132, 1), (4, 512, 16,
        1), 0, 0, 2, 1, 1),
    (1, 64, 128): ('wgmma', 128, (128, 1, 1), 64, 4, 1, (132, 1), (2, 256, 16,
        2), 0, 0, 2, 1, 1),
    (1, 128, 128): ('wgmma', 128, (128, 1, 1), 64, 4, 1, (132, 1), (2, 256, 16,
        2), 0, 0, 2, 1, 1),
    (1, 256, 128): ('wgmma', 128, (128, 1, 1), 64, 4, 1, (132, 1), (2, 256, 16,
        2), 0, 0, 2, 1, 1),
    (2, 128, 256): ('wgmma', 128, (128, 1, 1), 64, 4, 1, (132, 1), (1, 128, 16,
        4), 0, 0, 2, 1, 1),
    (2, 256, 256): ('wgmma', 128, (128, 1, 1), 64, 4, 1, (132, 1), (1, 128, 16,
        4), 0, 0, 2, 1, 1),
    (2, 512, 256): ('wgmma', 128, (128, 1, 1), 64, 4, 1, (132, 1), (1, 128, 16,
        4), 0, 0, 2, 1, 1),
    (3, 256, 512): ('wgmma', 256, (64, 4, 1), 64, 4, 0, (132, 1), (1, 16, 16,
        8), 0, 0, 2, 1, 1),
    (3, 512, 512): ('wgmma', 128, (64, 2, 1), 256, 4, 0, (132, 1), (1, 32, 16,
        2), 0, 0, 0, 0, 2),
    (3, 1024, 512): ('wgmma', 128, (64, 2, 1), 256, 4, 0, (132, 1), (1, 32, 16,
        2), 0, 0, 0, 0, 2),
    (4, 512, 1024): ('wgmma', 256, (32, 8, 1), 128, 4, 0, (132, 1), (1, 4, 16,
        8), 0, 0, 0, 0, 1),
    (4, 1024, 1024): ('wgmma', 128, (32, 4, 1), 256, 4, 0, (132, 1), (1, 8, 16,
        4), 0, 0, 0, 0, 2),
}
UNET_PLANS_VAL = {
    (0, 3, 64): ('mma_sync', 128, (16, 8, 1), 64, 2, 0, (396, 1), (8, 16, 64,
        1), 8, 44608, 0, 0, 1),
    (0, 64, 64): ('wgmma', 128, (128, 1, 1), 64, 4, 1, (132, 1), (1, 128, 64,
        1), 0, 0, 2, 1, 1),
    (0, 128, 64): ('wgmma', 128, (128, 1, 1), 64, 4, 1, (132, 1), (1, 128, 64,
        1), 0, 0, 2, 1, 1),
    (1, 64, 128): ('wgmma', 256, (64, 4, 1), 64, 4, 0, (132, 1), (1, 16, 64,
        2), 0, 0, 2, 1, 1),
    (1, 128, 128): ('wgmma', 256, (64, 4, 1), 64, 4, 0, (132, 1), (1, 16, 64,
        2), 0, 0, 2, 1, 1),
    (1, 256, 128): ('wgmma', 128, (64, 2, 1), 128, 5, 0, (132, 1), (1, 32, 64,
        1), 0, 0, 1, 1, 1),
    (2, 128, 256): ('wgmma', 256, (32, 8, 1), 64, 4, 0, (132, 1), (1, 4, 64,
        4), 0, 0, 2, 1, 1),
    (2, 256, 256): ('wgmma', 256, (32, 8, 1), 64, 4, 0, (132, 1), (1, 4, 64,
        4), 0, 0, 2, 1, 1),
    (2, 512, 256): ('wgmma', 128, (32, 4, 1), 256, 4, 0, (132, 1), (1, 8, 64,
        1), 0, 0, 0, 0, 1),
    (3, 256, 512): ('wgmma', 256, (16, 16, 1), 64, 4, 0, (132, 1), (1, 1, 64,
        8), 0, 0, 2, 1, 1),
    (3, 512, 512): ('wgmma', 128, (16, 8, 1), 256, 4, 0, (132, 1), (1, 2, 64,
        2), 0, 0, 0, 0, 1),
    (3, 1024, 512): ('wgmma', 128, (16, 8, 1), 256, 4, 0, (132, 1), (1, 2, 64,
        2), 0, 0, 0, 0, 1),
    (4, 512, 1024): ('wgmma', 256, (8, 8, 4), 128, 4, 0, (128, 1), (1, 1, 16,
        8), 0, 0, 0, 0, 1),
    (4, 1024, 1024): ('wgmma', 256, (8, 8, 4), 128, 4, 0, (128, 1), (1, 1, 16,
        8), 0, 0, 0, 0, 1),
}


def _plan_values(p):
    return (p.body, p.bm, p.box, p.bn, p.stages, p.strip, p.grid, p.tiles,
            p.chunk, p.smem, p.schedule, p.tma_store, p.cluster)


def test_unet_plans_do_not_move():
    for batch, size, pinned in ((16, 512, UNET_PLANS_EVAL),
                                (64, 128, UNET_PLANS_VAL)):
        got = {(k, cin, cout): _plan_values(plan_conv(
            batch, size >> k, size >> k, cin, cout, torch.bfloat16, True,
            132)) for k, cin, cout in UNET}
        assert got == pinned


@pytest.mark.parametrize("n,ck", NARROW_INSTANCES)
def test_narrow_instances_fit_the_sm(n, ck):
    """Every instance's block fits in shared memory with one chunk and any
    of its tiles, some width of the list needs it, and every plan of the
    narrow list fits and names an instance."""
    for box in NARROW_TILES[narrow_pixels(n)]:
        smem = narrow_smem(ck, n, box, ck)
        assert smem + NARROW_STATIC_SMEM <= SMEM_LIMIT, (n, ck, box)
    assert any((-(-cout // 8) * 8, narrow_chunk(cin)) == (n, ck)
               for cin, cout in NARROW_SHAPES)
    for b, h, w, cin, cout, _ in NARROW:
        plan = narrow_plan(b, h, w, cin, cout, 132)
        assert plan.smem + NARROW_STATIC_SMEM <= SMEM_LIMIT
        assert (plan.bn, plan.chunk) in NARROW_INSTANCES
        assert list(plan.ints())[0] == 4


@pytest.mark.parametrize("cin,cout,relu", [(32, 32, False), (8, 17, True),
                                           (64, 2, True)])
def test_narrow_shapes_match_jax(cin, cout, relu):
    """The port's plain version, which the replay and the card's checks
    hold the body to, against the JAX package's reference on three list
    shapes at 16^2, f32."""
    x, wt, scale, shift = _inputs(2, 16, 16, cin, cout, seed=cin * cout)
    want = np.asarray(conv3x3_affine_relu_xla(
        jnp.asarray(x.numpy()), jnp.asarray(wt.numpy()),
        jnp.asarray(scale.numpy()), jnp.asarray(shift.numpy()), relu=relu))
    got = conv3x3_affine_relu_torch(x, wt, scale, shift, relu=relu)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,cin,cout,relu", CASES[::3] + [
    (2, 64, 64, 32, 32, True), (1, 37, 29, 192, 32, True)])
def test_narrow_matches_plain_on_gpu(cuda_device, b, h, w, cin, cout, relu):
    x, wt, scale, shift = (t.to(cuda_device) for t in
                           _inputs(b, h, w, cin, cout, seed=cin + w))
    x, wt = x.bfloat16(), wt.bfloat16()
    w_km = wt.permute(3, 0, 1, 2).contiguous()
    before = conv_fused.counter.bodies.get("narrow", 0)
    got = conv_fused.conv3x3_affine_relu_kmajor(x, w_km, scale, shift, relu)
    again = conv_fused.conv3x3_affine_relu_kmajor(x, w_km, scale, shift, relu)
    want = conv3x3_affine_relu_torch(x, wt, scale, shift, relu=relu)
    torch.cuda.synchronize()
    assert conv_fused.counter.bodies["narrow"] == before + 2
    assert torch.equal(got, again)  # one accumulation order
    err = float((got.float() - want.float()).abs().max())
    assert err <= 1e-2 * float(want.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,cin,cout", [(2, 19, 21, 8, 24),
                                            (1, 64, 72, 32, 24)])
def test_narrow_unswizzled_staging_on_gpu(cuda_device, b, h, w, cin, cout):
    """Cout 24 forced on the body: its 48-byte staging rows, stored by TMA
    unswizzled, land where the plain version puts them."""
    x, wt, scale, shift = (t.to(cuda_device) for t in
                           _inputs(b, h, w, cin, cout, seed=cin + h))
    x, wt = x.bfloat16(), wt.bfloat16()
    w_km = wt.permute(3, 0, 1, 2).contiguous()
    plan = narrow_plan(b, h, w, cin, cout, sm_count(cuda_device))
    got = conv_fused.launch(x, w_km, scale, shift, True, plan)
    want = conv3x3_affine_relu_torch(x, wt, scale, shift, relu=True)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    assert err <= 1e-2 * float(want.float().abs().max())


@pytest.mark.cuda
def test_launcher_refuses_a_wrong_narrow_plan(cuda_device):
    """A plan whose store route, shared memory or width the body does not
    take is refused, not run another way."""
    x, wt, scale, shift = (t.to(cuda_device) for t in
                           _inputs(2, 16, 16, 32, 32, seed=1))
    w_km = wt.bfloat16().permute(3, 0, 1, 2).contiguous()
    plan = narrow_plan(2, 16, 16, 32, 32, 132)
    for wrong in (dataclasses.replace(plan, tma_store=0),
                  dataclasses.replace(plan, smem=plan.smem + 1024),
                  dataclasses.replace(plan, bn=40)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            conv_fused.launch(x.bfloat16(), w_km, scale, shift, True, wrong)
