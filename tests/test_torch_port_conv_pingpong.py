"""The ``wgmma`` body's ping-pong schedule (csrc/conv3x3_wgmma.cuh,
PINGPONG) replayed on the CPU from the plan.

The kernel runs only on the card, so these tests replay what its plan
makes it do:

* the tiles of each persistent block go to consumer warpgroups 0 and 1
  alternately, each warpgroup multiplies whole tiles, and a pair of
  named barriers lets warpgroup g issue tile j's products only once the
  other has issued tile j - 1's;
* the ring: the producer fills stage it % STAGES for ring step it, tile
  after tile, and each warpgroup waits on its own tiles' stages with
  parity (it / STAGES) & 1.  An mbarrier wait on a parity passes while the
  barrier's completed phases differ in parity from it, so a wait is right
  only if the barrier is at most one phase away; a random interleaving of
  the three agents checks that each wait passes exactly when the fill it
  waits for has landed, holding that fill, and that no fill overwrites a
  stage that its consumer has not freed;
* the epilogue: where Cout % 8 == 0 each thread writes its accumulator
  pairs into the warpgroup's staging tile at the 128-byte swizzle's
  positions, and TMA stores each 64-channel box, clipped to the tensor;
  else (Cout % 8 != 0) channel pairs go out from registers, masked.  The
  swapped form (``pingpong_swap``: channels as the products' rows, pixels
  as their columns) writes its tile with ``stmatrix .trans``, replayed
  lane by lane from the instruction's definition.

Every output value must be written exactly once, and the result is held
against the plain version within 1e-5 in float64.  The ``cuda`` cases
compare the kernel itself with the plain version on the card.
"""

import dataclasses
import math
import random

import numpy as np
import pytest
import torch

from jcfszxc_unet_tpu_torch.ops.kernels import conv_fused
from jcfszxc_unet_tpu_torch.ops.kernels.conv_fused import (
    conv3x3_affine_relu_torch,
)
from jcfszxc_unet_tpu_torch.ops.kernels.conv_plan import (
    BK,
    SCHEDULES,
    SMEM_LIMIT,
    WGMMA_CONFIGS,
    WGMMA_CONSUMERS,
    plan_conv,
    schedule,
    wgmma_plan,
    wgmma_route,
    wgmma_smem,
)

PINGPONG = [c for c in WGMMA_CONFIGS if c[4]]
SWAP = SCHEDULES.index("pingpong_swap")


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


def _inputs(b, h, w, cin, cout, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(b, h, w, cin))
    wt = torch.from_numpy(rng.randn(3, 3, cin, cout) / math.sqrt(9 * cin))
    scale = torch.from_numpy(0.5 + rng.rand(cout))
    shift = torch.from_numpy(0.1 * rng.randn(cout))
    return x, wt, scale, shift


def _tile_origin(plan, tile):
    tiles_w, tiles_h, _, tiles_n = plan.tiles
    tw, th, tb = plan.box
    nt, m = tile % tiles_n, tile // tiles_n
    bx, m = m % tiles_w, m // tiles_w
    by, bb = m % tiles_h, m // tiles_h
    return bx * tw, by * th, bb * tb, nt * plan.bn


def _products(plan, x, w_kmaj, x0, y0, b0, n0, halo=1):
    """A tile's (BM, BN) sums over its K steps, from the stages' TMA
    boxes (one tap's box, or TH strips of 130 pixels read from row dx)."""
    tw, th, tb = plan.box
    bm, bn = plan.bm, plan.bn
    chunks = math.ceil(x.shape[3] / BK)
    r = torch.arange(bm)
    acc = torch.zeros((bm, bn), dtype=torch.float64)
    for kt in range((3 if plan.strip else 9) * chunks):
        step, c0 = kt // chunks, (kt % chunks) * BK
        if plan.strip:
            a = _box(x, (b0, y0 + step - halo, x0 - halo, c0),
                     (1, th, tw + 2, BK)).reshape(-1, BK)
            for dx in range(3):
                win = (r // tw) * (tw + 2) + r % tw + dx
                b = _box(w_kmaj, (n0, 3 * step + dx, c0), (bn, 1, BK))
                acc += a[win] @ b.reshape(bn, BK).T
            continue
        dy, dx = divmod(step, 3)
        a = _box(x, (b0, y0 + dy - halo, x0 + dx - halo, c0),
                 (tb, th, tw, BK)).reshape(bm, BK)
        b = _box(w_kmaj, (n0, step, c0), (bn, 1, BK))
        acc += a @ b.reshape(bn, BK).T
    return acc


def _fragment(bm, bn):
    """Row and column of accumulator [mi][j*4 + h*2 + e] of thread t of a
    warpgroup that holds a whole BM x BN tile (wgmma m64nBNk16), as
    tensors over (t, mi, h, j, e)."""
    t = torch.arange(128).view(-1, 1, 1, 1, 1)
    mi = torch.arange(bm // 64).view(1, -1, 1, 1, 1)
    h = torch.arange(2).view(1, 1, -1, 1, 1)
    j = torch.arange(bn // 8).view(1, 1, 1, -1, 1)
    e = torch.arange(2).view(1, 1, 1, 1, -1)
    rows = 64 * mi + 16 * (t // 32) + (t % 32) // 4 + 8 * h
    cols = 8 * j + 2 * (t % 4) + e
    return t, j, e, rows, cols


def _store_tma(plan, acc, out, hits, x0, y0, b0, n0):
    """Thread writes into the staging tile, then the TMA stores of its
    BN / 64 boxes.  Staging positions are in bf16 elements: box q, row r,
    16-byte chunk (j % 8) ^ ((t % 32) / 4), pair (t % 4) (the kernel's
    address); TMA reads box element (r, c) from chunk (c / 8) ^ (r % 8)."""
    bm, bn = plan.bm, plan.bn
    tw, th, _ = plan.box
    bsz, h, w, cout = out.shape
    t, j, e, rows, cols = _fragment(bm, bn)
    rows, cols = torch.broadcast_tensors(rows, cols)
    sw = (t % 32) // 4
    pos = ((j // 8) * bm * 64 + rows * 64 + (((j % 8) ^ sw) * 8)
           + (t % 4) * 2 + e)
    pos, rows, cols = pos.flatten(), rows.flatten(), cols.flatten()
    # every staging element written by exactly one thread's pair
    assert torch.equal(torch.sort(pos).values, torch.arange(bm * bn))
    staging = torch.full((bm * bn,), float("nan"), dtype=torch.float64)
    staging[pos] = acc[rows, cols]
    for q in range(bn // 64):
        if n0 + 64 * q >= cout:
            continue  # a box wholly past Cout is not stored
        r = torch.arange(bm).view(-1, 1)
        c = torch.arange(64).view(1, -1)
        vals = staging[q * bm * 64 + r * 64 + ((c // 8) ^ (r % 8)) * 8
                       + c % 8]
        xs = (x0 + r % tw).expand(-1, 64)
        ys = (y0 + (r // tw) % th).expand(-1, 64)
        bs = (b0 + r // (tw * th)).expand(-1, 64)
        ns = (n0 + 64 * q + c).expand(bm, -1)
        # TMA clips the box to the tensor
        keep = (xs < w) & (ys < h) & (bs < bsz) & (ns < cout)
        idx = (bs[keep], ys[keep], xs[keep], ns[keep])
        out[idx] = vals[keep]
        hits[idx] += 1


def _swap_staging(plan, acc):
    """The swapped form's staging tile.  Thread t = 32 w + l holds
    accumulator [mb][j*4 + h*2 + e] = D[channel 16 w + l / 4 + 8 h][pixel
    AN mb + 8 j + 2 (l % 4) + e] (AN = the tile's pixels, or 128 a strip
    row).  Each stmatrix .trans stores warp w's matrices i = 0..3, (j, h) =
    (j0 + i / 2, i % 2), whose row a = l / 4 and columns 2 (l % 4) + e are
    lane l's register i; memory row k of matrix i, at the address that lane
    8 i + k gives (the kernel's formula), receives column k: element a is
    D[channel 16 w + 8 h + a][pixel AN mb + 8 j + k]."""
    bm = plan.bm
    an = 128 if plan.strip else bm
    staging = torch.full((bm * 64,), float("nan"), dtype=torch.float64)
    hits = torch.zeros(bm * 64, dtype=torch.int64)
    w = torch.arange(4).view(-1, 1, 1, 1, 1, 1)
    mb = torch.arange(bm // an).view(1, -1, 1, 1, 1, 1)
    j0 = torch.arange(0, an // 8, 2).view(1, 1, -1, 1, 1, 1)
    i = torch.arange(4).view(1, 1, 1, -1, 1, 1)
    k = torch.arange(8).view(1, 1, 1, 1, -1, 1)
    a = torch.arange(8).view(1, 1, 1, 1, 1, -1)
    lane = 8 * i + k                     # the lane that gives the address
    pixel = an * mb + 8 * (j0 + lane // 16) + lane % 8
    chunk = (2 * w + (lane // 8) % 2) ^ (lane % 8)
    pos = pixel * 64 + chunk * 8 + a     # bf16 element of the staging tile
    src = 4 * a + k // 2                 # the lane whose register i holds it
    e = k % 2
    j, h = j0 + i // 2, i % 2
    ch = 16 * w + src // 4 + 8 * h
    px = an * mb + 8 * j + 2 * (src % 4) + e
    pos, ch, px = torch.broadcast_tensors(pos, ch, px)
    staging[pos.flatten()] = acc[px.flatten(), ch.flatten()]
    hits.index_add_(0, pos.flatten(), torch.ones(pos.numel(),
                                                 dtype=torch.int64))
    assert bool((hits == 1).all())  # every element written exactly once
    return staging


def _store_tma_swap(plan, acc, out, hits, x0, y0, b0, n0):
    """The swapped form's staging tile, then the TMA store of its box."""
    bm = plan.bm
    tw, th, _ = plan.box
    bsz, h, w, cout = out.shape
    staging = _swap_staging(plan, acc)
    r = torch.arange(bm).view(-1, 1)
    c = torch.arange(64).view(1, -1)
    vals = staging[r * 64 + ((c // 8) ^ (r % 8)) * 8 + c % 8]
    xs = (x0 + r % tw).expand(-1, 64)
    ys = (y0 + (r // tw) % th).expand(-1, 64)
    bs = (b0 + r // (tw * th)).expand(-1, 64)
    ns = (n0 + c).expand(bm, -1)
    keep = (xs < w) & (ys < h) & (bs < bsz) & (ns < cout)
    idx = (bs[keep], ys[keep], xs[keep], ns[keep])
    out[idx] = vals[keep]
    hits[idx] += 1


def _store_registers(plan, acc, out, hits, x0, y0, b0, n0):
    """Channel pairs from registers, rows outside the image or batch and
    channels past Cout masked."""
    bm, bn = plan.bm, plan.bn
    tw, th, _ = plan.box
    bsz, h, w, cout = out.shape
    _, _, _, rows, cols = _fragment(bm, bn)
    rows, cols = torch.broadcast_tensors(rows, cols)
    rows, cols = rows.flatten(), cols.flatten()
    xs, ys, bs = x0 + rows % tw, y0 + (rows // tw) % th, b0 + rows // (tw * th)
    ns = n0 + cols
    keep = (xs < w) & (ys < h) & (bs < bsz) & (ns < cout)
    idx = (bs[keep], ys[keep], xs[keep], ns[keep])
    out[idx] = acc[rows[keep], cols[keep]]
    hits[idx] += 1


def _replay(plan, x, w_kmaj, scale, shift, relu, h, w):
    """The ping-pong body on float64 operands: per block, local tile j to
    warpgroup j % 2, the tile's products, then the epilogue's route.
    Returns (out, hits, tiles each warpgroup took)."""
    bsz, cout = x.shape[0], w_kmaj.shape[0]
    out = torch.zeros((bsz, h, w, cout), dtype=torch.float64)
    hits = torch.zeros((bsz, h, w, cout), dtype=torch.int64)
    assert plan.tma_store == (plan.schedule > 0 and cout % 8 == 0)
    store = _store_tma if plan.tma_store else _store_registers
    if plan.schedule == SWAP:
        assert plan.tma_store  # the launcher refuses the rest
        store = _store_tma_swap
    taken = [0] * WGMMA_CONSUMERS
    grid = plan.grid[0]
    for block in range(grid):
        n_local = (plan.n_tiles - block + grid - 1) // grid
        # the kernel's loops: warpgroup wg takes j = wg, wg + 2, ...
        owner = {j: wg for wg in range(WGMMA_CONSUMERS)
                 for j in range(wg, n_local, WGMMA_CONSUMERS)}
        assert [owner[j] for j in range(n_local)] == [
            j % 2 for j in range(n_local)]
        for j in range(n_local):
            taken[owner[j]] += 1
            x0, y0, b0, n0 = _tile_origin(plan, block + j * grid)
            acc = _products(plan, x, w_kmaj, x0, y0, b0, n0)
            ns = (n0 + torch.arange(plan.bn)).clamp(max=cout - 1)
            acc = acc * scale[ns] + shift[ns]
            if relu:
                acc = acc.clamp(min=0)
            store(plan, acc, out, hits, x0, y0, b0, n0)
    return out, hits, taken


class _Ring:
    """The ring's mbarriers and the turn barriers as the kernel uses them,
    for one block: ``full[s]`` and ``empty[s]`` count completed phases."""

    def __init__(self, stages):
        self.stages = stages
        self.full = [0] * stages
        self.empty = [0] * stages
        self.content = [None] * stages   # ring step of the last fill
        self.freed = [True] * stages     # its consumer has freed it
        self.turn = [0] * WGMMA_CONSUMERS  # pending bar_arrive on BAR_TURN+g
        self.issued = []                 # tiles in the order issued


def _parity_wait(completed, parity):
    """mbarrier.try_wait.parity: passes while the barrier's current phase
    has the other parity."""
    return (completed & 1) != parity


def _producer(ring, n_local, kt_per_tile):
    s_count = ring.stages
    for it in range(n_local * kt_per_tile):
        s = it % s_count
        parity = ((it // s_count) & 1) ^ 1
        # the wait must pass only once use it - STAGES has been freed
        yield lambda s=s, p=parity, it=it: _check_empty(ring, s, p, it)
        assert ring.freed[s], f"fill {it} overwrites a stage in use"
        ring.content[s] = it
        ring.freed[s] = False
        ring.full[s] += 1


def _check_empty(ring, s, parity, it):
    passes = _parity_wait(ring.empty[s], parity)
    assert passes == (ring.empty[s] >= it // ring.stages), (
        f"empty[{s}] at {ring.empty[s]} phases answers {passes} for fill "
        f"{it}")
    return passes


def _check_full(ring, s, it):
    k = it // ring.stages
    passes = _parity_wait(ring.full[s], k & 1)
    assert passes == (ring.full[s] == k + 1), (
        f"full[{s}] at {ring.full[s]} phases answers {passes} for ring "
        f"step {it}")
    return passes


def _consumer(ring, wg, n_local, kt_per_tile, turn=True):
    def free(s):
        ring.freed[s] = True
        ring.empty[s] += 1  # the warpgroup's four warps complete the phase

    for j in range(wg, n_local, WGMMA_CONSUMERS):
        if j > 0 and turn:
            yield lambda: ring.turn[wg] > 0
            ring.turn[wg] -= 1
        ring.issued.append(j)
        prev = None
        for kt in range(kt_per_tile):
            it = j * kt_per_tile + kt
            s = it % ring.stages
            yield lambda s=s, it=it: _check_full(ring, s, it)
            assert ring.content[s] == it and not ring.freed[s]
            if prev is not None:
                free(prev)  # wgmma_wait<1>: the previous step's group
            prev = s
        if j + 1 < n_local and turn:
            # each bar_arrive meets the other warpgroup's next bar_sync
            assert ring.turn[wg ^ 1] == 0
            ring.turn[wg ^ 1] += 1
        free(prev)  # wgmma_wait<0>


def _run_block(n_local, kt_per_tile, stages, seed, turn=True):
    """One block's producer and two consumers, interleaved at random:
    every blocked agent whose wait passes may run next.  Returns the
    ring's final state."""
    ring = _Ring(stages)
    agents = [_producer(ring, n_local, kt_per_tile)] + [
        _consumer(ring, wg, n_local, kt_per_tile, turn)
        for wg in range(WGMMA_CONSUMERS)]
    waits = {}
    for i, agent in enumerate(agents):
        waits[i] = next(agent, None)
    rng = random.Random(seed)
    while any(w is not None for w in waits.values()):
        ready = [i for i, w in waits.items() if w is not None and w()]
        assert ready, "deadlock"
        i = rng.choice(ready)
        waits[i] = next(agents[i], None)
    return ring


def _k_steps(plan, cin):
    return (3 if plan.strip else 9) * math.ceil(cin / BK)


# (B, H, W, Cin, Cout, relu) for every ping-pong configuration: UNet's
# Cout <= 128 convs (64 -> 64, 64 -> 128, 128 -> 128, 256 -> 128,
# 128 -> 64) at small maps, ragged maps whose tiles cross the image and
# batch edges, Cin not a multiple of 64, Cout 96 (a tile's second box
# clipped), Cout 8, 16 and 32 (under one 64-channel box), and Cout 17 and
# 2 (Cout % 8 != 0: the register route).
CASES = [
    (2, 16, 16, 64, 64, True), (2, 16, 16, 64, 128, True),
    (2, 16, 16, 128, 128, True), (1, 16, 16, 256, 128, True),
    (2, 16, 16, 128, 64, True),
    (2, 37, 29, 72, 96, False), (3, 13, 11, 64, 64, True),
    (2, 9, 130, 16, 32, True), (2, 13, 11, 8, 8, True),
    (2, 13, 11, 64, 17, True), (2, 8, 8, 64, 2, False),
    (1, 19, 18, 32, 16, True),
]


@pytest.mark.parametrize("config,b,h,w,cin,cout,relu", [
    (config, *case) for config in PINGPONG for case in CASES
    if config[4] != SWAP or case[4] % 8 == 0], ids=str)
def test_pingpong_replay_matches_plain(config, b, h, w, cin, cout, relu):
    x, wt, scale, shift = _inputs(b, h, w, cin, cout, seed=cin + h + cout)
    plan = wgmma_plan(b, h, w, cout, config, sm_count=3)
    assert schedule(plan) in ("pingpong", "pingpong_swap")
    w_kmaj = wt.permute(3, 0, 1, 2).reshape(cout, 9, cin)
    got, hits, taken = _replay(plan, x, w_kmaj, scale, shift, relu, h, w)
    want = conv3x3_affine_relu_torch(x, wt, scale, shift, relu=relu)
    assert bool((hits == 1).all())
    # each block's odd local tiles went to warpgroup 1
    grid = plan.grid[0]
    assert taken[1] == sum((plan.n_tiles - blk + grid - 1) // grid // 2
                           for blk in range(grid))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("config", PINGPONG, ids=str)
@pytest.mark.parametrize("b,h,w,cin", [
    (16, 512, 512, 64),   # UNet's 512^2 convs at the eval chunk
    (16, 256, 256, 128),  # its 256^2 ones
    (2, 37, 29, 8),       # a ragged map, one 64-channel K step
    (1, 13, 11, 1024),    # many K steps, fewer tiles than blocks
])
def test_pingpong_ring_parities(config, b, h, w, cin):
    """Each consumer's waits against the producer's order, for a block of
    the plan with the most tiles, under random interleavings."""
    plan = wgmma_plan(b, h, w, config[1], config, sm_count=132)
    n_local = min(-(-plan.n_tiles // plan.grid[0]), 9)
    kt = _k_steps(plan, cin)
    for seed in range(6):
        ring = _run_block(n_local, kt, plan.stages, seed)
        # tiles issued in order, the turn alternating the warpgroups
        assert ring.issued == list(range(n_local))
        assert ring.full == [len(range(s, n_local * kt, plan.stages))
                             for s in range(plan.stages)]
        assert ring.empty == ring.full and all(ring.freed)


def test_without_the_turn_a_parity_wait_passes_early():
    """The checks have teeth: without the turn barrier, warpgroup 1 waits
    on tile 1's first stage while tile 0's fills still cycle the ring, and
    a wait passes on the wrong fill (or, at another interleaving, never)."""
    failures = 0
    for seed in range(20):
        try:
            _run_block(4, 9, 4, seed, turn=False)
        except AssertionError:
            failures += 1
    assert failures > 0


@pytest.mark.parametrize("config", WGMMA_CONFIGS, ids=str)
def test_wgmma_configuration_fits_the_sm(config):
    bm, bn, stages, strip, sched = config
    # dynamic shared memory, plus the 2 * stages mbarriers
    assert wgmma_smem(config) + 16 * stages <= SMEM_LIMIT
    rows = bm if sched else bm // WGMMA_CONSUMERS
    assert rows % 64 == 0 and rows // 64 * bn // 2 <= 128  # registers
    assert not strip or bm % 128 == 0
    assert sched != SWAP or bn == 64  # the channels are wgmma's 64 rows
    plan = wgmma_plan(4, 37, 140, 96, config, sm_count=132)
    ints = list(plan.ints())
    # Cout 96: TMA stores ping-pong; no cluster
    assert ints[:11] == [3, bm, *plan.box, bn, stages, strip, sched,
                         int(sched > 0), 1]


def test_schedule_choice():
    """Cout <= 128 takes a ping-pong plan, swapped where Cout % 8 == 0
    (which stores by TMA), and so does Cin 256 into Cout 512; the deep
    layers on narrow maps keep the cooperative tiles.  (The wgmma body's
    own plans: plan_conv routes 8 -> 16 and 64 -> 17 to the narrow body.)"""
    for cin, cout, w in ((64, 64, 512), (128, 64, 512), (64, 128, 256),
                         (256, 128, 256), (512, 256, 128), (64, 64, 64),
                         (128, 128, 64), (8, 16, 64), (256, 512, 64),
                         (256, 256, 32)):
        plan = wgmma_route(16, w, w, cin, cout)
        assert schedule(plan) == "pingpong_swap" and plan.bn == 64
        assert plan.strip == (w >= 128) and plan.tma_store
    for cin, cout, w in ((64, 17, 512), (64, 96 + 1, 37), (256, 128, 64),
                         (320, 64, 32)):
        plan = wgmma_route(16, w, w, cin, cout)
        assert schedule(plan) == "pingpong" and plan.bn <= 128
        assert plan.tma_store == (cout % 8 == 0)
    for cin, cout, w in ((512, 512, 64), (1024, 1024, 32), (512, 1024, 32),
                         (1024, 512, 64), (512, 512, 16), (512, 256, 32)):
        plan = wgmma_route(16, w, w, cin, cout)
        # on 64-wide maps in clusters (tests/test_torch_port_conv_cluster.py)
        assert schedule(plan).split("/")[0] == "cooperative"
        assert not plan.tma_store
    assert schedule(plan_conv(2, 16, 16, 3, 64, torch.bfloat16, True)) is None


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("config", PINGPONG, ids=str)
@pytest.mark.parametrize("b,h,w,cin,cout,relu", [
    (2, 64, 256, 64, 64, True), (2, 37, 29, 72, 96, False),
    (2, 13, 11, 64, 17, True), (2, 64, 64, 128, 128, True),
])
def test_pingpong_matches_plain_on_gpu(cuda_device, config, b, h, w, cin,
                                       cout, relu):
    x, wt, scale, shift = (t.float().to(cuda_device) for t in
                           _inputs(b, h, w, cin, cout, seed=cin + w))
    x, wt = x.bfloat16(), wt.bfloat16()
    w_km = wt.permute(3, 0, 1, 2).contiguous()
    plan = wgmma_plan(b, h, w, cout, config,
                      torch.cuda.get_device_properties(
                          cuda_device).multi_processor_count)
    key = f"wgmma/{schedule(plan)}"
    if not plan.tma_store and plan.schedule == SWAP:
        with pytest.raises(RuntimeError, match="CUDA error"):
            conv_fused.launch(x, w_km, scale, shift, relu, plan)
        return
    before = conv_fused.counter.schedules.get(key, 0)
    got = conv_fused.launch(x, w_km, scale, shift, relu, plan)
    again = conv_fused.launch(x, w_km, scale, shift, relu, plan)
    want = conv3x3_affine_relu_torch(x, wt, scale, shift, relu=relu)
    torch.cuda.synchronize()
    assert conv_fused.counter.schedules[key] == before + 2
    assert torch.equal(got, again)  # one accumulation order
    err = float((got.float() - want.float()).abs().max())
    assert err <= 1e-2 * float(want.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("config,cout", [
    ((256, 64, 4, 0, 1), 64), ((256, 64, 4, 0, 1), 17),
    ((128, 256, 4, 0, 0), 256)], ids=str)
def test_launcher_refuses_a_plan_whose_store_route_is_wrong(
        cuda_device, config, cout):
    """The plan says whether the epilogue stores by TMA; the launcher
    refuses a plan whose ``tma_store`` the schedule and Cout do not allow,
    whichever way it is wrong."""
    b, h, w, cin = 2, 16, 16, 64
    x, wt, scale, shift = (t.float().to(cuda_device) for t in
                           _inputs(b, h, w, cin, cout, seed=3))
    w_km = wt.bfloat16().permute(3, 0, 1, 2).contiguous()
    plan = wgmma_plan(b, h, w, cout, config,
                      torch.cuda.get_device_properties(
                          cuda_device).multi_processor_count)
    wrong = dataclasses.replace(plan, tma_store=1 - plan.tma_store)
    with pytest.raises(RuntimeError, match="CUDA error"):
        conv_fused.launch(x.bfloat16(), w_km, scale, shift, True, wrong)
