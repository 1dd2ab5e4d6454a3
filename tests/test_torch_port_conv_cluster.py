"""The ``wgmma`` body's clusters (csrc/conv3x3_wgmma.cuh) replayed on the
CPU from the plan.

A plan may launch the body in clusters of two CTAs along the pixel tiles
(``conv_plan.CLUSTERS``; the configurations of ``conv_plan.CLUSTERED``
only), which share the weights' box: each CTA loads BN / 2 of its rows
and multicasts them by TMA into the same stage of both, and loads its own
A box.  These tests replay what the plan makes the kernel do:

* the tile groups: a cluster walks groups of two pixel tiles of one Cout
  block in lockstep, both CTAs the same number; every output tile is
  written exactly once, and a group past an odd count of pixel tiles
  holds a tile past the batch whose loads are zeros and whose stores are
  dropped;
* the stage: the parts the CTAs load assemble the same weights' box as
  one load without a cluster, so each output is the same sum;
* the multicast ring: each CTA's producer fills its stage in its own
  and its peer's shared memory, and each consumer frees a stage on the
  empty barrier of both CTAs.  Under random interleavings of both CTAs'
  producers and consumers, each wait passes exactly when its fill has
  landed (or its stage has been freed in both), and no part of a fill
  lands in a stage that a CTA still reads.  Without the remote arrivals
  a fill does overwrite a stage its peer still reads;
* shared memory: each part lands on the swizzle's 1024-byte atoms of a
  stage laid out as without a cluster; and the plans: whole clusters,
  the cooperative deep layers in pairs, no cluster for a configuration
  without a clustered instance, and the shapes that keep no cluster keep
  the plan they had.

The ``cuda`` cases hold the clustered kernel against the plain version
and against the same configuration without a cluster, bit for bit, and
check that the launcher refuses a cluster it has no instance for.
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
    CLUSTERED,
    CLUSTERS,
    SMEM_LIMIT,
    WGMMA_CONFIGS,
    plan_conv,
    schedule,
    wgmma_groups,
    wgmma_plan,
    wgmma_smem,
)
from tests.test_torch_port_conv_pingpong import (
    _box,
    _inputs,
    _products,
    _store_registers,
    _store_tma,
    _store_tma_swap,
)


def _tile(plan, g, rank):
    """Tile of cluster CTA ``rank`` in group g: (pixel tile m, Cout block
    nt), as the kernel's tile_origin numbers them."""
    tn = plan.tiles[3]
    return (g // tn) * plan.cluster + rank, g % tn


def _origin(plan, m, nt):
    tiles_w, tiles_h, _, _ = plan.tiles
    tw, th, tb = plan.box
    bx, m = m % tiles_w, m // tiles_w
    by, bb = m % tiles_h, m // tiles_h
    return bx * tw, by * th, bb * tb, nt * plan.bn


def _walk(plan):
    """{(cluster, rank): [group, ...]} of the kernel's loops."""
    cs = plan.cluster
    n_clusters = plan.grid[0] // cs
    groups = wgmma_groups(plan)
    return {(c, r): list(range(c, groups, n_clusters))
            for c in range(n_clusters) for r in range(cs)}


def _stage_parts(plan, x, w_kmaj, x0, y0, b0, n0, kt, halo=1):
    """One K step's stage as the cluster's CTAs load it: the CTA's own A
    box, and the weights' rows from each CTA's part, put at the part's
    offset.  Returns (A rows, [weights rows of each tap])."""
    tw, th, tb = plan.box
    cm, bn = plan.cluster, plan.bn
    chunks = math.ceil(x.shape[3] / BK)
    step, c0 = kt // chunks, (kt % chunks) * BK
    dy, dx = (step, 0) if plan.strip else divmod(step, 3)
    xa, ya = x0 + dx - halo, y0 + dy - halo
    a = _box(x, (b0, ya, xa, c0),
             (tb, th, tw + (2 if plan.strip else 0), BK)).reshape(-1, BK)
    rows = bn // cm
    taps = [3 * step + d for d in range(3)] if plan.strip else [step]
    w = [torch.cat([_box(w_kmaj, (n0 + rm * rows, tap, c0), (rows, 1, BK))
                    .reshape(rows, BK) for rm in range(cm)]) for tap in taps]
    return a, w


def _stage_whole(plan, x, w_kmaj, x0, y0, b0, n0, kt, halo=1):
    """The same stage from one load of each box (no cluster)."""
    return _stage_parts(dataclasses.replace(plan, cluster=1), x,
                        w_kmaj, x0, y0, b0, n0, kt, halo)


def _replay(plan, x, w_kmaj, scale, shift, relu, h, w):
    """The clustered body on float64 operands: each CTA's groups, each
    tile's products from the assembled stages, the epilogue's route."""
    bsz, cout = x.shape[0], w_kmaj.shape[0]
    out = torch.zeros((bsz, h, w, cout), dtype=torch.float64)
    hits = torch.zeros((bsz, h, w, cout), dtype=torch.int64)
    assert plan.tma_store == (plan.schedule > 0 and cout % 8 == 0)
    store = _store_tma if plan.tma_store else _store_registers
    if plan.schedule == 2:
        store = _store_tma_swap
    chunks = math.ceil(x.shape[3] / BK)
    kts = (3 if plan.strip else 9) * chunks
    walk = _walk(plan)
    m_tiles = plan.tiles[0] * plan.tiles[1] * plan.tiles[2]
    for (_, rank), groups in walk.items():
        for g in groups:
            m, nt = _tile(plan, g, rank)
            x0, y0, b0, n0 = _origin(plan, m, nt)
            if m >= m_tiles:
                assert b0 >= bsz  # the tile past the batch
            for kt in (0, kts - 1):
                got_a, got_w = _stage_parts(plan, x, w_kmaj, x0, y0, b0, n0,
                                            kt)
                want_a, want_w = _stage_whole(plan, x, w_kmaj, x0, y0, b0,
                                              n0, kt)
                assert torch.equal(got_a, want_a)
                assert all(torch.equal(a, b) for a, b in zip(got_w, want_w))
                if b0 >= bsz:
                    assert not got_a.any()
            acc = _products(plan, x, w_kmaj, x0, y0, b0, n0)
            ns = (n0 + torch.arange(plan.bn)).clamp(max=cout - 1)
            acc = acc * scale[ns] + shift[ns]
            if relu:
                acc = acc.clamp(min=0)
            store(plan, acc, out, hits, x0, y0, b0, n0)
    return out, hits


# (B, H, W, Cin, Cout, relu): batch 2 with odd pixel-tile counts (one
# tile of the last group lies past the batch) and an odd count of Cout
# blocks; Cin not a multiple of 64; Cout % 8 != 0; an even count.
CASES = [(2, 9, 11, 72, 512, False), (2, 5, 24, 16, 192, True),
         (1, 13, 9, 64, 100, True), (2, 16, 16, 64, 256, True)]


@pytest.mark.parametrize("config", CLUSTERED, ids=str)
@pytest.mark.parametrize("b,h,w,cin,cout,relu", CASES)
def test_cluster_replay_matches_plain(config, b, h, w, cin, cout, relu):
    x, wt, scale, shift = _inputs(b, h, w, cin, cout, seed=cin + cout)
    plan = wgmma_plan(b, h, w, cout, config, sm_count=4, cluster=2)
    w_kmaj = wt.permute(3, 0, 1, 2).reshape(cout, 9, cin)
    got, hits = _replay(plan, x, w_kmaj, scale, shift, relu, h, w)
    want = conv3x3_affine_relu_torch(x, wt, scale, shift, relu=relu)
    assert bool((hits == 1).all())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("cluster", CLUSTERS, ids=str)
@pytest.mark.parametrize("b,h,w,cout", [
    (2, 16, 16, 256), (2, 9, 11, 512), (1, 13, 9, 100), (16, 64, 64, 512),
    (64, 16, 16, 1024)])
def test_tile_groups_cover_each_tile_once(b, h, w, cout, cluster):
    """Every cluster walks the same groups in each of its CTAs; every
    tile of the map is some CTA's exactly once; a tile past the map (an
    odd pixel-tile count) is only in the last group."""
    plan = wgmma_plan(b, h, w, cout, (128, 256, 4, 0, 0), sm_count=132,
                      cluster=cluster)
    assert plan.grid[0] % cluster == 0 and plan.grid[0] <= 132
    walk = _walk(plan)
    m_tiles = plan.tiles[0] * plan.tiles[1] * plan.tiles[2]
    seen = {}
    for (c, rank), groups in walk.items():
        assert groups == walk[(c, 0)]  # lockstep
        for g in groups:
            seen.setdefault(_tile(plan, g, rank), []).append(g)
    real = {(m, nt) for m in range(m_tiles) for nt in range(plan.tiles[3])}
    assert real <= set(seen) and all(len(v) == 1 for v in seen.values())
    for (m, nt) in set(seen) - real:
        assert m == m_tiles and m_tiles % 2 == 1
    assert len(seen) == wgmma_groups(plan) * cluster


class _Cta:
    """One CTA's ring: completed phases of full[s] and empty[s], the
    empty arrivals of the current phase, the parts landed in each stage
    and whether its local producer has armed the phase, and what each
    stage holds."""

    def __init__(self, stages):
        self.full = [0] * stages
        self.empty = [0] * stages
        self.arrived = [0] * stages
        self.landed = [set() for _ in range(stages)]
        self.armed = [False] * stages
        self.content = [None] * stages   # ring step of the landed fill
        self.reading = [False] * stages  # a consumer reads the stage
        self.freed = [None] * stages     # ring step its consumer freed


def _parity_wait(completed, parity):
    return (completed & 1) != parity


def _run_cluster(plan, n_local, kt, seed, remote=True):
    """Both CTAs' producers and consumers (one consumer a CTA, as the
    cooperative schedule's two warpgroups free each stage together),
    interleaved at random, each remote arrival a step of its own.  Each
    producer fills both CTAs (its weights' part), and both fill each
    CTA's stages.  ``remote=False``: the kernel without the cluster's
    arrivals (each consumer frees only its own CTA's stage, whose empty
    barrier then counts one CTA's consumers)."""
    cs = plan.cluster
    stages = plan.stages
    both = set(range(cs))
    masks = [(both, both) for _ in range(cs)]  # (targets, writers)
    ctas = [_Cta(stages) for _ in range(cs)]
    need = [cs if remote else 1 for _ in range(cs)]

    def land(src, it):
        s = it % stages
        for dst in masks[src][0]:
            c = ctas[dst]
            assert it < stages or c.freed[s] == it - stages, (
                f"CTA {src}'s fill {it} lands in CTA {dst}'s stage {s}, "
                f"which still holds fill {c.content[s]} (reading: "
                f"{c.reading[s]})")
            assert c.full[s] == it // stages, "fill lands in another phase"
            c.landed[s].add(src)
            _complete_full(c, dst, s, it)

    def _complete_full(c, rank, s, it):
        writers = masks[rank][1]
        if c.armed[s] and c.landed[s] == writers:
            c.full[s] += 1
            c.content[s] = it
            c.armed[s] = False
            c.landed[s] = set()

    def producer(rank):
        me = ctas[rank]
        for it in range(n_local * kt):
            s = it % stages
            parity = ((it // stages) & 1) ^ 1

            def ready(s=s, parity=parity, it=it):
                passes = _parity_wait(me.empty[s], parity)
                assert passes == (me.empty[s] >= it // stages)
                return passes
            yield ready
            me.armed[s] = True          # arrive.expect_tx: the whole stage
            _complete_full(me, rank, s, it)
            land(rank, it)              # its parts, in every target

    rng = random.Random(seed)

    def free(rank, s):
        ctas[rank].reading[s] = False
        ctas[rank].freed[s] = ctas[rank].content[s]
        dests = sorted(masks[rank][1]) if remote else [rank]
        rng.shuffle(dests)
        for dst in dests:
            yield lambda: True
            c = ctas[dst]
            c.arrived[s] += 1
            if c.arrived[s] == need[dst]:
                c.arrived[s] = 0
                c.empty[s] += 1

    def consumer(rank):
        me = ctas[rank]
        prev = None
        for it in range(n_local * kt):
            s = it % stages
            k = it // stages

            def ready(s=s, k=k, it=it):
                passes = _parity_wait(me.full[s], k & 1)
                assert passes == (me.full[s] == k + 1), (
                    f"CTA {rank}'s full[{s}] at {me.full[s]} phases answers "
                    f"{passes} for ring step {it}")
                return passes
            yield ready
            assert me.content[s] == it
            me.reading[s] = True
            if prev is not None:
                yield from free(rank, prev)   # wgmma_wait<1>
            prev = s
        yield from free(rank, prev)           # wgmma_wait<0>

    agents = [producer(r) for r in range(cs)] + [consumer(r)
                                                 for r in range(cs)]
    waits = {i: next(a, None) for i, a in enumerate(agents)}
    while any(w is not None for w in waits.values()):
        ready = [i for i, w in waits.items() if w is not None and w()]
        assert ready, "deadlock"
        i = rng.choice(ready)
        waits[i] = next(agents[i], None)
    return ctas


@pytest.mark.parametrize("n_local,kt", [(3, 5), (1, 9), (5, 2)])
@pytest.mark.parametrize("config", CLUSTERED, ids=str)
def test_multicast_ring_waits(config, n_local, kt):
    """Each CTA's waits against the cluster's fills, under random
    interleavings: every full wait passes exactly when all parts of its
    fill have landed, every empty wait exactly when both CTAs have freed
    the stage, and no part lands in a stage still read."""
    plan = wgmma_plan(16, 64, 64, 512, config, sm_count=132, cluster=2)
    steps = n_local * kt
    for seed in range(4):
        ctas = _run_cluster(plan, n_local, kt, seed)
        for c in ctas:
            assert c.full == [len(range(s, steps, plan.stages))
                              for s in range(plan.stages)]
            assert c.empty == c.full and not any(c.reading)


def test_without_the_remote_arrivals_a_fill_overwrites_a_read_stage():
    """The checks have teeth: where each consumer frees only its own
    CTA's stage, a producer refills a stage that it multicasts into
    while a peer still reads it."""
    plan = wgmma_plan(16, 64, 64, 512, (128, 256, 4, 0, 0), sm_count=132,
                      cluster=2)
    failures = 0
    for seed in range(20):
        try:
            _run_cluster(plan, 3, 5, seed, remote=False)
        except AssertionError as err:
            assert "still holds" in str(err) or "phase" in str(err)
            failures += 1
    assert failures > 0
    for seed in range(20):
        _run_cluster(plan, 3, 5, seed, remote=True)


@pytest.mark.parametrize("config", WGMMA_CONFIGS, ids=str)
def test_parts_land_on_swizzle_atoms(config):
    """A cluster keeps the stage's layout and shared memory; each CTA's
    BN / 2 rows of the weights' box land on a 1024-byte atom of the
    128-byte swizzle, so they are swizzled as the whole box would be.  A
    configuration without a clustered instance takes no cluster."""
    bm, bn, stages, strip, sched = config
    assert wgmma_smem(config) + 16 * stages <= SMEM_LIMIT
    if config in CLUSTERED:
        assert sched == 0  # the cooperative schedule
        plan = wgmma_plan(16, 64, 64, 512, config, 132, cluster=2)
        assert plan.cluster == 2 and (bn // 2) * BK * 2 % 1024 == 0
    else:
        with pytest.raises(ValueError, match="no wgmma cluster"):
            wgmma_plan(16, 64, 64, 512, config, 132, cluster=2)


def test_cluster_choice():
    """The cooperative 128 x 256 tile into Cout >= 512 takes pairs along
    the pixel tiles on maps at least 32 wide; no other plan takes a
    cluster."""
    for b, h, w, cin, cout in ((16, 64, 64, 512, 512),
                               (16, 64, 64, 1024, 512),
                               (16, 32, 32, 1024, 1024),
                               (2, 65, 64, 512, 512), (2, 73, 70, 512, 512)):
        plan = plan_conv(b, h, w, cin, cout, torch.bfloat16, True)
        assert (plan.bm, plan.bn, plan.cluster) == (128, 256, 2)
        assert schedule(plan) == "cooperative/cluster2"
    for b, hw, cin, cout in ((16, 32, 512, 1024), (64, 32, 512, 256),
                             (16, 64, 256, 512), (16, 128, 512, 256),
                             (64, 16, 1024, 512), (64, 8, 512, 1024)):
        plan = plan_conv(b, hw, hw, cin, cout, torch.bfloat16, True)
        assert plan.cluster == 1


@pytest.mark.parametrize("b,h,w,cin,cout", [
    (16, 512, 512, 64, 64), (16, 256, 256, 128, 128), (16, 512, 512, 128, 64),
    (64, 32, 32, 128, 64), (64, 128, 128, 128, 64), (2, 37, 29, 72, 96),
    (16, 64, 64, 256, 512), (16, 32, 32, 1024, 1024),
    (16, 128, 128, 512, 256), (64, 16, 16, 1024, 512), (2, 8, 8, 256, 320)])
def test_plan_grid_is_whole_clusters(b, h, w, cin, cout):
    """Every plan's grid is a multiple of its cluster and at most the
    SMs; a plan without a cluster is the one it was: one block a tile up
    to the SMs."""
    plan = plan_conv(b, h, w, cin, cout, torch.bfloat16, True, sm_count=132)
    cs = plan.cluster
    assert plan.grid[0] % cs == 0 and plan.grid[0] <= 132
    assert plan.grid[0] == min(wgmma_groups(plan), 132 // cs) * cs
    config = (plan.bm, plan.bn, plan.stages, plan.strip, plan.schedule)
    bare = wgmma_plan(b, h, w, cout, config, 132)
    assert bare.grid == (min(bare.n_tiles, 132), 1)
    if plan.cluster == 1:
        assert plan == bare
    else:
        assert schedule(plan).endswith(f"/cluster{cs}")
        assert dataclasses.replace(plan, cluster=1, grid=bare.grid) == bare


def test_cout_le_128_and_the_probe_keep_no_cluster():
    """The Cout <= 128 shapes and kernel 3's probe keep their plans."""
    for b, hw, cin, cout in ((16, 512, 64, 64), (16, 256, 128, 128),
                             (64, 128, 128, 64), (2, 64, 8, 17)):
        plan = plan_conv(b, hw, hw, cin, cout, torch.bfloat16, True)
        assert plan.cluster == 1
    probe = plan_conv(64, 128, 128, 128, 64, torch.bfloat16, True,
                      imcol=True)
    assert probe.cluster == 1 and schedule(probe) == "pingpong_swap"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("config", CLUSTERED, ids=str)
@pytest.mark.parametrize("b,h,w,cin,cout,relu", [
    (2, 16, 16, 64, 256, True), (2, 9, 11, 72, 512, False),
    (1, 13, 9, 64, 100, True), (2, 64, 128, 256, 256, True),
    (2, 65, 64, 512, 512, True)])
def test_cluster_matches_plain_on_gpu(cuda_device, config, b, h, w, cin,
                                      cout, relu):
    """The clustered kernel against the plain version, and bit for bit
    against the same configuration without a cluster (only the loads
    differ) and against itself."""
    x, wt, scale, shift = (t.float().to(cuda_device) for t in
                           _inputs(b, h, w, cin, cout, seed=cin + w))
    x, wt = x.bfloat16(), wt.bfloat16()
    w_km = wt.permute(3, 0, 1, 2).contiguous()
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = wgmma_plan(b, h, w, cout, config, sms, cluster=2)
    bare = wgmma_plan(b, h, w, cout, config, sms)
    key = f"wgmma/{schedule(plan)}"
    before = conv_fused.counter.schedules.get(key, 0)
    got = conv_fused.launch(x, w_km, scale, shift, relu, plan)
    again = conv_fused.launch(x, w_km, scale, shift, relu, plan)
    alone = conv_fused.launch(x, w_km, scale, shift, relu, bare)
    want = conv3x3_affine_relu_torch(x, wt, scale, shift, relu=relu)
    torch.cuda.synchronize()
    assert conv_fused.counter.schedules[key] == before + 2
    assert torch.equal(got, again) and torch.equal(got, alone)
    err = float((got.float() - want.float()).abs().max())
    assert err <= 1e-2 * float(want.float().abs().max())


def _refused(cuda_device, plan):
    b, h, w, cin, cout = 2, 16, 16, 64, 256
    x, wt, scale, shift = (t.float().to(cuda_device) for t in
                           _inputs(b, h, w, cin, cout, seed=5))
    w_km = wt.bfloat16().permute(3, 0, 1, 2).contiguous()
    with pytest.raises(RuntimeError, match="CUDA error"):
        conv_fused.launch(x.bfloat16(), w_km, scale, shift, True, plan)


@pytest.mark.cuda
def test_launcher_refuses_a_partial_cluster(cuda_device):
    """A grid that is not whole clusters is refused, not launched."""
    plan = wgmma_plan(2, 16, 16, 256, (128, 256, 4, 0, 0), 132, cluster=2)
    _refused(cuda_device, dataclasses.replace(plan, grid=(plan.grid[0] - 1,
                                                          1)))


@pytest.mark.cuda
@pytest.mark.parametrize("config", [c for c in WGMMA_CONFIGS
                                    if c not in CLUSTERED], ids=str)
def test_launcher_refuses_a_cluster_without_its_instance(cuda_device,
                                                         config):
    """A configuration built without a clustered instance refuses a
    cluster; it is not launched without one."""
    bare = wgmma_plan(2, 16, 16, 256, config, 132)
    grid = max(2, bare.grid[0] - bare.grid[0] % 2)
    _refused(cuda_device, dataclasses.replace(bare, cluster=2,
                                              grid=(grid, 1)))
