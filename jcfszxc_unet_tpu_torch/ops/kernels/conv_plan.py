"""Launch plans of the two 3x3 conv kernels (``csrc/conv3x3_affine_relu.cu``
and ``csrc/conv3x3_relu_imcol.cu``).

:func:`plan_conv` picks the body that runs a call, from its dtype, Cin and
alignment, and for the ``wgmma`` body (``csrc/conv3x3_wgmma.cuh``) the
tile, BM output pixels (a spatial box) by BN output channels, the ring
depth and the persistent grid.  The launchers take
these numbers as they are (:meth:`ConvPlan.ints`); the CPU tests emulate
the kernel's loads from the same plan.

Bodies:

* ``wgmma``: bf16 with Cin % 8 == 0 and x, w 16-byte aligned.  TMA needs
  16-byte-aligned global strides, and the W stride of x is 2*Cin bytes.
  Its schedules (:data:`SCHEDULES`): ``pingpong`` (each consumer
  warpgroup owns alternate tiles, so that one tile's epilogue runs under
  the next one's products, and stores through TMA where Cout % 8 == 0),
  ``pingpong_swap`` (the same with the channels as the products' rows and
  the pixels as their columns, 64 channels a tile, up to Cout 256 where
  Cout % 8 == 0) and ``cooperative`` (both warpgroups share each tile;
  the deep layers' 128 x 256 and 256 x 128 tiles).
* ``mma_sync``: every other bf16 call (every model's Cin-3 stem,
  MultiResUNet's odd widths, an unaligned view): one haloed input box per
  tile in shared memory with the channels padded to a multiple of 8, read
  at nine fixed offsets by ``wgmma`` (Cin > 8) or ``ldmatrix`` +
  ``mma.sync`` (Cin <= 8); :func:`box_plan` picks its box, channel tile,
  channel chunk and persistent grid.
* ``f32_box``: every float32 call, on the CUDA cores: one haloed input
  box per tile in shared memory as channel planes, fed by a cp.async ring
  over chunks of 4 channels, each thread's 16 pixels of a box row by 4
  channels (8 by 8 in boxes 8 wide, 8 by 4 in 32-channel tiles)
  register-blocked over a tap row; :func:`f32_plan` picks its tile, box
  and grid.
* ``fma``: the im2col kernel's f32 body (an element-by-element K loop on
  the CUDA cores).
* ``narrow`` (``csrc/conv3x3_narrow.cu``): the bf16 calls that the
  ``wgmma`` body would take with few channels on one side, at the widths
  where the H100's sweeps showed it the fastest route
  (:func:`takes_narrow`, ``NARROW_SHAPES``), which bytes bound:
  persistent blocks with the weights
  resident in shared memory, one haloed input box of all the taps per
  tile and chunk by TMA, pixels as ``wgmma``'s rows and Cout rounded up to
  8 as its width; :func:`narrow_plan` picks its tile, chunk and grid.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from dataclasses import dataclass

import torch

BK = 64    # channels of one tap per K step

BODIES = {"fma": 0, "f32_box": 1, "mma_sync": 2, "wgmma": 3, "narrow": 4}

# Tiles of the im2col kernel's f32 body (fma): 128 pixels taken in (b, y,
# x) order x 64 channels.
_SIMPLE_BM, _SIMPLE_BN = 128, 64

# The f32_box body (csrc/conv3x3_affine_relu.cu, namespace f32): 256
# threads, chunks of F32_CHUNK channels through an F32_STAGES-deep cp.async
# ring; the (BM, BN) tiles it is instantiated for (CONV_F32_CONFIG), each
# thread TM = f32_tm(tile, TW) consecutive pixels of a box row by BN /
# (256 / (BM / TM)) channels; the floats of one channel plane of the haloed
# box (``Cfg<BM, TM, TN>::PLANE``, 8 mod 32), TB (TH + 2) (TW + 4) at most.
F32_THREADS, F32_CHUNK, F32_STAGES = 256, 4, 4
F32_TILES = ((128, 128), (256, 64), (256, 32))
F32_PLANE = {128: 424, 256: 616}
# Device time per output of each (BM, BN, TM), relative to 128 x 128 with
# 16-pixel rows: scripts/conv_tile_sweep.py --f32 on the H100 at 16 x
# 256^2, 128 -> 128 (48.2 TFLOP/s; 128 x 128 with 8-pixel rows 46.3;
# 256 x 64 46.4-46.6, with 8-pixel rows 44.5; 256 x 32 42.4).
F32_COST = {(128, 128, 16): 1.0, (128, 128, 8): 1.04, (256, 64, 16): 1.04,
            (256, 64, 8): 1.08, (256, 32, 8): 1.14}
# Two blocks that share an SM take this many times as long as one alone
# (a grid of 144 blocks on 132 SMs against 120: 1.7x, the row-sharded
# forward's 22 x 36 slab, 512 -> 1024).
F32_SHARED_SM = 1.7

# The mma_sync body (csrc/conv3x3_affine_relu.cu, namespace bf16): tiles of
# BOX_BM pixels, a (TW, TH, TB) box whose haloed input, TB (TH + 2)
# (TW + 2) pixels, is at most BOX_MAX; the channel tiles and chunks it is
# instantiated for (CONV_BOX_CONFIG); 256 threads a block, two
# shared-memory stages.
BOX_BM, BOX_MAX, BOX_THREADS, BOX_STAGES = 128, 240, 256, 2
BOX_BNS = (16, 32, 48, 64)
BOX_CHUNKS = (8, 32)


# The narrow body (csrc/conv3x3_narrow.cu): the (Cin, Cout) it takes, the
# distinct widths of scripts/conv_body_lists.py's narrow list (the eight
# zoo models' narrow convs), where scripts/conv_tile_sweep.py --narrow
# showed it the fastest route on the H100 (PERF.md section 6); the (N,
# CK) instances those widths need, N the products' width (Cout rounded up
# to 8) and CK the channels of a TMA box; STAGES boxes in the ring (two a
# consumer warpgroup); the tiles (TW, TH) the plan takes for a tile of
# 256 pixels (4 m64 blocks of 8 x 8; 16 x 16 where 32 x 8 does not fit in
# shared memory), 128 at N >= 64; a block's static shared memory (the
# mbarriers).
NARROW_SHAPES = frozenset({
    (32, 32), (64, 32), (96, 32), (128, 32), (160, 32), (192, 32),
    (16, 32), (48, 32), (32, 64), (32, 128), (64, 8), (64, 2), (64, 1),
    (8, 17), (128, 17), (8, 8), (8, 16), (24, 16)})
NARROW_INSTANCES = ((8, 16), (8, 32), (16, 16), (16, 32), (24, 16),
                    (24, 32), (32, 16), (32, 32), (64, 32), (128, 32))
NARROW_STAGES = 4
NARROW_TILES = {256: ((32, 8), (16, 16)), 128: ((16, 8),)}
NARROW_STATIC_SMEM = 64


# The wgmma body's schedules by their code in a plan (the kernel's
# SCHED_COOPERATIVE, SCHED_PINGPONG, SCHED_SWAP).
SCHEDULES = ("cooperative", "pingpong", "pingpong_swap")

# (BM, BN, stages, strip, schedule) of the wgmma body that the launchers
# instantiate (csrc/conv3x3_wgmma.cuh, CONV_WGMMA_CONFIG), one block per SM
# each; every one is some shape's pick in :func:`_wgmma_config`.
# Cooperative (0): both consumer warpgroups share a tile, BM / 2 rows
# each, and store it from registers.  Ping-pong (1, and 2 with the
# operands swapped, BN = 64): a warpgroup owns a whole BM x BN tile, BM *
# BN <= 16384 (128 accumulator registers a thread), and has its own bf16
# staging tile for the TMA store beside the ring.
WGMMA_CONFIGS = ((256, 128, 4, 0, 0), (128, 256, 4, 0, 0),
                 (256, 64, 4, 0, 1), (128, 64, 4, 1, 1), (128, 128, 5, 0, 1),
                 (256, 64, 4, 0, 2), (128, 64, 4, 1, 2))
# Clusters of a wgmma launch: the CTAs of one along the pixel tiles, which
# share the weights' box; each loads its part of the box once and
# multicasts it by TMA into the same stage of both.  1: no cluster.
CLUSTERS = (1, 2)
# The configurations instantiated with a cluster too (the last flag of
# CONV_WGMMA_CONFIG): those that :func:`_wgmma_cluster` pairs.
CLUSTERED = ((128, 256, 4, 0, 0),)
# Shared memory a block may hold on the H100 (static and dynamic), and the
# consumer warpgroups of a wgmma block.
SMEM_LIMIT = 232448
WGMMA_CONSUMERS = 2


def wgmma_smem(config: tuple[int, int, int, int, int]) -> int:
    """Dynamic shared-memory bytes of a wgmma block (``Tile<...>::SMEM``):
    the ring (a stage: the A box, or TH strips of 130 pixels, rounded to
    1024 bytes, and the weights of its one or three taps), each consumer
    warpgroup's staging tile (ping-pong), and 1024 bytes of alignment."""
    bm, bn, stages, strip, sched = config
    a_tx = 130 * (bm // 128) * BK * 2 if strip else bm * BK * 2
    stage = _cdiv(a_tx, 1024) * 1024 + (3 if strip else 1) * bn * BK * 2
    staging = bm * bn * 2 if sched else 0
    return stages * stage + WGMMA_CONSUMERS * staging + 1024


def schedule(plan: "ConvPlan") -> str | None:
    """The wgmma body's schedule (a name of :data:`SCHEDULES`, with
    ``/cluster2`` after it for a cluster of 2 CTAs); None for the other
    bodies."""
    if plan.body != "wgmma":
        return None
    name = SCHEDULES[plan.schedule]
    return name if plan.cluster == 1 else f"{name}/cluster{plan.cluster}"


def _wgmma_config(cin: int, cout: int, w: int
                  ) -> tuple[int, int, int, int, int]:
    """(BM, BN, stages, strip, schedule) of the wgmma body, the fastest at
    UNet's shapes in scripts/conv_tile_sweep.py on the H100 (three sweeps:
    eval batch 16 at 512^2 down to 32^2, validation batch 64 at 128^2
    down to 8^2, patches of 64^2 and 96^2 at batch 32, the probe):

    * Cout % 8 == 0 (the swapped ping-pong form stores by TMA only):
      swapped strips of one 128-pixel row by 64 channels on maps at least
      128 wide up to Cout 256 (and 96 wide at Cout <= 64): 64 -> 64 at
      512^2 0.557 ms against 0.762 unswapped and cuDNN's 0.642, 512 -> 256
      at 128^2 0.881 against 0.981 for the cooperative 128 x 256 tile;
      on narrower maps swapped 256 x 64 boxes where Cin <= 128, up to
      Cout 256 too (64 -> 128 at 64^2, batch 64: 0.086 against 0.107);
    * otherwise, and for Cout % 8 != 0: Cout <= 64 ping-pong 256 x 64
      tiles, or strips where Cin > 64 on maps at least 128 wide; Cout <=
      128 ping-pong 128 x 128 tiles, or 256 x 64 ones where Cin <= 64;
      wider outputs ping-pong 128 x 128 where Cin <= 128, the cooperative
      256 x 128 tile for Cout >= 1024 from Cin <= 512 (32^2 512 -> 1024:
      0.258-0.261 against 0.268-0.269) and from Cin >= 512 on maps at
      most 8 wide (8^2 1024 -> 1024 at batch 64, in turns: 0.108-0.111
      against 0.110-0.113 for 128 x 256), else the cooperative 128 x 256
      tile with four stages (64^2 1024 -> 512: 0.898-0.910 against
      0.974-1.003 with three; at batch 64, in turns against 256 x 128:
      16^2 1024 -> 512 0.217-0.220 against 0.230-0.235, 512 -> 512
      0.122-0.126 against 0.128-0.136);
    * swapped 256 x 64 boxes also for Cin 129-256 into Cout 256-512 on maps
      narrower than 128 (64^2 256 -> 512: 0.267-0.279 against 0.301-0.304
      cooperative; 32^2 256 -> 256 at batch 64: 0.133-0.135 against
      0.143-0.147).

    Strips of 128 pixels lie partly past the edge of narrower maps.  Two
    two-stage ping-pong forms (256-pixel strips, 128 x 128 strips), which
    fit the staging tiles beside only two stages, lost at every shape and
    were dropped; so did three-stage cooperative tiles with a TMA-store
    epilogue from a staging tile (64^2 1024 -> 512: 0.974-1.003 ms), which
    leaves room for three stages only (the fourth: 0.898-0.910)."""
    if cout % 8 == 0 and cout <= 256:
        if w >= 128 or (w >= 96 and cout <= 64):
            return 128, 64, 4, 1, 2
        if cin <= 128:
            return 256, 64, 4, 0, 2
    if cout % 8 == 0 and 128 < cin <= 256 and 256 <= cout <= 512:
        return 256, 64, 4, 0, 2
    if cout <= 64:
        return (128, 64, 4, 1, 1) if w >= 128 and cin > 64 else \
            (256, 64, 4, 0, 1)
    if cout <= 128:
        return (256, 64, 4, 0, 1) if cin <= 64 else (128, 128, 5, 0, 1)
    if cin <= 128:
        return 128, 128, 5, 0, 1
    if (cout >= 1024 and cin <= 512) or (cin >= 512 and w <= 8):
        return 256, 128, 4, 0, 0
    return 128, 256, 4, 0, 0


def _wgmma_cluster(config: tuple[int, int, int, int, int], cout: int,
                   w: int) -> int:
    """The cluster of a wgmma call (CTAs along the pixel tiles), from
    scripts/conv_tile_sweep.py over every configuration in clusters of 1
    and 2 CTAs along the pixel tiles, 2 along the Cout blocks (sharing the
    A box) and 2 x 2 on the H100: pairs along the pixel tiles, which share
    the weights' box, for the cooperative 128 x 256 tile into Cout >= 512
    on maps at least 32 wide (64^2 512 -> 512: 0.472-0.503 ms against
    0.514-0.542 alone in three calls; 1024 -> 512: 0.844-0.861 against
    0.910-0.928 in two; 32^2 1024 -> 1024: 0.439, 0.482, 0.467 against
    0.489, 0.477, 0.484).  Nowhere else did a cluster win beyond the
    spread of the sweeps (the 128^2 Cout-256 strips: 0.482-0.565 against
    0.480-0.490; 32^2 512 -> 256 at batch 64: 0.256 against 0.245), and
    no shape won along Cout or on 2 x 2, so those went."""
    return 2 if config in CLUSTERED and cout >= 512 and w >= 32 else 1


@dataclass(frozen=True)
class ConvPlan:
    body: str
    bm: int                        # output pixels per tile: TW * TH * TB
    box: tuple[int, int, int]      # (TW, TH, TB) of a wgmma tile
    bn: int                        # output channels per tile
    stages: int                    # ring depth
    strip: int                     # 1: wgmma stages of haloed row strips
    grid: tuple[int, int]
    tiles: tuple[int, int, int, int]  # box tiles along (W, H, B, Cout)
    chunk: int = 0                 # box bodies: channels a K step
    smem: int = 0                  # box bodies: shared-memory bytes a block
    schedule: int = 0              # wgmma: the code of its SCHEDULES
    tma_store: int = 0             # wgmma: 1: the epilogue stores by TMA
    cluster: int = 1               # wgmma: CTAs a cluster (CLUSTERS)

    @property
    def n_tiles(self) -> int:
        tw, th, tb, tn = self.tiles
        return tw * th * tb * tn

    def ints(self):
        """The plan as the launchers read it (``wgmma_conv::Plan``)."""
        vals = (BODIES[self.body], self.bm, *self.box, self.bn, self.stages,
                self.strip, self.schedule, self.tma_store, self.cluster,
                *self.grid, *self.tiles, self.chunk, self.smem)
        return (ctypes.c_int * len(vals))(*vals)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def choose_box(b: int, h: int, w: int, bm: int = 128
               ) -> tuple[int, int, int]:
    """(TW, TH, TB), powers of two with TW * TH * TB = bm, that cover the
    batch of h x w maps in the fewest tiles (least padded work); ties go to
    the widest, then tallest box."""
    best = None
    bits = bm.bit_length() - 1
    for lw in range(bits + 1):
        for lh in range(bits + 1 - lw):
            tw, th = 1 << lw, 1 << lh
            tb = bm // (tw * th)
            n = _cdiv(w, tw) * _cdiv(h, th) * _cdiv(b, tb)
            key = (n, -tw, -th)
            if best is None or key < best[0]:
                best = (key, (tw, th, tb))
    return best[1]


@functools.lru_cache(maxsize=512)
def plan_conv(b: int, h: int, w: int, cin: int, cout: int,
              dtype: torch.dtype, aligned: bool, sm_count: int = 132,
              imcol: bool = False) -> ConvPlan:
    """The plan of one call on output maps (b, h, w, cout) from cin input
    channels.  ``aligned``: x and the weights start on 16-byte boundaries.
    ``imcol``: the im2col kernel (x is its padded copy; its bodies are
    ``wgmma`` and ``fma``)."""
    if (dtype == torch.bfloat16 and cin % 8 == 0 and aligned and not imcol
            and takes_narrow(cin, cout)):
        return narrow_plan(b, h, w, cin, cout, sm_count)
    if dtype == torch.bfloat16 and cin % 8 == 0 and aligned:
        return wgmma_route(b, h, w, cin, cout, sm_count)
    if imcol and dtype == torch.bfloat16:
        raise ValueError("the im2col kernel's bf16 operands must have "
                         "C % 8 == 0 and be 16-byte aligned")
    if dtype == torch.bfloat16:
        return box_plan(b, h, w, cin, cout, sm_count)
    if not imcol:
        return f32_plan(b, h, w, cout, sm_count)
    grid = (_cdiv(b * h * w, _SIMPLE_BM), _cdiv(cout, _SIMPLE_BN))
    return ConvPlan("fma", _SIMPLE_BM, (0, 0, 0), _SIMPLE_BN, 0, 0, grid,
                    (0, 0, 0, 0))


def wgmma_route(b: int, h: int, w: int, cin: int, cout: int,
                sm_count: int = 132) -> ConvPlan:
    """The ``wgmma`` body's own plan of a bf16 call with Cin % 8 == 0
    (:func:`_wgmma_config`'s configuration and :func:`_wgmma_cluster`'s
    cluster): what :func:`plan_conv` gives such a call that the narrow
    body does not take."""
    config = _wgmma_config(cin, cout, w)
    return wgmma_plan(b, h, w, cout, config, sm_count,
                      cluster=_wgmma_cluster(config, cout, w))


def wgmma_groups(plan: ConvPlan) -> int:
    """Tile groups of a wgmma plan: one pixel tile a CTA of the cluster
    (one tile without a cluster) of one Cout block, the last ones holding
    a tile past the batch where the pixel-tile count is odd."""
    tw, th, tb, tn = plan.tiles
    return _cdiv(tw * th * tb, plan.cluster) * tn


def wgmma_plan(b: int, h: int, w: int, cout: int,
               config: tuple[int, int, int, int, int], sm_count: int,
               box: tuple[int, int, int] | None = None,
               cluster: int = 1) -> ConvPlan:
    """The wgmma body's plan with a given (BM, BN, stages, strip,
    schedule), cluster and, by default, :func:`choose_box`'s box (rows of
    128 pixels for strips): persistent blocks, one per SM at most, whole
    clusters walking the tile groups (the launcher takes no more clusters
    than the card holds at once).  A ping-pong plan stores its output
    through TMA where Cout % 8 == 0 (TMA's 16-byte global strides; ``out``
    is a fresh tensor, so 16-byte aligned, which the launcher checks),
    else channel pairs from registers, as the cooperative tiles do; the
    launcher refuses a plan whose route is not that one, and a
    ``pingpong_swap`` plan that cannot store by TMA."""
    if config not in WGMMA_CONFIGS:
        raise ValueError(f"no wgmma configuration {config}")
    if cluster not in CLUSTERS or (cluster > 1
                                   and config not in CLUSTERED):
        raise ValueError(f"no wgmma cluster {cluster} for {config}")
    bm, bn, stages, strip, sched = config
    if strip:
        box = (128, bm // 128, 1)
    tw, th, tb = box or choose_box(b, h, w, bm)
    if tw * th * tb != bm:
        raise ValueError(f"box {(tw, th, tb)} does not hold {bm} pixels")
    tiles = (_cdiv(w, tw), _cdiv(h, th), _cdiv(b, tb), _cdiv(cout, bn))
    plan = ConvPlan("wgmma", bm, (tw, th, tb), bn, stages, strip, (0, 1),
                    tiles, schedule=sched,
                    tma_store=int(sched > 0 and cout % 8 == 0),
                    cluster=cluster)
    grid = min(wgmma_groups(plan), sm_count // cluster) * cluster
    return dataclasses.replace(plan, grid=(grid, 1))


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def box_chunk(cin: int) -> int:
    """Channels a K step of the mma_sync body: the whole input where it
    has at most 8 (one ``mma.sync`` m16n8k8 a tap), else chunks of 32
    (two ``wgmma`` k16 steps a tap)."""
    return 8 if cin <= 8 else 32


def box_plane(bn: int, chunk: int) -> int:
    """Box pixels of one 8-channel plane in shared memory
    (``Cfg<BN, CK>::PLANE``): BOX_MAX, or for wgmma enough for the
    epilogue's bf16 tile in the planes, made 2 mod 8 in 16-byte words."""
    cst, n8 = BOX_BM * (bn + 8), chunk // 8
    least = -(-cst // (8 * n8)) if chunk == 32 and cst > BOX_MAX * 8 * n8 \
        else BOX_MAX
    return least + (10 - least % 8) % 8


def box_smem(bn: int, chunk: int) -> int:
    """Shared-memory bytes of one block (``Cfg<BN, CK>::SMEM``): two
    stages of the haloed box's 8-channel planes and the (9, chunk / 8, BN)
    weight rows, and for mma.sync the epilogue's bf16 tile (wgmma's lives
    in a finished stage)."""
    stage = (chunk // 8) * box_plane(bn, chunk) * 8 + 9 * chunk * bn
    cst = BOX_BM * (bn + 8)
    return (2 * stage + (0 if chunk == 32 else cst)) * 2


def box_workspace_bytes(plan: ConvPlan, cin: int) -> int:
    """Bytes of the weights that the two box bodies lay out once per
    call: mma_sync's (tiles_n, chunks, 9, chunk / 8, BN, 8) bf16, f32_box's
    (tiles_n, chunks, 9, chunk, BN) f32; 0 for the other bodies."""
    size = {"mma_sync": 2, "f32_box": 4}.get(plan.body)
    if size is None:
        return 0
    return (size * plan.tiles[3] * _cdiv(cin, plan.chunk) * 9 * plan.bn
            * plan.chunk)


def box_blocks_per_sm(chunk: int) -> int:
    """Blocks an SM holds (``Cfg<BN, CK>::MIN_BLOCKS``): two with wgmma
    (two stages of up to 111 KB), three with mma.sync."""
    return 2 if chunk == 32 else 3


def box_bn(cout: int) -> int:
    """The channel tile with the fewest padded channels, each tile counted
    16 channels more for the box it loads again; ties to the wider."""
    return min(BOX_BNS, key=lambda bn: (_cdiv(cout, bn) * (bn + 16), -bn))


def choose_halo_box(b: int, h: int, w: int, chunk: int = 8
                    ) -> tuple[int, int, int]:
    """(TW, TH, TB), powers of two with TW * TH * TB = BOX_BM and a haloed
    box of at most BOX_MAX pixels, that cover the batch of h x w maps at
    the least cost: per tile its BOX_BM rows of products and half its box
    pixels of loads; ties go to the widest, then tallest box.  wgmma
    (chunk 32) reads a box row of 8 pixels as one core matrix and a
    warpgroup's 64 rows as 8 rows of one image: TW = 8 and TH >= 8."""
    best = None
    bits = BOX_BM.bit_length() - 1
    for lw in range(bits + 1):
        for lh in range(bits + 1 - lw):
            tw, th = 1 << lw, 1 << lh
            tb = BOX_BM // (tw * th)
            px = tb * (th + 2) * (tw + 2)
            if px > BOX_MAX or (chunk == 32 and (tw != 8 or th < 8)):
                continue
            n = _cdiv(w, tw) * _cdiv(h, th) * _cdiv(b, tb)
            key = (n * (2 * BOX_BM + px), -tw, -th)
            if best is None or key < best[0]:
                best = (key, (tw, th, tb))
    return best[1]


def box_plan(b: int, h: int, w: int, cin: int, cout: int,
             sm_count: int, box: tuple[int, int, int] | None = None
             ) -> ConvPlan:
    """The mma_sync body's plan: :func:`box_chunk`'s chunk,
    :func:`choose_halo_box`'s box (or ``box``), :func:`box_bn`'s channel
    tile, and a persistent grid of at most as many blocks as the SMs hold,
    a multiple of the channel tiles so that each block keeps its channels
    (and, with one chunk, its weights in shared memory)."""
    chunk = box_chunk(cin)
    tw, th, tb = box or choose_halo_box(b, h, w, chunk)
    if (tw * th * tb != BOX_BM or tb * (th + 2) * (tw + 2) > BOX_MAX
            or (chunk == 32 and (tw != 8 or th < 8))):
        raise ValueError(f"box {(tw, th, tb)} is not one the mma_sync body "
                         f"takes at Cin {cin}")
    bn = box_bn(cout)
    tiles = (_cdiv(w, tw), _cdiv(h, th), _cdiv(b, tb), _cdiv(cout, bn))
    n = tiles[0] * tiles[1] * tiles[2] * tiles[3]
    cap = box_blocks_per_sm(chunk) * sm_count
    cap = max(tiles[3], cap - cap % tiles[3])
    return ConvPlan("mma_sync", BOX_BM, (tw, th, tb), bn, BOX_STAGES, 0,
                    (min(n, cap), 1), tiles, chunk, box_smem(bn, chunk))


def f32_smem(bm: int, bn: int) -> int:
    """Shared-memory bytes of one f32_box block (``Cfg<BM, TM, TN>::SMEM``):
    F32_STAGES stages of F32_CHUNK channel planes of the haloed box and the
    (9, F32_CHUNK, BN) weights, then the box pixels' table (two ints a
    pixel)."""
    return (4 * F32_STAGES * F32_CHUNK * (F32_PLANE[bm] + 9 * bn)
            + 8 * F32_PLANE[bm])


def f32_plane(box: tuple[int, int, int]) -> int:
    """Floats of one channel plane of a (TW, TH, TB) box: TB (TH + 2)
    rows of TW + 4 floats (the haloed row, 16-byte aligned)."""
    tw, th, tb = box
    return tb * (th + 2) * (tw + 4)


def f32_tm(tile: tuple[int, int], tw: int) -> int:
    """Pixels of a thread's box row (TM) for ``tile`` and a box TW wide:
    16 where the box is at least 16 wide (fewer shared-memory reads a
    product), else 8; 8 for the 256 x 32 tile."""
    return 16 if tile != (256, 32) and tw >= 16 else 8


def f32_boxes(bm: int):
    """Every (TW, TH, TB) of powers of two with TW >= 8 and TW * TH * TB
    = bm whose channel plane fits F32_PLANE[bm]."""
    bits = bm.bit_length() - 1
    for lw in range(3, bits + 1):
        for lh in range(bits + 1 - lw):
            box = (1 << lw, 1 << lh, bm >> (lw + lh))
            if f32_plane(box) <= F32_PLANE[bm]:
                yield box


def f32_plan(b: int, h: int, w: int, cout: int, sm_count: int = 132,
             tile: tuple[int, int] | None = None,
             box: tuple[int, int, int] | None = None) -> ConvPlan:
    """The f32_box body's plan, one block a tile, the channel tile
    fastest: of the tiles (or ``tile``) and boxes (or ``box``), the one
    whose grid takes the least time by F32_COST, counting a grid that
    fits the SMs once as one block's time and each further round of
    blocks on an SM as F32_SHARED_SM / 2 of it; ties go to the least
    padded work, the smaller plane, then the narrower, taller box."""
    best = None
    for bm, bn in [tile] if tile else F32_TILES:
        if (bm, bn) not in F32_TILES:
            raise ValueError(f"no f32_box tile {(bm, bn)}")
        for tw, th, tb in [box] if box else f32_boxes(bm):
            if (tw * th * tb != bm or tw < 8 or tw & (tw - 1)
                    or th & (th - 1)
                    or f32_plane((tw, th, tb)) > F32_PLANE[bm]):
                raise ValueError(f"box {(tw, th, tb)} is not one the "
                                 f"f32_box body takes with {bm}-pixel "
                                 f"tiles")
            tiles = (_cdiv(w, tw), _cdiv(h, th), _cdiv(b, tb),
                     _cdiv(cout, bn))
            n = tiles[0] * tiles[1] * tiles[2] * tiles[3]
            block = bm * bn * F32_COST[bm, bn, f32_tm((bm, bn), tw)]
            rounds = _cdiv(n, sm_count)
            time = (1.0 if rounds == 1 else F32_SHARED_SM / 2 * rounds) \
                * block
            key = (time, n * block, f32_plane((tw, th, tb)), tw, -th)
            if best is None or key < best[0]:
                best = (key, (bm, bn), (tw, th, tb), tiles, n)
    _, (bm, bn), box, tiles, n = best
    return ConvPlan("f32_box", bm, box, bn, F32_STAGES, 0, (n, 1), tiles,
                    F32_CHUNK, f32_smem(bm, bn))


def narrow_chunk(cin: int) -> int:
    """Channels of one TMA box of the narrow body: 16 (rows of 32 bytes,
    Cin 8 zero-filled to 16) up to Cin 16, else 32 (several chunks past
    Cin 32)."""
    return 16 if cin <= 16 else 32


def narrow_pixels(n: int) -> int:
    """Pixels of a narrow tile at products' width ``n``: 4 m64 blocks
    (256), 2 from n = 64 on, so that a warpgroup's accumulators take 64
    registers a thread at n = 64 (128 at n = 128).  256-pixel tiles at n
    = 64 spilled (168 registers) and ran 32 -> 64 at 512^2 8 % slower on
    the H100 (``scripts/conv_tile_sweep.py --narrow``); two channel blocks
    of 64 at n = 128, each a 128-pixel tile of its own, ran 2 % slower
    than one block of 128 channels."""
    return 128 if n >= 64 else 256


def narrow_smem(cin: int, cout: int, box: tuple[int, int],
                chunk: int) -> int:
    """Dynamic shared-memory bytes of a narrow block (the launcher's
    ``smem``): 1024 of alignment, NARROW_STAGES stages of the haloed box
    (TW + 2) (TH + 2) x chunk, each rounded up to 1024 bytes, two staging
    tiles where Cout % 8 == 0 (TMA stores), the weights as 9 taps x
    ceil(Cin / chunk) * chunk / 16 k16 steps x N x 32 bytes, and scale and
    shift (N floats each)."""
    tw, th = box
    n = _cdiv(cout, 8) * 8
    stage = _cdiv((tw + 2) * (th + 2) * chunk * 2, 1024) * 1024
    staging = tw * th * cout * 2 if cout % 8 == 0 else 0
    ksteps = _cdiv(cin, chunk) * chunk // 16
    return (1024 + NARROW_STAGES * stage + 2 * staging + 9 * ksteps * n * 32
            + 8 * n)


def narrow_fits(cin: int, cout: int, box: tuple[int, int]) -> bool:
    return (narrow_smem(cin, cout, box, narrow_chunk(cin))
            + NARROW_STATIC_SMEM <= SMEM_LIMIT)


def narrow_tile(cin: int, cout: int) -> tuple[int, int]:
    """The narrow body's tile for Cin -> Cout: the first of NARROW_TILES
    whose block fits in shared memory (the first where none does)."""
    tiles = NARROW_TILES[narrow_pixels(_cdiv(cout, 8) * 8)]
    return next((box for box in tiles if narrow_fits(cin, cout, box)),
                tiles[0])


def takes_narrow(cin: int, cout: int) -> bool:
    """Whether a bf16 call with Cin % 8 == 0 and aligned operands takes the
    narrow body: its (Cin, Cout) is one of NARROW_SHAPES."""
    return (cin, cout) in NARROW_SHAPES


def narrow_plan(b: int, h: int, w: int, cin: int, cout: int,
                sm_count: int, box: tuple[int, int] | None = None
                ) -> ConvPlan:
    """The narrow body's plan: tiles of :func:`narrow_pixels` pixels, TW x
    TH of one image (:func:`narrow_tile`'s; ``box`` forces another of TW
    and TH multiples of 8, as ``scripts/conv_tile_sweep.py --narrow``
    does), walked along W, H, then the batch; :func:`narrow_chunk`'s
    chunk; a persistent grid of one block an SM at most; a TMA-store
    epilogue where Cout % 8 == 0."""
    n = _cdiv(cout, 8) * 8
    tw, th = box or narrow_tile(cin, cout)
    chunk = narrow_chunk(cin)
    if ((n, chunk) not in NARROW_INSTANCES or cin % 8 or tw % 8 or th % 8
            or tw * th != narrow_pixels(n)
            or not narrow_fits(cin, cout, (tw, th))):
        raise ValueError(f"no narrow plan for {cin} -> {cout} with tile "
                         f"{(tw, th)}")
    tiles = (_cdiv(w, tw), _cdiv(h, th), b, 1)
    n_tiles = tiles[0] * tiles[1] * tiles[2]
    return ConvPlan("narrow", tw * th, (tw, th, 1), n, NARROW_STAGES, 0,
                    (min(n_tiles, sm_count), 1), tiles, chunk,
                    narrow_smem(cin, cout, (tw, th), chunk),
                    tma_store=int(cout % 8 == 0))

