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
* ``mma_sync``: every other bf16 call (UNet's first conv, Cin = 3):
  register-staged gather, ``mma.sync``.
* ``fma_vec`` / ``fma``: float32 on the CUDA cores, with or without
  16-byte loads.  The im2col kernel's f32 body is ``fma``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

BK = 64    # channels of one tap per K step

BODIES = {"fma": 0, "fma_vec": 1, "mma_sync": 2, "wgmma": 3}

# Tiles of the register-staged bodies (fma, fma_vec, mma_sync): 128 pixels
# taken in (b, y, x) order x 64 channels.
_SIMPLE_BM, _SIMPLE_BN = 128, 64


# (BM, BN, stages, strip) of the wgmma body that the launchers instantiate
# (csrc/conv3x3_wgmma.cuh, CONV_WGMMA_CONFIG), one block per SM each.
WGMMA_CONFIGS = ((256, 64, 4, 0), (256, 64, 3, 1), (256, 128, 4, 0),
                 (128, 256, 3, 0))


def _wgmma_config(cout: int, w: int) -> tuple[int, int, int, int]:
    """(BM, BN, stages, strip) of the wgmma body, the
    fastest at UNet's shapes in scripts/conv_tile_sweep.py on the H100:
    the tile as wide as Cout allows up to 256 (the fewest operand bytes
    per flop), 256 pixels tall where Cout <= 128, and, where Cout is 64,
    strips on maps at least 128 wide.  A strip is 128 pixels wide, so on
    narrower maps part of it lies past the edge: at batch 32 the per-tap
    boxes beat strips by 1.16-1.21x at 64^2 and matched or beat them at
    96^2 (within 12 %), while strips won by 1.16-1.34x at 128^2 and 512^2
    (the sweep's ``patch``, ``val``, ``probe`` and ``eval`` rows)."""
    if cout <= 64:
        return (256, 64, 3, 1) if w >= 128 else (256, 64, 4, 0)
    if cout <= 128:
        return 256, 128, 4, 0
    return 128, 256, 3, 0


@dataclass(frozen=True)
class ConvPlan:
    body: str
    bm: int                        # output pixels per tile: TW * TH * TB
    box: tuple[int, int, int]      # (TW, TH, TB) of a wgmma tile
    bn: int                        # output channels per tile
    stages: int                    # wgmma ring depth
    strip: int                     # 1: wgmma stages of haloed row strips
    grid: tuple[int, int]
    tiles: tuple[int, int, int, int]  # wgmma tiles along (W, H, B, Cout)

    @property
    def n_tiles(self) -> int:
        tw, th, tb, tn = self.tiles
        return tw * th * tb * tn

    def ints(self):
        """The plan as the launchers read it (``wgmma_conv::Plan``)."""
        vals = (BODIES[self.body], self.bm, *self.box, self.bn, self.stages,
                self.strip, *self.grid, *self.tiles)
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
    if dtype == torch.bfloat16 and cin % 8 == 0 and aligned:
        return wgmma_plan(b, h, w, cout, _wgmma_config(cout, w), sm_count)
    if imcol and dtype == torch.bfloat16:
        raise ValueError("the im2col kernel's bf16 operands must have "
                         "C % 8 == 0 and be 16-byte aligned")
    if dtype == torch.bfloat16:
        body = "mma_sync"
    elif cin % 8 == 0 and aligned and not imcol:
        body = "fma_vec"
    else:
        body = "fma"
    grid = (_cdiv(b * h * w, _SIMPLE_BM), _cdiv(cout, _SIMPLE_BN))
    return ConvPlan(body, _SIMPLE_BM, (0, 0, 0), _SIMPLE_BN, 0, 0, grid,
                    (0, 0, 0, 0))


def wgmma_plan(b: int, h: int, w: int, cout: int,
               config: tuple[int, int, int, int], sm_count: int,
               box: tuple[int, int, int] | None = None) -> ConvPlan:
    """The wgmma body's plan with a given (BM, BN, stages, strip) and, by
    default, :func:`choose_box`'s box (rows of 128 pixels for strips):
    persistent blocks, one per SM at most, walking the tiles."""
    if config not in WGMMA_CONFIGS:
        raise ValueError(f"no wgmma configuration {config}")
    bm, bn, stages, strip = config
    if strip:
        box = (128, bm // 128, 1)
    tw, th, tb = box or choose_box(b, h, w, bm)
    if tw * th * tb != bm:
        raise ValueError(f"box {(tw, th, tb)} does not hold {bm} pixels")
    tiles = (_cdiv(w, tw), _cdiv(h, th), _cdiv(b, tb), _cdiv(cout, bn))
    n = tiles[0] * tiles[1] * tiles[2] * tiles[3]
    return ConvPlan("wgmma", bm, (tw, th, tb), bn, stages, strip,
                    (min(n, sm_count), 1), tiles)


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
