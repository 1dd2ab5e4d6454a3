"""Space-to-depth execution of narrow-channel blocks, counterpart of
``jcfszxc_unet_tpu/ops/s2d.py``, on NCHW tensors held in
``torch.channels_last``.

An (B, C, H, W) map is carried as its (B, 4C, H/2, W/2) space-to-depth
form, in which the same function runs with four times the channels:

* a stride-1 odd-size conv (dilation 1 or 2) has an exact s2d equivalent,
  a conv whose weights :func:`s2d_kernel` builds from the original ones
  (1x1 -> 1x1, 3x3 and 5x5 and the dilated 3x3 -> 3x3, SAME), with four
  times the operations of the plain conv for a 3x3 (the selector's
  structural zeros);
* BatchNorm statistics stay per ORIGINAL channel, over the batch, the
  four phases and the map (``layers.BatchNorm2d.s2d``); per-channel
  vectors repeat four times (:func:`expand_vector`);
* with the c-major phase layout used here, s2d channel = c * 4 + p with
  p = a * 2 + b for the (row, column) phase (a, b) of a 2x2 block, a
  channel concat of s2d tensors IS the s2d form of the concat;
* a 2x2/stride-2 max pool is a max over the four phases that leaves s2d
  space (:func:`maxpool_exit`);
* a 2x bilinear upsample returns its output in s2d form, from an
  original-space or from an s2d input (:func:`upsample_bilinear_s2d`).

In eval mode the s2d 3x3 convs of the blocks go to the fused conv kernel
like any other SAME 3x3 (``ops/blocks.conv_bn_relu_fused_s2d``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from jcfszxc_unet_tpu_torch.ops.layers import (
    channels_last,
    nhwc,
    trace_safe_cache,
    upsample_bilinear,
)
from jcfszxc_unet_tpu_torch.parallel import spatial


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 4C, H/2, W/2), c-major phase layout,
    channels_last.  H and W must be even."""
    b, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"space_to_depth needs even H, W; got {h}x{w}")
    y = nhwc(x).reshape(b, h // 2, 2, w // 2, 2, c)
    y = y.permute(0, 1, 3, 5, 2, 4)                # (B, h, w, C, a, b)
    return y.reshape(b, h // 2, w // 2, 4 * c).permute(0, 3, 1, 2)


def depth_to_space(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`, channels_last."""
    b, c4, h, w = x.shape
    if c4 % 4:
        raise ValueError(f"channel dim {c4} is not a multiple of 4")
    c = c4 // 4
    y = nhwc(x).reshape(b, h, w, c, 2, 2)
    y = y.permute(0, 1, 4, 2, 5, 3)                # (B, h, a, w, b, C)
    return y.reshape(b, 2 * h, 2 * w, c).permute(0, 3, 1, 2)


@functools.lru_cache(maxsize=None)
def _selector(k: int, dilation: int = 1) -> np.ndarray:
    """0/1 array S[K, L, q, p, u, v] wiring original tap (u, v) into s2d tap
    (K, L) for output phase q and input phase p.

    y[2i+a, 2j+b] = sum_{u,v} w[u, v] x[2i+a+u', 2j+b+v'] with u' =
    (u - r) * dilation; the source row 2i+a+u' lies at s2d row i +
    floor((a+u')/2), phase (a+u') mod 2.  Dilation 2 keeps the offsets
    even, so it becomes a dilation-1 s2d conv."""
    if k % 2 == 0:
        raise ValueError(f"s2d_kernel supports odd kernel sizes, got {k}")
    r = k // 2
    big_r = (r * dilation + 1) // 2
    kk = 2 * big_r + 1
    sel = np.zeros((kk, kk, 4, 4, k, k), np.float32)
    for a in (0, 1):
        for b in (0, 1):
            q = a * 2 + b
            for u in range(k):
                au = a + (u - r) * dilation
                di, c = au >> 1, au & 1
                for v in range(k):
                    bv = b + (v - r) * dilation
                    dj, d = bv >> 1, bv & 1
                    sel[di + big_r, dj + big_r, q, c * 2 + d, u, v] = 1.0
    return sel


@trace_safe_cache(maxsize=64)
def _selector_tensor(k: int, dilation: int, device: torch.device,
                     dtype: torch.dtype) -> torch.Tensor:
    """:func:`_selector` on ``device``, copied there once: a copy from
    pageable host memory syncs the stream."""
    return torch.from_numpy(_selector(k, dilation)).to(device, dtype)


def s2d_kernel(w: torch.Tensor, dilation: int = 1) -> torch.Tensor:
    """OIHW weights (Co, Ci, k, k), odd k, stride 1 -> the exact s2d
    equivalent (4Co, 4Ci, k', k') of a SAME dilation-1 s2d conv: 3x3
    (dilation 1 or 2) and 5x5 give 3x3, 1x1 gives 1x1.  Differentiable in
    ``w``."""
    k = w.shape[2]
    if w.shape[3] != k:
        raise ValueError(f"square kernels only, got {tuple(w.shape[2:])}")
    sel = _selector_tensor(k, dilation, w.device, w.dtype)
    ws = torch.einsum("KLqpuv,oiuv->oqipKL", sel, w)
    kk = sel.shape[0]
    return ws.reshape(4 * w.shape[0], 4 * w.shape[1], kk, kk)


def expand_vector(v: torch.Tensor) -> torch.Tensor:
    """Per-channel vector (C,) -> s2d per-channel vector (4C,), c-major."""
    return v.repeat_interleave(4)


def conv_s2d(x: torch.Tensor, w_s2d: torch.Tensor, bias=None) -> torch.Tensor:
    """SAME stride-1 conv in s2d space (weights from :func:`s2d_kernel`),
    channels_last; on a row-sharded map, on a slab with k // 2 halo rows
    on each side."""
    r = w_s2d.shape[2] // 2
    if r and spatial.active() is not None:
        return channels_last(F.conv2d(spatial.halo_slab(x, r, r), w_s2d,
                                      bias, padding=(0, r)))
    return channels_last(F.conv2d(x, w_s2d, bias, padding=r))


def upsample_bilinear_s2d(x: torch.Tensor, align_corners: bool = True,
                          from_s2d: bool = False) -> torch.Tensor:
    """2x bilinear upsample returned in s2d form, channels_last.

    ``from_s2d=False``: x is an original-space (B, C, h, w) map; returns the
    s2d form (B, 4C, h, w) of its (2h, 2w) upsample.  ``from_s2d=True``: x
    is itself the s2d form (B, 4C, h, w) of a (2h, 2w) map; returns the s2d
    form (B, 4C, 2h, 2w) of its (4h, 4w) upsample.  The plain upsample
    between an unpack and a pack: the JAX version's interpolation-matrix
    form is a TPU choice, which in eager torch costs permute copies of
    every operand."""
    full = depth_to_space(x) if from_s2d else x
    return space_to_depth(upsample_bilinear(full, 2, align_corners))


def maxpool_exit(x_s2d: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool == max over the 4 phases: the pooled map in
    ORIGINAL layout (B, C, h, w), channels_last; leaves s2d space."""
    b, c4, h, w = x_s2d.shape
    return nhwc(x_s2d).view(b, h, w, c4 // 4, 4).amax(dim=4).permute(
        0, 3, 1, 2)


def avgpool_exit(x_s2d: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 average pool == mean over the 4 phases, as
    :func:`maxpool_exit`; leaves s2d space."""
    b, c4, h, w = x_s2d.shape
    return nhwc(x_s2d).view(b, h, w, c4 // 4, 4).mean(dim=4).permute(
        0, 3, 1, 2)
