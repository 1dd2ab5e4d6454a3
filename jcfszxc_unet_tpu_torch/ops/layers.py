"""The layers of the ported models, on NCHW tensors held in
``torch.channels_last``.

Counterpart of ``jcfszxc_unet_tpu/ops/layers.py``.  Parameters and
BatchNorm statistics stay float32; the convolutions compute in the
activation's dtype (bf16 by default, f32 on request), as the JAX layers
do with ``dtype=`` and ``param_dtype=float32``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from jcfszxc_unet_tpu_torch.parallel import spatial


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that casts its f32 parameters to the input's dtype.

    :meth:`s2d` applies the same parameters in space-to-depth space
    (``ops/s2d.py``), the JAX layer's ``s2d_space=True``."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        if ((self.kernel_size[0] > 1 or self.stride[0] > 1)
                and spatial.active() is not None):
            return self._conv_rows(x, self.weight.to(x.dtype), bias)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)

    def _conv_rows(self, x, weight, bias):
        """The conv on this rank's rows of a row-sharded map
        (``parallel.spatial``): output row o reads input rows o*s - p to
        o*s - p + d(k - 1), so the slab takes p rows from above and
        d(k - 1) - p - s + 1 from below, and the conv runs without
        padding in H.  Each rank's first row must be a multiple of the
        stride."""
        (k, _), (s, _), (d, _) = self.kernel_size, self.stride, self.dilation
        if isinstance(self.padding, str):
            raise ValueError("a row-sharded conv needs integer padding")
        p, pw = self.padding
        starts, counts = spatial.active().layout(x.shape[2])
        if any(v % s for v in starts + counts):
            raise ValueError(f"rows {counts} do not split at stride {s}")
        slab = spatial.halo_slab(x, p, d * (k - 1) - p - s + 1)
        return F.conv2d(slab, weight, bias, self.stride, (0, pw),
                        self.dilation, self.groups)

    def s2d_weight(self, dtype) -> torch.Tensor:
        """The s2d-space OIHW weights (4 Cout, 4 Cin, k', k') in ``dtype``,
        differentiable in :attr:`weight` (a gather: exact in any dtype).
        Only a conv with an odd square kernel, stride 1, dilation 1 or 2,
        groups 1 and SAME padding has an s2d form; any other raises
        ``ValueError``."""
        from jcfszxc_unet_tpu_torch.ops.s2d import s2d_kernel

        kh, kw = self.kernel_size
        if kh != kw or kh % 2 == 0:
            raise ValueError(
                f"s2d conv needs an odd square kernel, got {kh}x{kw}")
        dh, dw = self.dilation
        if (self.groups != 1 or self.stride != (1, 1) or dh != dw
                or dh > 2):
            raise ValueError(
                "s2d conv requires stride 1, dilation 1 or 2, groups 1")
        if self.padding not in ("same", (kh // 2 * dh, kw // 2 * dw)):
            raise ValueError("s2d conv requires SAME-equivalent padding")
        return s2d_kernel(self.weight, dh).to(dtype)

    def s2d(self, x):
        """The conv on s2d input (B, 4 Cin, H/2, W/2), or on a list of s2d
        parts whose channels sum to 4 Cin (concatenated: in the c-major
        layout that is the s2d form of the concat); returns the s2d output
        (B, 4 Cout, H/2, W/2), channels_last."""
        from jcfszxc_unet_tpu_torch.ops.s2d import conv_s2d, expand_vector

        if isinstance(x, (tuple, list)):
            x = cat_channels(*x) if len(x) > 1 else x[0]
        bias = (None if self.bias is None
                else expand_vector(self.bias).to(x.dtype))
        return conv_s2d(x, self.s2d_weight(x.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` that casts its f32 parameters to the input's
    dtype (UNet uses it with kernel 2, stride 2, no padding)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        if spatial.active() is not None:
            return self._conv_rows(x, self.weight.to(x.dtype), bias)
        return F.conv_transpose2d(
            x, self.weight.to(x.dtype), bias, self.stride, self.padding,
            self.output_padding, self.groups, self.dilation)

    def _conv_rows(self, x, weight, bias):
        """The transposed conv on this rank's rows of a row-sharded map,
        whose output has s times the rows (each rank: s times its own).
        Input row i feeds output rows i*s - p to i*s - p + d(k - 1), so
        the outputs s*start .. s*stop - 1 read input rows start -
        floor((d(k - 1) - p) / s) to stop - 1 + floor((p - 1) / s) + 1:
        TransFuseNet's k3/s2/p1/op1 one row from below, DenseUNet's k4/s2/p1
        one from each side, k2/s2 none.  The conv runs without padding in
        H on that slab and the rows of this rank's outputs are cut out."""
        (k, _), (s, _), (d, _) = self.kernel_size, self.stride, self.dilation
        (p, pw), (op, opw) = self.padding, self.output_padding
        if d * (k - 1) + op + 1 - 2 * p != s:
            raise ValueError("a row-sharded transposed conv must give "
                             "stride x the rows")
        above, below = (d * (k - 1) - p) // s, (p - 1) // s + 1
        y = F.conv_transpose2d(spatial.halo_slab(x, above, below), weight,
                               bias, self.stride, (0, pw), (0, opw),
                               self.groups, self.dilation)
        return y[:, :, p + above * s:p + above * s + s * x.shape[2]]


class Linear(nn.Linear):
    """``nn.Linear`` that casts its f32 parameters to the input's dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class GlobalStatsBatchNorm:
    """Train-mode statistics over the ranks of a data-parallel job, for
    the port's BatchNorms (the JAX layer under a mesh: GSPMD reduces its
    statistics over the global batch, ``ops/layers.py:380-413``).

    ``world`` is None outside ``parallel.global_batch_norm``, and then the
    module is torch's.  Inside it, in train mode, the per-channel Σx, Σx²
    and count go through one ``parallel.all_reduce_sum`` in f32, and the
    JAX one-pass form gives mean = S₁/n and var = max(S₂/n − mean², 0)
    (``TRAIN_BN_ONE_PASS_STATS``); the running variance takes Bessel's
    factor over the global n.  The backward goes through the all-reduce,
    so the input gradients are those of the global batch's statistics."""

    world = None

    def _global_world(self):
        w = self.world
        return w if (self.training and w is not None and w.size > 1) else None

    def _global_forward(self, x, world):
        """x: (N, C, ...) with C = num_features; returns x.dtype."""
        from jcfszxc_unet_tpu_torch.parallel.mesh import all_reduce_sum

        c = x.shape[1]
        dims = [0] + list(range(2, x.dim()))
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        local = torch.cat([xf.sum(dims), (xf * xf).sum(dims),
                           xf.new_full((1,), xf.numel() // c)])
        tot = all_reduce_sum(local, world)
        n = tot[2 * c]
        mean = tot[:c] / n
        var = (tot[c:2 * c] / n - mean * mean).clamp(min=0.0)
        if self.track_running_stats and self.running_mean is not None:
            with torch.no_grad():
                self.num_batches_tracked.add_(1)
                m = (1.0 / float(self.num_batches_tracked)
                     if self.momentum is None else self.momentum)
                bessel = n / (n - 1).clamp(min=1.0)
                self.running_mean.mul_(1 - m).add_(m * mean.detach())
                self.running_var.mul_(1 - m).add_(m * var.detach() * bessel)
        shape = (1, c) + (1,) * (x.dim() - 2)
        y = (xf - mean.view(shape)) * torch.rsqrt(var + self.eps).view(shape)
        if self.affine:
            y = y * self.weight.view(shape) + self.bias.view(shape)
        return y.to(x.dtype)


class BatchNorm1d(GlobalStatsBatchNorm, nn.BatchNorm1d):
    """torch's own (eps 1e-5, momentum 0.1), as the JAX layer of that name,
    with global statistics under ``parallel.global_batch_norm``; on (N, C)
    activations it never meets the conv kernel, so it needs no fold."""

    def forward(self, x):
        world = self._global_world()
        if world is None:
            return super().forward(x)
        return self._global_forward(x, world)


class BatchNorm2d(GlobalStatsBatchNorm, nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1) with :meth:`folded`,
    and global statistics under ``parallel.global_batch_norm``."""

    def forward(self, x):
        world = self._global_world()
        if world is None:
            return super().forward(x)
        return self._global_forward(x, world)

    def folded(self):
        """Eval-mode BN as ``y = x * scale + shift`` per channel, in f32:
        scale = gamma * rsqrt(running_var + eps), shift = beta - mean*scale."""
        scale = self.weight.float() * torch.rsqrt(
            self.running_var.float() + self.eps)
        shift = self.bias.float() - self.running_mean.float() * scale
        return scale, shift

    def s2d(self, x):
        """The BatchNorm of the original channels on an s2d tensor (B, 4C,
        h, w) (the JAX layer's ``phase_groups=4``): statistics and running
        statistics per ORIGINAL channel over the batch, the 4 phases and
        the map, with torch's unbiased running variance over that count,
        as on the unpacked map.  The (B, C, 4, h, w) view goes through
        ``F.batch_norm`` with this module's train/eval logic; a stock
        ``BatchNorm2d(4C)`` would hold other parameters and statistics."""
        b, c4, h, w = x.shape
        if c4 != 4 * self.num_features:
            raise ValueError(f"s2d BatchNorm of {self.num_features} channels "
                             f"got {c4} (expected {4 * self.num_features})")
        world = self._global_world()
        if world is not None:
            y = self._global_forward(x.view(b, self.num_features, 4, h, w),
                                     world)
            return channels_last(y.reshape(b, c4, h, w))
        momentum = 0.0 if self.momentum is None else self.momentum
        if self.training and self.track_running_stats:
            self.num_batches_tracked.add_(1)
            if self.momentum is None:  # cumulative moving average
                momentum = 1.0 / float(self.num_batches_tracked)
        use_batch = self.training or self.running_mean is None
        track = not self.training or self.track_running_stats
        y = F.batch_norm(
            x.view(b, self.num_features, 4, h, w),
            self.running_mean if track else None,
            self.running_var if track else None,
            self.weight, self.bias, use_batch, momentum, self.eps)
        return channels_last(y.reshape(b, c4, h, w))


def channels_last(x):
    """``x`` as a channels_last tensor: a copy only where it is not one
    already (the conv kernel reads NCHW channels_last as contiguous NHWC)."""
    return x.contiguous(memory_format=torch.channels_last)


def cat_channels(*ts):
    """Channel concat of NCHW tensors, returned in channels_last."""
    return channels_last(torch.cat(ts, dim=1))


def nhwc(x):
    """NCHW channels_last -> its NHWC view (a copy only for another
    layout)."""
    return channels_last(x).permute(0, 2, 3, 1)


def max_pool2d_with_indices(x):
    """2x2/stride-2 max pool that also returns where each max came from:
    (pooled NCHW, onehot (N, H/2, W/2, 4, C) in x.dtype), the window's
    positions in (row, column) order.  The one-hot marks the *first*
    maximum of a window, so ties go where the JAX version and torch's
    argmax put them.  Counterpart of ``max_pool2d_with_indices`` in
    ``jcfszxc_unet_tpu/ops/layers.py`` (reference SegNet.py:89-112)."""
    n, c, h, w = x.shape
    if h % 2 or w % 2:
        raise ValueError(
            f"max_pool2d_with_indices requires even H and W, got {h}x{w} "
            f"(SegNet needs inputs divisible by 32 for its five pooling "
            f"stages)")
    xw = nhwc(x).reshape(n, h // 2, 2, w // 2, 2, c)
    xw = xw.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4, c)
    pooled = xw.amax(dim=3)
    is_max = xw == pooled.unsqueeze(3)
    first = is_max & (torch.cumsum(is_max.to(torch.int32), dim=3) == 1)
    return pooled.permute(0, 3, 1, 2), first.to(x.dtype)


def max_unpool2d(x, onehot):
    """Inverse of :func:`max_pool2d_with_indices`: each value goes back to
    its window's marked position, zeros elsewhere (torch F.max_unpool2d,
    reference SegNet.py:115-138).  x: NCHW; returns NCHW channels_last."""
    n, c, h2, w2 = x.shape
    y = nhwc(x).unsqueeze(3) * onehot  # (N, H/2, W/2, 4, C)
    y = y.reshape(n, h2, w2, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, h2 * 2, w2 * 2, c).permute(0, 3, 1, 2)


def upsample_nearest(x, scale: int = 2):
    """torch nn.Upsample(scale_factor=s, mode='nearest'), channels_last."""
    return channels_last(F.interpolate(x, scale_factor=scale, mode="nearest"))


def upsample_bilinear(x, scale: int = 2, align_corners: bool = True):
    """torch nn.Upsample(mode='bilinear'), channels_last; align_corners=True
    as NestedUNet's ``up`` (reference UNetPP.py:43).  The JAX version's
    matmul form is a TPU choice with the same two-term blends.  On a
    row-sharded map (``parallel.spatial``), :func:`_upsample_bilinear_rows`."""
    if spatial.active() is not None:
        if not align_corners:
            raise ValueError("row-sharded bilinear upsampling takes "
                             "align_corners=True")
        return _upsample_bilinear_rows(x, scale)
    return channels_last(F.interpolate(x, scale_factor=scale, mode="bilinear",
                                       align_corners=align_corners))


def avg_pool2d(x, kernel_size: int, stride: int, padding: int):
    """torch ``F.avg_pool2d`` with count_include_pad=True (its default, as
    the JAX version), channels_last.  On a row-sharded map it pools a slab
    with ``padding`` halo rows on each side (stride 1): the halo's zero
    rows at the map's edges are the padding it counts."""
    if spatial.active() is not None:
        if stride != 1:
            raise ValueError("row-sharded avg_pool2d takes stride 1")
        slab = spatial.halo_slab(x, padding, kernel_size - 1 - padding)
        return channels_last(F.avg_pool2d(slab, kernel_size, stride,
                                          (0, padding),
                                          count_include_pad=True))
    return channels_last(F.avg_pool2d(x, kernel_size, stride, padding,
                                      count_include_pad=True))


def adaptive_avg_pool_1x1(x):
    """torch nn.AdaptiveAvgPool2d(1): (N, C, 1, 1), over the whole map."""
    return spatial.row_mean(x, (2, 3), keepdim=True)


def adaptive_max_pool_1x1(x):
    """torch nn.AdaptiveMaxPool2d(1): (N, C, 1, 1), over the whole map."""
    return spatial.row_max(x, (2, 3), keepdim=True)


def pad_or_crop_to(x, target_h: int, target_w: int):
    """Center-pad to (target_h, target_w), or center-crop where the target
    is smaller: ``F.pad`` with pads [d//2, d - d//2], negative pads crop
    (reference unet_parts.py:65-67).  On a row-sharded map the heights
    are this rank's: the rows of the whole map's pad or crop (MCUNet's
    crop behind InceptionA) come from the ranks that hold them."""
    dh, dw = target_h - x.shape[2], target_w - x.shape[3]
    sharding = spatial.active()
    if sharding is not None:
        starts, counts = sharding.layout(x.shape[2])
        t_starts, t_counts = sharding.layout(target_h)
        top = (sum(t_counts) - sum(counts)) // 2
        if sum(t_counts) != sum(counts):
            wants = [[(s - top, s - top + c)]
                     for s, c in zip(t_starts, t_counts)]
            x = spatial.fetch_rows(nhwc(x), 1, wants,
                                   sharding).permute(0, 3, 1, 2)
        dh = 0
    if dh == 0 and dw == 0:
        return x
    return F.pad(x, [dw // 2, dw - dw // 2, dh // 2, dh - dh // 2])


@torch.no_grad()
def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every conv's and Linear's parameters with torch's default
    initialisation (kaiming-uniform with a = sqrt(5), bias uniform in
    +-1/sqrt(fan_in)), from ``generator``, so that a seed fixes the model.
    BatchNorms get gamma 1, beta 0, running mean 0 and var 1.  An
    ``nn.MultiheadAttention`` then gets its own default: in_proj_weight
    xavier-uniform, in_proj_bias and out_proj.bias zero (its out_proj
    keeps the Linear draw of its weight)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5),
                                     generator=generator)
            if m.bias is not None:
                fan_in, _ = nn.init._calculate_fan_in_and_fan_out(m.weight)
                bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
        elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
            m.reset_parameters()
    for m in module.modules():
        if isinstance(m, nn.MultiheadAttention):
            nn.init.xavier_uniform_(m.in_proj_weight, generator=generator)
            nn.init.zeros_(m.in_proj_bias)
            nn.init.zeros_(m.out_proj.bias)


def trace_safe_cache(maxsize: int):
    """``functools.lru_cache`` for functions that build a constant tensor
    (an interpolation matrix, an index, a selector), bypassed while
    ``torch.export`` or ``torch.compile`` traces
    (``torch.compiler.is_compiling()``): a tensor made while tracing is a
    fake one, which must never reach a later eager call, and built anew
    there it enters the traced program as a constant of its own.  A
    cached tensor is made outside inference mode, so that one first built
    by an evaluation serves training too."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def call(*args):
            if torch.compiler.is_compiling():
                return fn(*args)
            with torch.inference_mode(False):
                return cached(*args)

        call.cache_clear = cached.cache_clear
        return call
    return wrap


def _linear_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Dense (out_size, in_size) align-corners linear-interpolation matrix,
    in f32: row k holds the weights (1 - f, f) of the two source pixels of
    output coordinate k * (in - 1) / (out - 1), computed in numpy f32 as the
    JAX version computes them (``_linear_resize_weights``)."""
    if out_size == 1:
        src = np.zeros((1,), np.float32)
    else:
        src = np.arange(out_size, dtype=np.float32) * np.float32(
            (in_size - 1) / (out_size - 1))
    lo = np.floor(src).astype(np.int32)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (src - lo.astype(np.float32)).astype(np.float32)
    a = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(a, (rows, lo), 1.0 - frac)
    np.add.at(a, (rows, hi), frac)
    return a


@trace_safe_cache(maxsize=64)
def _linear_resize_tensor(in_size: int, out_size: int, device: torch.device,
                          dtype: torch.dtype) -> torch.Tensor:
    """:func:`_linear_resize_matrix` on ``device``, built and copied once
    per size pair: a copy from pageable host memory syncs the stream."""
    return torch.from_numpy(_linear_resize_matrix(in_size, out_size)).to(
        device, dtype)


@trace_safe_cache(maxsize=64)
def _resize_rows_tensor(in_size: int, scale: int, start: int, count: int,
                        device: torch.device) -> torch.Tensor:
    """Rows scale*start .. scale*(start + count) - 1 of the align-corners
    resize matrix of ``in_size`` -> scale * in_size rows, over the source
    rows start - 1 .. start + count (zero columns past the map's edges),
    f32: each output row's two source rows lie in that range, since
    k * (in - 1) / (scale * in - 1) lies in (k / scale - 1, k / scale]."""
    a = np.pad(_linear_resize_matrix(in_size, scale * in_size),
               ((0, 0), (1, 1)))
    local = a[scale * start:scale * (start + count), start:start + count + 2]
    return torch.from_numpy(np.ascontiguousarray(local)).to(device)


def _upsample_bilinear_rows(x, scale: int):
    """Align-corners bilinear upsampling of this rank's rows: the global
    map's resize matrix (:func:`_linear_resize_matrix`, whose grid
    depends on the global H) restricted to this rank's output rows, on a
    slab with one halo row on each side; then the width's matrix.  f32
    contractions, returned in x.dtype, channels_last."""
    sharding = spatial.active()
    starts, counts = sharding.layout(x.shape[2])
    rank = sharding.world.rank
    ah = _resize_rows_tensor(sum(counts), scale, starts[rank], counts[rank],
                             x.device)
    aw = _linear_resize_tensor(x.shape[3], scale * x.shape[3], x.device,
                               torch.float32)
    slab = nhwc(spatial.halo_slab(x, 1, 1)).float()
    y = torch.einsum("hH,nHwc->nhwc", ah, slab)
    y = torch.einsum("wW,nhWc->nhwc", aw, y)
    return channels_last(y.to(x.dtype).permute(0, 3, 1, 2))


def resize_linear_align_corners(x, out_h: int, out_w: int):
    """Bilinear resize with align_corners=True of NHWC ``x`` to (out_h,
    out_w), as two contractions with constant interpolation matrices (the
    JAX version's form, whose f32 grid it reproduces).  This is the grid of
    ``scipy.ndimage.zoom(..., order=1)``, output k at input
    k * (in - 1) / (out - 1); scipy computes it in f64, so the two differ
    in the weights' last bits (outputs up to 6.4e-6 apart at 85 -> 128)."""
    n, h, w, c = x.shape
    ah = _linear_resize_tensor(h, out_h, x.device, x.dtype)
    aw = _linear_resize_tensor(w, out_w, x.device, x.dtype)
    x = torch.einsum("hH,nHwc->nhwc", ah, x)
    return torch.einsum("wW,nhWc->nhwc", aw, x)


def _nearest_align_corners_index(in_size: int, out_size: int) -> np.ndarray:
    """floor(k * (in - 1) / (out - 1) + 0.5), in f64: scipy's order-0
    zoom grid.  ``F.interpolate(mode="nearest")`` takes floor(k * in / out),
    another grid."""
    if out_size == 1:
        return np.zeros((1,), np.int64)
    src = np.arange(out_size, dtype=np.float64) * (
        (in_size - 1) / (out_size - 1))
    return np.floor(src + 0.5).astype(np.int64)


@trace_safe_cache(maxsize=64)
def _nearest_index_tensor(in_size: int, out_size: int,
                          device: torch.device) -> torch.Tensor:
    """:func:`_nearest_align_corners_index` on ``device``, copied once per
    size pair."""
    return torch.from_numpy(_nearest_align_corners_index(
        in_size, out_size)).to(device)


def resize_nearest_align_corners(x, out_h: int, out_w: int):
    """Nearest resize of NHWC ``x`` to (out_h, out_w) matching
    ``scipy.ndimage.zoom(..., order=0)``: an index gather on the
    align-corners grid, half rounding up."""
    n, h, w, c = x.shape
    x = x.index_select(1, _nearest_index_tensor(h, out_h, x.device))
    return x.index_select(2, _nearest_index_tensor(w, out_w, x.device))
