"""UNet's blocks (reference unet_parts.py:17-79), counterpart of
``DoubleConv``/``Down``/``Up``/``OutConv`` in ``jcfszxc_unet_tpu/ops/blocks.py``.

Attribute names follow the reference (``double_conv.0``,
``maxpool_conv.1``, ``up``, ``conv``), so reference-keyed state dicts load
with ``strict=True``.  Tensors are NCHW in ``torch.channels_last``.

In eval mode a DoubleConv runs each conv3x3 -> BatchNorm -> ReLU as one
call of :func:`conv3x3_affine_relu_kmajor` with the BatchNorm folded into
a per-channel scale and shift; on a CUDA tensor that is the hand-written
kernel.  The eval-mode forward is for inference: no gradient flows
through the kernel.  In train mode the blocks run stock torch ops.
"""

from __future__ import annotations

import torch
from torch import nn

from jcfszxc_unet_tpu_torch.ops.kernels.conv_fused import (
    conv3x3_affine_relu_kmajor,
)
from jcfszxc_unet_tpu_torch.ops.layers import (
    BatchNorm2d,
    Conv2d,
    ConvTranspose2d,
    pad_or_crop_to,
)


def conv_bn_relu_fused(x, conv: Conv2d, bn: BatchNorm2d):
    """Eval-mode conv3x3 (no bias) -> BN -> ReLU as one fused call.
    x: NCHW channels_last; returns NCHW channels_last in x.dtype."""
    scale, shift = bn.folded()
    # (Cout, 3, 3, Cin), the kernel's layout: one copy at most (none for a
    # channels_last f32 weight)
    w = conv.weight.to(x.dtype).permute(0, 2, 3, 1).contiguous()
    y = conv3x3_affine_relu_kmajor(x.permute(0, 2, 3, 1), w, scale, shift)
    return y.permute(0, 3, 1, 2)


class DoubleConv(nn.Module):
    """(Conv3x3 no-bias -> BN -> ReLU) x2.  Reference unet_parts.py:17-34."""

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: int | None = None):
        super().__init__()
        mid = mid_channels or out_channels
        self.double_conv = nn.Sequential(
            Conv2d(in_channels, mid, 3, padding=1, bias=False),
            BatchNorm2d(mid),
            nn.ReLU(inplace=True),
            Conv2d(mid, out_channels, 3, padding=1, bias=False),
            BatchNorm2d(out_channels),
            nn.ReLU(inplace=True),
        )

    def forward(self, x):
        if self.training:
            return self.double_conv(x)
        seq = self.double_conv
        x = conv_bn_relu_fused(x, seq[0], seq[1])
        return conv_bn_relu_fused(x, seq[3], seq[4])


class Down(nn.Module):
    """MaxPool2 -> DoubleConv.  Reference unet_parts.py:37-47."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(
            nn.MaxPool2d(2), DoubleConv(in_channels, out_channels))

    def forward(self, x):
        return self.maxpool_conv(x)


class Up(nn.Module):
    """ConvTranspose(k2, s2, C -> C/2) -> pad-to-skip -> cat[skip, x] ->
    DoubleConv.  Reference unet_parts.py:50-70."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.up = ConvTranspose2d(in_channels, in_channels // 2, 2, stride=2)
        self.conv = DoubleConv(in_channels, out_channels)

    def forward(self, x1, x2):
        x1 = pad_or_crop_to(self.up(x1), x2.shape[2], x2.shape[3])
        # No copy when both inputs are channels_last (the 2^k patches of
        # tiled evaluation); a padded x1 may come back in another layout.
        x = torch.cat([x2, x1], dim=1).contiguous(
            memory_format=torch.channels_last)
        return self.conv(x)


class OutConv(nn.Module):
    """Conv1x1 head.  Reference unet_parts.py:73-79."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        return self.conv(x)
