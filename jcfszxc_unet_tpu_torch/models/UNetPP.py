"""NestedUNet / UNet++ (reference UNetFamily/UNetPP.py:31-107), counterpart
of ``jcfszxc_unet_tpu/models/UNetPP.py``: a nested grid of dense skips
with bilinear (align_corners=True) upsampling and sigmoid output.

Its nodes use UNetPP's private DoubleConv, whose convs carry a bias
(UNetPP.py:15-28).  ``deepsupervision`` (False in the reference) returns
the four heads' sigmoids instead of the last one.  The JAX model feeds the
first conv of a row-0/1 node a tuple and convolves it in split form; here
the inputs are concatenated and the conv runs as one kernel call, the
same function.  The ``s2d`` execution mode is not ported yet.

Takes and returns NCHW tensors in ``torch.channels_last``.  In eval mode
all 30 3x3 convs go through the fused conv kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from jcfszxc_unet_tpu_torch.ops.blocks import conv_bn_relu_fused
from jcfszxc_unet_tpu_torch.ops.layers import (
    BatchNorm2d,
    Conv2d,
    cat_channels,
    upsample_bilinear,
)


class DoubleConvBias(nn.Module):
    """(Conv3x3 bias -> BN -> ReLU) x2, reference UNetPP.py:15-28."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.conv = nn.Sequential(
            Conv2d(in_ch, out_ch, 3, padding=1),
            BatchNorm2d(out_ch),
            nn.ReLU(inplace=True),
            Conv2d(out_ch, out_ch, 3, padding=1),
            BatchNorm2d(out_ch),
            nn.ReLU(inplace=True),
        )

    def forward(self, *xs):
        x = cat_channels(*xs) if len(xs) > 1 else xs[0]
        if self.training:
            return self.conv(x)
        seq = self.conv
        x = conv_bn_relu_fused(x, seq[0], seq[1])
        return conv_bn_relu_fused(x, seq[3], seq[4])


class NestedUNet(nn.Module):
    def __init__(self, in_channel: int = 3, out_channel: int = 1,
                 deepsupervision: bool = False, s2d: bool = False):
        super().__init__()
        if s2d:
            raise NotImplementedError(
                "NestedUNet's s2d execution mode is not ported to PyTorch "
                "yet")
        self.n_channels = in_channel
        self.n_classes = out_channel
        self.deepsupervision = deepsupervision
        nb = [32, 64, 128, 256, 512]
        self.pool = nn.MaxPool2d(2)
        # node (i, j): row i, column j; inputs: the j nodes to its left on
        # row i and the upsampled node (i + 1, j - 1)
        for i in range(5):
            for j in range(5 - i):
                cin = ((in_channel if i == 0 else nb[i - 1]) if j == 0
                       else nb[i] * j + nb[i + 1])
                setattr(self, f"conv{i}_{j}", DoubleConvBias(cin, nb[i]))
        if deepsupervision:
            for k in range(1, 5):
                setattr(self, f"final{k}", Conv2d(nb[0], out_channel, 1))
        else:
            self.final = Conv2d(nb[0], out_channel, 1)

    def forward(self, x):
        # JAX column order: x0_0, x1_0, x0_1, x2_0, x1_1, x0_2, ...
        rows = [[] for _ in range(5)]
        for d in range(5):             # anti-diagonal: i + j == d
            for i in range(d, -1, -1):
                j = d - i
                node = getattr(self, f"conv{i}_{j}")
                if j == 0:
                    inp = x if i == 0 else self.pool(rows[i - 1][0])
                    rows[i].append(node(inp))
                else:
                    up = upsample_bilinear(rows[i + 1][j - 1])
                    rows[i].append(node(*rows[i], up))
        if self.deepsupervision:
            return [torch.sigmoid(getattr(self, f"final{k}")(rows[0][k]))
                    for k in range(1, 5)]
        return torch.sigmoid(self.final(rows[0][4]))
