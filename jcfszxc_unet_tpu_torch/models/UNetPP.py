"""NestedUNet / UNet++ (reference UNetFamily/UNetPP.py:31-107), counterpart
of ``jcfszxc_unet_tpu/models/UNetPP.py``: a nested grid of dense skips
with bilinear (align_corners=True) upsampling and sigmoid output.

Its nodes use UNetPP's private DoubleConv, whose convs carry a bias
(UNetPP.py:15-28).  ``deepsupervision`` (False in the reference) returns
the four heads' sigmoids instead of the last one.  The JAX model feeds the
first conv of a row-0/1 node a tuple and convolves it in split form; here
the inputs are concatenated and the conv runs as one kernel call, the
same function.

``s2d`` (space-to-depth execution, the JAX model's): where H and W are
multiples of 4, rows 0 and 1 (32 and 64 channels) stay resident in s2d
space over the whole grid: the input is packed once, row 0's pool leaves
s2d by a phase max and re-packs, row 1's pool leaves it, the up-edges into
rows 0 and 1 interpolate straight into s2d form, and the head reads row 0
unpacked.  Other sizes run plain.  Same parameters in both modes.

Takes and returns NCHW tensors in ``torch.channels_last``.  In eval mode
all 30 3x3 convs go through the fused conv kernel (in s2d mode the 18 of
rows 0 and 1 as 3x3 convs on 4x the channels).
"""

from __future__ import annotations

import torch
from torch import nn

from jcfszxc_unet_tpu_torch.ops.blocks import conv_bn_relu
from jcfszxc_unet_tpu_torch.ops.layers import (
    BatchNorm2d,
    Conv2d,
    cat_channels,
    upsample_bilinear,
)
from jcfszxc_unet_tpu_torch.ops.s2d import (
    depth_to_space,
    maxpool_exit,
    space_to_depth,
    upsample_bilinear_s2d,
)


class DoubleConvBias(nn.Module):
    """(Conv3x3 bias -> BN -> ReLU) x2, reference UNetPP.py:15-28, on the
    concat of its inputs.  ``forward(*xs, s2d_io=True)`` takes and returns
    space-to-depth tensors (the JAX node's persistent form, the one the
    model uses)."""

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

    def forward(self, *xs, s2d_io: bool = False):
        x = cat_channels(*xs) if len(xs) > 1 else xs[0]
        if self.training and not s2d_io:
            return self.conv(x)
        seq = self.conv
        x = conv_bn_relu(x, seq[0], seq[1], s2d=s2d_io)
        return conv_bn_relu(x, seq[3], seq[4], s2d=s2d_io)


class NestedUNet(nn.Module):
    def __init__(self, in_channel: int = 3, out_channel: int = 1,
                 deepsupervision: bool = False, s2d: bool = False):
        super().__init__()
        self.s2d = s2d
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
        # s2d: rows 0 and 1 resident in space-to-depth form; %4 so that
        # row 1's maps are even too (JAX UNetPP.py:106-130)
        use = self.s2d and x.shape[2] % 4 == 0 and x.shape[3] % 4 == 0
        # the pool into row i and the upsample into row i, by row
        pools = [None, self.pool, self.pool, self.pool, self.pool]
        ups = [upsample_bilinear] * 4
        if use:
            x = space_to_depth(x)
            pools[1:3] = [lambda t: space_to_depth(maxpool_exit(t)),
                          maxpool_exit]
            ups[0:2] = [lambda t: upsample_bilinear_s2d(t, from_s2d=True),
                        upsample_bilinear_s2d]
        # JAX column order: x0_0, x1_0, x0_1, x2_0, x1_1, x0_2, ...
        rows = [[] for _ in range(5)]
        for d in range(5):             # anti-diagonal: i + j == d
            for i in range(d, -1, -1):
                j = d - i
                node = getattr(self, f"conv{i}_{j}")
                resident = use and i < 2
                if j == 0:
                    inp = x if i == 0 else pools[i](rows[i - 1][0])
                    rows[i].append(node(inp, s2d_io=resident))
                else:
                    up = ups[i](rows[i + 1][j - 1])
                    rows[i].append(node(*rows[i], up, s2d_io=resident))
        unpack = depth_to_space if use else (lambda t: t)
        if self.deepsupervision:
            return [torch.sigmoid(getattr(self, f"final{k}")(
                unpack(rows[0][k]))) for k in range(1, 5)]
        return torch.sigmoid(self.final(unpack(rows[0][4])))
