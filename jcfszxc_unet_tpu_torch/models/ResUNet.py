"""ResUNet (reference UNetFamily/ResUNet.py:15-76), counterpart of
``jcfszxc_unet_tpu/models/ResUNet.py``: a residual input stem, three
stride-2 ``ResidualConv`` downs, ConvTranspose ups.  Returns sigmoid
probabilities (ResUNet.py:46-49); the training loss and the evaluation
apply another sigmoid on top, as in the JAX package.

Takes and returns NCHW tensors in ``torch.channels_last``.  In eval mode
its 15 stride-1 3x3 convs go through the fused conv kernel; the stride-2
convs, the transposed convs and the 1x1 head are stock ops.
"""

from __future__ import annotations

import torch
from torch import nn

from jcfszxc_unet_tpu_torch.ops.blocks import (
    ResidualConv,
    UpsampleT,
    conv_bn_relu_fused,
)
from jcfszxc_unet_tpu_torch.ops.layers import (
    BatchNorm2d,
    Conv2d,
    cat_channels,
    channels_last,
)


class ResUNet(nn.Module):
    def __init__(self, channel: int = 3, out_channels: int = 1):
        super().__init__()
        self.n_channels = channel
        self.n_classes = out_channels
        self.input_layer = nn.Sequential(
            Conv2d(channel, 64, 3, padding=1),
            BatchNorm2d(64),
            nn.ReLU(),
            Conv2d(64, 64, 3, padding=1),
        )
        self.input_skip = nn.Sequential(Conv2d(channel, 64, 3, padding=1))
        self.residual_conv_1 = ResidualConv(64, 128, 2, 1)
        self.residual_conv_2 = ResidualConv(128, 256, 2, 1)
        self.bridge = ResidualConv(256, 512, 2, 1)
        self.upsample_1 = UpsampleT(512, 512, 2, 2)
        self.up_residual_conv1 = ResidualConv(512 + 256, 256, 1, 1)
        self.upsample_2 = UpsampleT(256, 256, 2, 2)
        self.up_residual_conv2 = ResidualConv(256 + 128, 128, 1, 1)
        self.upsample_3 = UpsampleT(128, 128, 2, 2)
        self.up_residual_conv3 = ResidualConv(128 + 64, 64, 1, 1)
        self.output_layer = nn.Sequential(Conv2d(64, out_channels, 1))

    def _stem(self, x):
        if self.training:
            return self.input_layer(x) + self.input_skip(x)
        il = self.input_layer
        h = conv_bn_relu_fused(x, il[0], il[1])
        h = conv_bn_relu_fused(h, il[3], relu=False)
        return channels_last(
            h + conv_bn_relu_fused(x, self.input_skip[0], relu=False))

    def forward(self, x):
        x1 = self._stem(x)
        x2 = self.residual_conv_1(x1)
        x3 = self.residual_conv_2(x2)
        x4 = self.upsample_1(self.bridge(x3))
        x6 = self.up_residual_conv1(cat_channels(x4, x3))
        x6 = self.upsample_2(x6)
        x8 = self.up_residual_conv2(cat_channels(x6, x2))
        x8 = self.upsample_3(x8)
        x10 = self.up_residual_conv3(cat_channels(x8, x1))
        return torch.sigmoid(self.output_layer(x10))
