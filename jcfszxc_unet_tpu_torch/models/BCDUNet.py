"""BCDU-Net D3 and D1 (reference UNetFamily/BCDUNet.py:15-253), counterparts
of ``jcfszxc_unet_tpu/models/BCDUNet.py``: a plain-conv encoder, a densely
connected bottleneck (three blocks in D3, one in D1) and a decoder that
fuses each skip with the upsampled path by a backward ConvLSTM over the
two-step sequence [skip, upsampled].

Kept from the reference: ``pool3`` pools ``conv3``, not its dropout
(BCDUNet.py:96), so the dropout reaches only the skip; the output is a
sigmoid (BCDUNet.py:144), on which training applies another; ``N`` (the
patch size) is taken and ignored.  ``logit_head=True`` (the train CLI's
``--logit-head``) returns the ``conv9`` head before the sigmoid.

Takes and returns NCHW tensors in ``torch.channels_last``.  In eval mode
every 3x3 conv goes through the fused conv kernel, with its bias as the
shift and its ReLU fused; each ConvLSTM2D launches it twice.  The 1x1
``conv9`` is a stock op.
"""

from __future__ import annotations

import torch
from torch import nn

from jcfszxc_unet_tpu_torch.ops.blocks import (
    ConvBlockPlain,
    ConvLSTM2D,
    UpConvT,
    conv_bn_relu,
)
from jcfszxc_unet_tpu_torch.ops.layers import Conv2d, cat_channels


class BCDU_net_D3(nn.Module):
    dense_blocks = 3

    def __init__(self, N: int = 256, num_channels: int = 3,
                 num_classes: int = 1, logit_head: bool = False):
        super().__init__()
        del N  # the reference's patch size, unused
        self.n_channels = num_channels
        self.n_classes = num_classes
        self.logit_head = logit_head
        self.pool = nn.MaxPool2d(2)
        # encoder (BCDUNet.py:25-33)
        self.conv1 = ConvBlockPlain(num_channels, 64)
        self.conv2 = ConvBlockPlain(64, 128)
        self.conv3 = ConvBlockPlain(128, 256)
        self.drop3 = nn.Dropout(0.5)
        # dense bottleneck (BCDUNet.py:98-113): conv4 -> D1 [-> D2 -> D3]
        self.conv4 = Conv2d(256, 512, 3, padding=1)
        self.conv4_1 = Conv2d(512, 512, 3, padding=1)
        self.drop4_1 = nn.Dropout(0.5)
        if self.dense_blocks == 3:
            self.conv4_2 = Conv2d(512, 512, 3, padding=1)
            self.conv4_2_2 = Conv2d(512, 512, 3, padding=1)
            self.drop4_2 = nn.Dropout(0.5)
            self.conv4_3 = Conv2d(1024, 512, 3, padding=1)
            self.conv4_3_2 = Conv2d(512, 512, 3, padding=1)
            self.drop4_3 = nn.Dropout(0.5)
        # decoder (BCDUNet.py:57-84)
        self.up6 = UpConvT(512, 256)
        self.conv_lstm6 = ConvLSTM2D(256, 128, go_backwards=True)
        self.conv6 = ConvBlockPlain(128, 256)
        self.up7 = UpConvT(256, 128)
        self.conv_lstm7 = ConvLSTM2D(128, 64, go_backwards=True)
        self.conv7 = ConvBlockPlain(64, 128)
        self.up8 = UpConvT(128, 64)
        self.conv_lstm8 = ConvLSTM2D(64, 32, go_backwards=True)
        self.conv8 = nn.Sequential(
            Conv2d(32, 64, 3, padding=1), nn.ReLU(inplace=True),
            Conv2d(64, 64, 3, padding=1), nn.ReLU(inplace=True),
            Conv2d(64, 2, 3, padding=1), nn.ReLU(inplace=True))
        self.conv9 = Conv2d(2, num_classes, 1)

    def forward(self, x):
        conv1 = self.conv1(x)
        conv2 = self.conv2(self.pool(conv1))
        conv3 = self.conv3(self.pool(conv2))
        drop3 = self.drop3(conv3)
        h = conv_bn_relu(self.pool(conv3), self.conv4)
        h = self.drop4_1(conv_bn_relu(h, self.conv4_1))
        if self.dense_blocks == 3:
            drop4_1 = h
            h = conv_bn_relu(drop4_1, self.conv4_2)
            drop4_2 = self.drop4_2(conv_bn_relu(h, self.conv4_2_2))
            h = conv_bn_relu(cat_channels(drop4_2, drop4_1), self.conv4_3)
            h = self.drop4_3(conv_bn_relu(h, self.conv4_3_2))
        h = self.conv6(self.conv_lstm6(drop3, self.up6(h)))
        h = self.conv7(self.conv_lstm7(conv2, self.up7(h)))
        h = self.conv_lstm8(conv1, self.up8(h))
        for k in (0, 2, 4):
            h = conv_bn_relu(h, self.conv8[k])
        h = self.conv9(h)
        return h if self.logit_head else torch.sigmoid(h)


class BCDU_net_D1(BCDU_net_D3):
    dense_blocks = 1
