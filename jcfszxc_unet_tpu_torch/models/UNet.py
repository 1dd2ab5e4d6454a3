"""Canonical 5-level UNet (reference UNetFamily/UNet.py:14-55), counterpart
of ``jcfszxc_unet_tpu/models/UNet.py``: 64 -> 1024 channels, maxpool
encoder, ConvTranspose(k2, s2) decoder, logits out.

Takes and returns NCHW tensors in ``torch.channels_last``.
"""

from __future__ import annotations

from torch import nn

from jcfszxc_unet_tpu_torch.ops.blocks import DoubleConv, Down, OutConv, Up


class UNet(nn.Module):
    def __init__(self, n_channels: int = 3, n_classes: int = 1):
        super().__init__()
        self.n_channels = n_channels
        self.n_classes = n_classes
        self.inc = DoubleConv(n_channels, 64)
        self.down1 = Down(64, 128)
        self.down2 = Down(128, 256)
        self.down3 = Down(256, 512)
        self.down4 = Down(512, 1024)
        self.up1 = Up(1024, 512)
        self.up2 = Up(512, 256)
        self.up3 = Up(256, 128)
        self.up4 = Up(128, 64)
        self.outc = OutConv(64, n_classes)

    def forward(self, x):
        x1 = self.inc(x)
        x2 = self.down1(x1)
        x3 = self.down2(x2)
        x4 = self.down3(x3)
        x5 = self.down4(x4)
        x = self.up1(x5, x4)
        x = self.up2(x, x3)
        x = self.up3(x, x2)
        x = self.up4(x, x1)
        return self.outc(x)
