"""UNet (Ronneberger et al. 2015, arXiv:1505.04597) as reference
``UNetFamily/UNet.py:14-55`` and ``unet_parts.py:17-79`` build it, in plain
PyTorch: two (3x3 conv without bias -> BatchNorm -> ReLU) a level,
64 -> 1024 channels over four 2x2 max pools, ConvTranspose(k2, s2) ups
that centre-pad to the skip and concatenate [skip, up], a 1x1 head with
one logit channel.  Parameter names are the reference's, so its state
dicts load with ``strict=True``.  No departures."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from reference.protocol import QConv2d, QConvTranspose2d


def double_conv(cin: int, cout: int) -> nn.Sequential:
    return nn.Sequential(
        QConv2d(cin, cout, 3, padding=1, bias=False), nn.BatchNorm2d(cout),
        nn.ReLU(), QConv2d(cout, cout, 3, padding=1, bias=False),
        nn.BatchNorm2d(cout), nn.ReLU())


class DoubleConv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.double_conv = double_conv(cin, cout)

    def forward(self, x):
        return self.double_conv(x)


class Down(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.maxpool_conv = nn.Sequential(nn.MaxPool2d(2),
                                          DoubleConv(cin, cout))

    def forward(self, x):
        return self.maxpool_conv(x)


class Up(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.up = QConvTranspose2d(cin, cin // 2, 2, stride=2)
        self.conv = DoubleConv(cin, cout)

    def forward(self, x1, x2):
        x1 = self.up(x1)
        dh, dw = x2.shape[2] - x1.shape[2], x2.shape[3] - x1.shape[3]
        x1 = F.pad(x1, [dw // 2, dw - dw // 2, dh // 2, dh - dh // 2])
        return self.conv(torch.cat([x2, x1], dim=1))


class OutConv(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = QConv2d(cin, cout, 1)

    def forward(self, x):
        return self.conv(x)


class UNet(nn.Module):
    def __init__(self, n_channels: int = 3, n_classes: int = 1):
        super().__init__()
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


def build() -> nn.Module:
    return UNet()
