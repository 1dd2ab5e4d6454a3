"""NestedUNet / UNet++ (Zhou et al. 2018, arXiv:1807.10165) as reference
``UNetFamily/UNetPP.py:31-107`` builds it, in plain PyTorch: a grid of
nodes (i, j) with widths [32, 64, 128, 256, 512] by row, each node two
(3x3 conv with bias -> BatchNorm -> ReLU); node (i, 0) takes the 2x2 max
pool of (i - 1, 0), node (i, j > 0) the concatenation of (i, 0..j-1) and
the bilinear (align_corners=True) 2x upsampling of (i + 1, j - 1); a 1x1
head on (0, 4) and a sigmoid (deep supervision off).  Parameter names are
the reference's.  No departures."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from reference.protocol import QConv2d

WIDTHS = [32, 64, 128, 256, 512]


class DoubleConvBias(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.conv = nn.Sequential(
            QConv2d(cin, cout, 3, padding=1), nn.BatchNorm2d(cout), nn.ReLU(),
            QConv2d(cout, cout, 3, padding=1), nn.BatchNorm2d(cout),
            nn.ReLU())

    def forward(self, x):
        return self.conv(x)


class NestedUNet(nn.Module):
    def __init__(self, in_channel: int = 3, out_channel: int = 1):
        super().__init__()
        nb = WIDTHS
        for i in range(5):
            for j in range(5 - i):
                cin = ((in_channel if i == 0 else nb[i - 1]) if j == 0
                       else nb[i] * j + nb[i + 1])
                setattr(self, f"conv{i}_{j}", DoubleConvBias(cin, nb[i]))
        self.final = QConv2d(nb[0], out_channel, 1)

    def forward(self, x):
        rows = [[] for _ in range(5)]
        for d in range(5):
            for i in range(d, -1, -1):
                j = d - i
                node = getattr(self, f"conv{i}_{j}")
                if j == 0:
                    inp = x if i == 0 else F.max_pool2d(rows[i - 1][0], 2)
                else:
                    up = F.interpolate(rows[i + 1][j - 1], scale_factor=2,
                                       mode="bilinear", align_corners=True)
                    inp = torch.cat(rows[i] + [up], dim=1)
                rows[i].append(node(inp))
        return torch.sigmoid(self.final(rows[0][4]))


def build() -> nn.Module:
    return NestedUNet()
