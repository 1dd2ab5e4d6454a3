"""MCUNet (reference UNetFamily/MCUNet.py:15-61), counterpart of
``jcfszxc_unet_tpu/models/MCUNet.py``: a UNet of base width 32 with a
CBAM after each encoder stage and an InceptionA bottleneck.  Logits out.

InceptionA keeps the resolution, so ``up1`` upsamples past its skip's
size and ``UpV1`` center-crops (the reference's negative pad).

Takes and returns NCHW tensors in ``torch.channels_last``.  In eval mode
its 19 3x3 convs go through the fused conv kernel (InceptionA's three
with their eps-1e-3 BNs folded); the CBAMs, the 1x1 convs, the bilinear
upsamplings and the head are stock ops.
"""

from __future__ import annotations

from torch import nn

from jcfszxc_unet_tpu_torch.ops.blocks import (
    CBAM,
    DoubleConv,
    Down,
    InceptionA,
    OutConv,
    UpV1,
)


class MCUNet(nn.Module):
    def __init__(self, in_channels: int = 3, num_classes: int = 1,
                 bilinear: bool = True, base_c: int = 32):
        super().__init__()
        self.n_channels = in_channels
        self.n_classes = num_classes
        c = base_c
        factor = 2 if bilinear else 1
        self.in_conv = DoubleConv(in_channels, c)
        self.cbam1 = CBAM(c)
        self.down1 = Down(c, c * 2)
        self.cbam2 = CBAM(c * 2)
        self.down2 = Down(c * 2, c * 4)
        self.cbam3 = CBAM(c * 4)
        self.down3 = Down(c * 4, c * 8)
        self.cbam4 = CBAM(c * 8)
        self.down4 = InceptionA(c * 8)
        self.up1 = UpV1(c * 16, c * 8 // factor, bilinear)
        self.up2 = UpV1(c * 8, c * 4 // factor, bilinear)
        self.up3 = UpV1(c * 4, c * 2 // factor, bilinear)
        self.up4 = UpV1(c * 2, c, bilinear)
        self.out_conv = OutConv(c, num_classes)

    def forward(self, x):
        x1 = self.cbam1(self.in_conv(x))
        x2 = self.cbam2(self.down1(x1))
        x3 = self.cbam3(self.down2(x2))
        x4 = self.cbam4(self.down3(x3))
        y = self.up1(self.down4(x4), x4)
        y = self.up2(y, x3)
        y = self.up3(y, x2)
        y = self.up4(y, x1)
        return self.out_conv(y)
