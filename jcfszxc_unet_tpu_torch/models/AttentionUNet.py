"""Attention U-Net (reference UNetFamily/AttentionUNet.py:15-86),
counterpart of ``jcfszxc_unet_tpu/models/AttentionUNet.py``: a 5-level
``ConvBlockBN`` encoder, attention-gated skips and a nearest-upsample
decoder.  Logits out.

Takes and returns NCHW tensors in ``torch.channels_last``.  In eval mode
its 22 3x3 convs go through the fused conv kernel; the gates' 1x1 convs
and the head are stock ops.
"""

from __future__ import annotations

from torch import nn

from jcfszxc_unet_tpu_torch.ops.blocks import (
    AttentionBlock,
    ConvBlockBN,
    UpConvBlock,
)
from jcfszxc_unet_tpu_torch.ops.layers import Conv2d, cat_channels

WIDTHS = (64, 128, 256, 512, 1024)


class AttentionUNet(nn.Module):
    def __init__(self, img_ch: int = 3, output_ch: int = 1):
        super().__init__()
        self.n_channels = img_ch
        self.n_classes = output_ch
        self.Maxpool = nn.MaxPool2d(2)
        cins = (img_ch,) + WIDTHS[:-1]
        for k, (cin, cout) in enumerate(zip(cins, WIDTHS), start=1):
            setattr(self, f"Conv{k}", ConvBlockBN(cin, cout))
        for k in range(5, 1, -1):
            c = WIDTHS[k - 2]
            setattr(self, f"Up{k}", UpConvBlock(2 * c, c))
            setattr(self, f"Att{k}", AttentionBlock(c, c, c // 2))
            setattr(self, f"Up_conv{k}", ConvBlockBN(2 * c, c))
        self.Conv_1x1 = Conv2d(WIDTHS[0], output_ch, 1)

    def forward(self, x):
        skips = [self.Conv1(x)]
        for k in range(2, 6):
            skips.append(getattr(self, f"Conv{k}")(self.Maxpool(skips[-1])))
        d = skips.pop()
        for k in range(5, 1, -1):
            d = getattr(self, f"Up{k}")(d)
            s = getattr(self, f"Att{k}")(d, skips.pop())
            d = getattr(self, f"Up_conv{k}")(cat_channels(s, d))
        return self.Conv_1x1(d)
