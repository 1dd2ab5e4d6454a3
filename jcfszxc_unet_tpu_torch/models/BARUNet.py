"""BARUNet (reference UNetFamily/BARUNet.py:15-84), counterpart of
``jcfszxc_unet_tpu/models/BARUNet.py``: a ``ConvBlockBN`` stem and four
bridge-attention ``BABasicBlock`` stages, each encoder skip refined by a
residual CBAM, and AttentionUNet's nearest-upsample decoder.

Kept from the reference: the output is a softmax over the channel axis
(BARUNet.py:83), with one output channel a constant 1.0 map, on which
training applies a sigmoid.  ``logit_head=True`` (the train CLI's
``--logit-head``) returns the 1x1 head before it.

Takes and returns NCHW tensors in ``torch.channels_last``.  In eval mode
its 22 3x3 convs go through the fused conv kernel (each BABasicBlock's
second conv with its BN folded and ReLU off); the CBAMs, the BAModules'
Linears and BatchNorm1ds, the 1x1 residuals and the head are stock ops.
"""

from __future__ import annotations

import torch
from torch import nn

from jcfszxc_unet_tpu_torch.ops.blocks import (
    CBAM,
    BABasicBlock,
    ConvBlockBN,
    SEBlock,
    UpConvBlock,
)
from jcfszxc_unet_tpu_torch.ops.layers import (
    Conv2d,
    cat_channels,
    channels_last,
)

WIDTHS = (64, 128, 256, 512, 1024)


class BARUNet(nn.Module):
    # BIARUNet: an SEBlock on each decoder upsample (SE1 after Up5, ...)
    se_blocks = False

    def __init__(self, img_ch: int = 3, output_ch: int = 1,
                 logit_head: bool = False):
        super().__init__()
        self.n_channels = img_ch
        self.n_classes = output_ch
        self.logit_head = logit_head
        self.Maxpool = nn.MaxPool2d(2)
        self.Conv1 = ConvBlockBN(img_ch, WIDTHS[0])
        for k in range(2, 6):
            setattr(self, f"Conv{k}", BABasicBlock(WIDTHS[k - 2],
                                                   WIDTHS[k - 1]))
        for k in range(1, 5):
            setattr(self, f"cbam{k}", CBAM(WIDTHS[k - 1]))
        for k in range(5, 1, -1):
            c = WIDTHS[k - 2]
            setattr(self, f"Up{k}", UpConvBlock(2 * c, c))
            if self.se_blocks:
                setattr(self, f"SE{6 - k}", SEBlock(c))
            setattr(self, f"Up_conv{k}", ConvBlockBN(2 * c, c))
        self.Conv_1x1 = Conv2d(WIDTHS[0], output_ch, 1)

    def forward(self, x):
        x = self.Conv1(x)
        skips = []
        for k in range(1, 6):
            if k > 1:
                x = getattr(self, f"Conv{k}")(self.Maxpool(x))
            if k < 5:
                x = channels_last(getattr(self, f"cbam{k}")(x) + x)
                skips.append(x)
        d = x
        for k in range(5, 1, -1):
            d = getattr(self, f"Up{k}")(d)
            if self.se_blocks:
                d = getattr(self, f"SE{6 - k}")(d)
            d = getattr(self, f"Up_conv{k}")(cat_channels(skips.pop(), d))
        d = self.Conv_1x1(d)
        return d if self.logit_head else torch.softmax(d, dim=1)
