"""R2U-Net (reference UNetFamily/R2UNet.py:14-82), counterpart of
``jcfszxc_unet_tpu/models/R2UNet.py``: recurrent-residual units
(``RRCNNBlock``, two ``RecurrentBlock``s of t+1 shared-conv applications
each) at every level.  Logits out.

``R2AttentionUNet`` (reference R2AttentionUNet.py:15-91) is the same
network with attention-gated skips; both live here and share the code.

Takes and returns NCHW tensors in ``torch.channels_last``.  In eval mode
each RecurrentBlock launches the fused conv kernel t+1 times with one
fold, and each UpConvBlock once: 58 launches per forward at t = 2.
"""

from __future__ import annotations

from torch import nn

from jcfszxc_unet_tpu_torch.ops.blocks import (
    AttentionBlock,
    RRCNNBlock,
    UpConvBlock,
)
from jcfszxc_unet_tpu_torch.ops.layers import Conv2d, cat_channels

WIDTHS = (64, 128, 256, 512, 1024)


class R2UNet(nn.Module):
    attention = False

    def __init__(self, img_ch: int = 3, output_ch: int = 1, t: int = 2):
        super().__init__()
        self.n_channels = img_ch
        self.n_classes = output_ch
        self.Maxpool = nn.MaxPool2d(2)
        cins = (img_ch,) + WIDTHS[:-1]
        for k, (cin, cout) in enumerate(zip(cins, WIDTHS), start=1):
            setattr(self, f"RRCNN{k}", RRCNNBlock(cin, cout, t))
        for k in range(5, 1, -1):
            c = WIDTHS[k - 2]
            setattr(self, f"Up{k}", UpConvBlock(2 * c, c))
            if self.attention:
                setattr(self, f"Att{k}", AttentionBlock(c, c, c // 2))
            setattr(self, f"Up_RRCNN{k}", RRCNNBlock(2 * c, c, t))
        self.Conv_1x1 = Conv2d(WIDTHS[0], output_ch, 1)

    def forward(self, x):
        skips = [self.RRCNN1(x)]
        for k in range(2, 6):
            skips.append(getattr(self, f"RRCNN{k}")(self.Maxpool(skips[-1])))
        d = skips.pop()
        for k in range(5, 1, -1):
            d = getattr(self, f"Up{k}")(d)
            s = skips.pop()
            if self.attention:
                s = getattr(self, f"Att{k}")(d, s)
            d = getattr(self, f"Up_RRCNN{k}")(cat_channels(s, d))
        return self.Conv_1x1(d)


class R2AttentionUNet(R2UNet):
    attention = True
