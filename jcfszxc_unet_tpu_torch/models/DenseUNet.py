"""DenseUNet (reference UNetFamily/DenseUNet.py:15-56), counterpart of
``jcfszxc_unet_tpu/models/DenseUNet.py``: constant-width (128) levels of
dense-additive convs.  Logits out.

Kept from the reference: ``n_classes`` reports ``filters`` (128,
DenseUNet.py:39) although the head emits ``out_chan`` channels, which sends
training down the ``n_classes > 1`` cross-entropy branch
(``train/losses.soft_cross_entropy``).  The reference's forward reuses one
parameter-free pooling for all four downsamples, so its unused ``down2``
to ``down4`` hold no keys here either.

Takes and returns NCHW tensors in ``torch.channels_last``.  In eval mode
the 36 convs of the nine SingleLevelDensenets and the four
UpsampleNConcat convs go through the fused conv kernel.
"""

from __future__ import annotations

from torch import nn

from jcfszxc_unet_tpu_torch.ops.blocks import (
    SingleLevelDensenet,
    UpsampleNConcat,
    down_sample,
)
from jcfszxc_unet_tpu_torch.ops.layers import Conv2d


class DenseUNet(nn.Module):
    def __init__(self, in_chan: int = 3, out_chan: int = 1,
                 filters: int = 128, num_conv: int = 4):
        super().__init__()
        self.n_channels = in_chan
        self.n_classes = filters  # reference defect, kept
        self.conv1 = Conv2d(in_chan, filters, 1)
        for name in ("d1", "d2", "d3", "d4", "bottom", "u4", "u3", "u2",
                     "u1"):
            setattr(self, name, SingleLevelDensenet(filters, num_conv))
        for k in range(1, 5):
            setattr(self, f"up{k}", UpsampleNConcat(filters))
        self.outconv = Conv2d(filters, out_chan, 1)

    def forward(self, x):
        x = self.conv1(x)
        skips = []
        for name in ("d1", "d2", "d3", "d4"):
            x, y = down_sample(getattr(self, name)(x))
            skips.append(y)
        x = self.bottom(x)
        for k in range(4, 0, -1):
            x = getattr(self, f"up{k}")(x, skips.pop())
            x = getattr(self, f"u{k}")(x)
        return self.outconv(x)
