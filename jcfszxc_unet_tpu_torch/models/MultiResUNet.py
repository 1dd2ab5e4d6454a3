"""MultiResUNet (reference UNetFamily/MultiResUNet.py:15-162), counterpart
of ``jcfszxc_unet_tpu/models/MultiResUNet.py``: Multiresblocks down and up,
Respath skips of lengths 4, 3, 2 and 1, and the alpha = 1.67 width
arithmetic with the reference's int() truncation.  Logits out (a 1x1
Conv2dBatchnorm, no activation).

``s2d`` (space-to-depth execution, the JAX model's): where H and W are
multiples of 4, the narrow first two levels stay resident in s2d space:
multiresblock1, respath1, multiresblock2, respath2 and, in the decoder,
multiresblock8 and multiresblock9, with one transform at each true
boundary (the pools leave s2d by a phase max, the transposed convs'
outputs are packed before their concat).  Other sizes run plain.  Same
parameters in both modes.

Takes and returns NCHW tensors in ``torch.channels_last``.  In eval mode
each of the 37 3x3 Conv2dBatchnorms (27 in the blocks, 10 in the
Respaths) runs as one fused conv call with its BN folded and its ReLU
fused; the 1x1 shortcuts, the BNs around each block's add and the
Respaths' reused BNs are stock ops.
"""

from __future__ import annotations

from torch import nn

from jcfszxc_unet_tpu_torch.ops.blocks import (
    Conv2dBatchnorm,
    Multiresblock,
    Respath,
)
from jcfszxc_unet_tpu_torch.ops.layers import ConvTranspose2d, cat_channels
from jcfszxc_unet_tpu_torch.ops.s2d import (
    depth_to_space,
    maxpool_exit,
    space_to_depth,
)

FILTERS = (32, 64, 128, 256, 512)


def _mrb_out(filters: int, alpha: float) -> int:
    """Output width of a Multiresblock of ``filters``."""
    w = filters * alpha
    return int(w * 0.167) + int(w * 0.333) + int(w * 0.5)


class MultiResUNet(nn.Module):
    def __init__(self, input_channels: int = 3, num_classes: int = 1,
                 alpha: float = 1.67, s2d: bool = False):
        super().__init__()
        self.s2d = s2d
        self.n_channels = input_channels
        self.n_classes = num_classes
        outs = [_mrb_out(f, alpha) for f in FILTERS]
        self.pool = nn.MaxPool2d(2)
        cin = input_channels
        for k, (f, length) in enumerate(zip(FILTERS[:4], (4, 3, 2, 1)),
                                        start=1):
            setattr(self, f"multiresblock{k}", Multiresblock(cin, f, alpha))
            setattr(self, f"respath{k}", Respath(outs[k - 1], f, length))
            cin = outs[k - 1]
        self.multiresblock5 = Multiresblock(cin, FILTERS[4], alpha)
        for k in range(6, 10):
            f = FILTERS[9 - k]
            setattr(self, f"upsample{k}",
                    ConvTranspose2d(outs[10 - k], f, 2, stride=2))
            setattr(self, f"multiresblock{k}", Multiresblock(2 * f, f, alpha))
        self.conv_final = Conv2dBatchnorm(outs[0], num_classes, 1,
                                          activation="None")

    def forward(self, x):
        # s2d: levels 1 and 2 resident in space-to-depth form, %4 so that
        # level 2's maps are even too (JAX MultiResUNet.py:47-120)
        use = self.s2d and x.shape[2] % 4 == 0 and x.shape[3] % 4 == 0
        if use:
            x = space_to_depth(x)
        skips = []
        for k in range(1, 5):
            resident = use and k <= 2
            m = getattr(self, f"multiresblock{k}")(x, s2d_io=resident)
            skips.append(getattr(self, f"respath{k}")(m, s2d_io=resident))
            if resident:
                x = maxpool_exit(m)
                x = space_to_depth(x) if k == 1 else x
            else:
                x = self.pool(m)
        x = self.multiresblock5(x)
        for k in range(6, 10):
            u = getattr(self, f"upsample{k}")(x)
            resident = use and k >= 8
            if resident:
                u = space_to_depth(u)
            x = getattr(self, f"multiresblock{k}")(
                cat_channels(u, skips.pop()), s2d_io=resident)
            if resident:
                x = depth_to_space(x)
        return self.conv_final(x)
