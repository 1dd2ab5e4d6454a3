"""FRUNet (reference UNetFamily/FRUNet.py:15-138), counterpart of
``jcfszxc_unet_tpu/models/FRUNet.py``: a full-resolution grid of 16 block
nodes exchanging up and down branches, feature_scale 2, and five 1x1
heads on full-resolution nodes, averaged.  Logits out.

The reference's top-level ``fuse`` head and the ``fuse`` of every node
with in_c == out_c are never applied by its forward; this model, like
the JAX one, leaves them out.

``s2d`` (space-to-depth execution, the JAX model's): the seven nodes of
the full-resolution 32-channel row run in s2d space (128 channels at half
the map) where H and W are even; the other rows and the heads run plain.
Same parameters and, with dropout live, the same Dropout2d masks for one
RNG state.

Takes and returns NCHW tensors in ``torch.channels_last``.  In eval mode
the 32 FRConv convs (BN folded, ReLU off, LeakyReLU stock) and the 12
FeatureFuse 3x3 convs (scale 1, shift 0) go through the fused conv
kernel.
"""

from __future__ import annotations

from torch import nn

from jcfszxc_unet_tpu_torch.ops.blocks import FRBlock
from jcfszxc_unet_tpu_torch.ops.layers import Conv2d, cat_channels

# (name, in_c as multiples of the level's width or "in", level, is_up,
# is_down) in the order of the reference's forward (FRUNet.py:109-126).
_NODES = (
    ("block1_3", "in", 0, False, True), ("block1_2", 1, 0, False, True),
    ("block2_2", 1, 1, True, True), ("block1_1", 2, 0, False, True),
    ("block2_1", 2, 1, True, True), ("block3_1", 1, 2, True, True),
    ("block10", 2, 0, False, True), ("block20", 3, 1, True, True),
    ("block30", 2, 2, True, False), ("block40", 1, 3, True, False),
    ("block11", 2, 0, False, True), ("block21", 3, 1, True, False),
    ("block31", 3, 2, True, False), ("block12", 2, 0, False, False),
    ("block22", 3, 1, True, False), ("block13", 2, 0, False, False),
)


class FRUNet(nn.Module):
    def __init__(self, num_classes: int = 1, num_channels: int = 3,
                 feature_scale: int = 2, dropout: float = 0.2,
                 s2d: bool = False):
        super().__init__()
        self.s2d = s2d
        self.n_channels = num_channels
        self.n_classes = num_classes
        f = [int(v / feature_scale) for v in (64, 128, 256, 512, 1024)]
        for name, mult, level, is_up, is_down in _NODES:
            in_c = num_channels if mult == "in" else f[level] * mult
            # s2d pays where the channels are narrow: the full-res row
            setattr(self, name, FRBlock(in_c, f[level], dropout, is_up,
                                        is_down, s2d=s2d and level == 0))
        for i in range(1, 6):
            setattr(self, f"final{i}", Conv2d(f[0], num_classes, 1))

    def forward(self, x):
        cat = cat_channels
        x1_3, x_down1_3 = self.block1_3(x)
        x1_2, x_down1_2 = self.block1_2(x1_3)
        x2_2, x_up2_2, x_down2_2 = self.block2_2(x_down1_3)
        x1_1, x_down1_1 = self.block1_1(cat(x1_2, x_up2_2))
        x2_1, x_up2_1, x_down2_1 = self.block2_1(cat(x_down1_2, x2_2))
        x3_1, x_up3_1, x_down3_1 = self.block3_1(x_down2_2)
        x10, x_down10 = self.block10(cat(x1_1, x_up2_1))
        x20, x_up20, x_down20 = self.block20(cat(x_down1_1, x2_1, x_up3_1))
        x30, x_up30 = self.block30(cat(x_down2_1, x3_1))
        _, x_up40 = self.block40(x_down3_1)
        x11, x_down11 = self.block11(cat(x10, x_up20))
        x21, x_up21 = self.block21(cat(x_down10, x20, x_up30))
        _, x_up31 = self.block31(cat(x_down20, x30, x_up40))
        x12 = self.block12(cat(x11, x_up21))
        _, x_up22 = self.block22(cat(x_down11, x21, x_up31))
        x13 = self.block13(cat(x12, x_up22))
        return (self.final1(x1_1) + self.final2(x10) + self.final3(x11)
                + self.final4(x12) + self.final5(x13)) / 5
