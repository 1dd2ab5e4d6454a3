"""SegNet (reference UNetFamily/SegNet.py:15-149), counterpart of
``jcfszxc_unet_tpu/models/SegNet.py``: a VGG16-style 13-conv encoder and
a mirrored decoder that unpools to the encoder's argmax positions.  Logits
out.  H and W must be multiples of 32.

The pooling keeps a window-local one-hot of the first maximum
(``layers.max_pool2d_with_indices``), as the JAX package does, so ties
resolve the same way in both.  Takes and returns NCHW tensors in
``torch.channels_last``.  In eval mode all 26 3x3 convs go through the
fused conv kernel, the head (64 -> 1, ReLU off) with its bias as the
shift.
"""

from __future__ import annotations

from torch import nn

from jcfszxc_unet_tpu_torch.ops.blocks import conv_bn_relu_fused
from jcfszxc_unet_tpu_torch.ops.layers import (
    BatchNorm2d,
    Conv2d,
    max_pool2d_with_indices,
    max_unpool2d,
)

# (name, Cin, Cout) of the conv -> BN -> ReLU stages, with None standing
# for input_nbr; "pool" and "unpool" mark the 2x2 pooling steps
# (SegNet.py:23-52, 89-138).
_STAGES = (
    ("11", None, 64), ("12", 64, 64), "pool",
    ("21", 64, 128), ("22", 128, 128), "pool",
    ("31", 128, 256), ("32", 256, 256), ("33", 256, 256), "pool",
    ("41", 256, 512), ("42", 512, 512), ("43", 512, 512), "pool",
    ("51", 512, 512), ("52", 512, 512), ("53", 512, 512), "pool",
    "unpool", ("53d", 512, 512), ("52d", 512, 512), ("51d", 512, 512),
    "unpool", ("43d", 512, 512), ("42d", 512, 512), ("41d", 512, 256),
    "unpool", ("33d", 256, 256), ("32d", 256, 256), ("31d", 256, 128),
    "unpool", ("22d", 128, 128), ("21d", 128, 64),
    "unpool", ("12d", 64, 64),
)


class SegNet(nn.Module):
    def __init__(self, input_nbr: int = 3, label_nbr: int = 1):
        super().__init__()
        self.n_channels = input_nbr
        self.n_classes = label_nbr
        for stage in _STAGES:
            if isinstance(stage, tuple):
                name, cin, cout = stage
                cin = input_nbr if cin is None else cin
                setattr(self, f"conv{name}", Conv2d(cin, cout, 3, padding=1))
                setattr(self, f"bn{name}", BatchNorm2d(cout))
        self.conv11d = Conv2d(64, label_nbr, 3, padding=1)

    def _cbr(self, name, x):
        conv, bn = getattr(self, f"conv{name}"), getattr(self, f"bn{name}")
        if self.training:
            return bn(conv(x)).relu()
        return conv_bn_relu_fused(x, conv, bn)

    def forward(self, x):
        indices = []
        for stage in _STAGES:
            if stage == "pool":
                x, onehot = max_pool2d_with_indices(x)
                indices.append(onehot)
            elif stage == "unpool":
                x = max_unpool2d(x, indices.pop())
            else:
                x = self._cbr(stage[0], x)
        if self.training:
            return self.conv11d(x)
        return conv_bn_relu_fused(x, self.conv11d, relu=False)
