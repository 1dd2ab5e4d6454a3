"""TransFuseNet (reference UNetFamily/RetinaLiteNet.py:83-203), counterpart
of ``jcfszxc_unet_tpu/models/RetinaLiteNet.py``: three conv blocks (8, 16,
32 channels; conv -> ReLU -> max-pool -> BN), a 4-head self-attention over
the bottom map's pixels whose output is mean-pooled over the tokens and
broadcast back, the reference's private CBAM copies, and a decoder of
transposed convs and biased convs without BatchNorm.  Sigmoid out; with
``logit_head=True`` (the train CLI's ``--logit-head``) the head before
it.

The reference's ``output_OD`` head is built but never returned
(RetinaLiteNet.py:194-197); its parameters are kept, and the forward
does not compute it.

Takes and returns NCHW tensors in ``torch.channels_last``.  In eval mode
its 6 3x3 convs go through the fused conv kernel, each with its bias as
the shift and its ReLU fused (the encoder's BN comes after the pool and
stays stock); the attention runs ``F.scaled_dot_product_attention``.
"""

from __future__ import annotations

import torch
from torch import nn

from jcfszxc_unet_tpu_torch.ops.blocks import (
    MultiHeadSelfAttention,
    channel_attention,
    channel_mlp,
    conv_bn_relu,
    spatial_attention,
)
from jcfszxc_unet_tpu_torch.ops.layers import (
    BatchNorm2d,
    Conv2d,
    ConvTranspose2d,
    cat_channels,
    channels_last,
)
from jcfszxc_unet_tpu_torch.parallel import spatial


class _ChannelAtt(nn.Module):
    def __init__(self, channel: int):
        super().__init__()
        self.shared_mlp = channel_mlp(channel)

    def forward(self, x):
        return channel_attention(self.shared_mlp, x)


class _SpatialAtt(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = Conv2d(2, 1, 7, padding=3, bias=False)

    def forward(self, x):
        return spatial_attention(self.conv, x)


class _PrivateCBAM(nn.Module):
    """RetinaLiteNet's own CBAM (RetinaLiteNet.py:16-68): the shared one's
    math under the keys ``channel_att.shared_mlp.*`` and
    ``spatial_att.conv``, whose 7x7 conv has no bias."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.channel_att = _ChannelAtt(in_channels)
        self.spatial_att = _SpatialAtt()

    def forward(self, x):
        x = x * self.channel_att(x)
        return channels_last(x * self.spatial_att(x))


def _conv_block(cin, cout):
    return nn.Sequential(Conv2d(cin, cout, 3, padding=1),
                         nn.ReLU(inplace=True), nn.MaxPool2d(2),
                         BatchNorm2d(cout))


def _up(cin, cout):
    return ConvTranspose2d(cin, cout, 3, stride=2, padding=1,
                           output_padding=1)


class TransFuseNet(nn.Module):
    def __init__(self, input_channels: int = 3, logit_head: bool = False):
        super().__init__()
        self.n_channels = input_channels
        self.n_classes = 1
        self.logit_head = logit_head
        self.conv_block1 = _conv_block(input_channels, 8)
        self.conv_block2 = _conv_block(8, 16)
        self.conv_block3 = _conv_block(16, 32)
        self.multihead_attention = MultiHeadSelfAttention(32, 4)
        self.cbam1 = _PrivateCBAM(32)
        self.decoder_block1 = nn.Sequential(_up(64, 32), nn.ReLU(inplace=True))
        self.cbam2 = _PrivateCBAM(32)
        self.decoder_conv1 = nn.Sequential(Conv2d(48, 32, 3, padding=1),
                                           nn.ReLU(inplace=True))
        self.decoder_block2 = nn.Sequential(_up(32, 16), nn.ReLU(inplace=True))
        self.cbam3 = _PrivateCBAM(16)
        self.decoder_conv2 = nn.Sequential(Conv2d(24, 16, 3, padding=1),
                                           nn.ReLU(inplace=True))
        self.decoder_block3 = nn.Sequential(
            _up(16, 8), nn.ReLU(inplace=True), Conv2d(8, 8, 3, padding=1),
            nn.ReLU(inplace=True))
        self.output_BV = Conv2d(8, 1, 1)
        self.output_OD = Conv2d(8, 1, 1)

    def forward(self, x):
        skips = []
        for block in (self.conv_block1, self.conv_block2, self.conv_block3):
            x = block[3](block[2](conv_bn_relu(x, block[0])))
            skips.append(x)
        conv1, conv2, conv3 = skips
        b, c, h, w = conv3.shape
        tokens = conv3.permute(0, 2, 3, 1).reshape(b, h * w, c)
        pooled = spatial.row_mean(self.multihead_attention(tokens), (1,))
        att1 = self.cbam1(pooled[:, :, None, None].expand(b, c, h, w))
        d = cat_channels(conv3, att1)
        for up, cbam, conv, skip in (
                (self.decoder_block1[0], self.cbam2, self.decoder_conv1[0],
                 conv2),
                (self.decoder_block2[0], self.cbam3, self.decoder_conv2[0],
                 conv1)):
            d = cat_channels(cbam(torch.relu(up(d))), skip)
            d = conv_bn_relu(d, conv)
        d = torch.relu(self.decoder_block3[0](d))
        d = conv_bn_relu(channels_last(d), self.decoder_block3[2])
        bv = self.output_BV(d)
        return bv if self.logit_head else torch.sigmoid(bv)


def create_transfuse_net(input_shape):
    """Reference RetinaLiteNet.py:201-203: a (C, H, W) tuple gives C input
    channels, anything else 3."""
    input_channels = input_shape[0] if isinstance(input_shape, tuple) else 3
    return TransFuseNet(input_channels=input_channels)
