"""The zoo's blocks, counterparts of the classes of the same role in
``jcfszxc_unet_tpu/ops/blocks.py`` (reference unet_parts.py): UNet's
``DoubleConv``/``Down``/``Up``/``OutConv`` (:17-79), ``ConvBlockBN``
(conv_block, :82-96), ``UpConvBlock`` (up_conv, :99-111),
``RecurrentBlock`` (:114-132), ``RRCNNBlock`` (:135-146),
``AttentionBlock`` (:149-176), ``ResidualConv`` (:454-475) and
``UpsampleT`` (Upsample, :478-487).

Attribute names follow the reference (``double_conv.0``, ``conv.3``,
``up.1``, ``RCNN.0``, ``W_g.0``, ``conv_block.5``, ...), so reference-keyed
state dicts load with ``strict=True``.  Tensors are NCHW in
``torch.channels_last``.

In eval mode every 3x3 conv with stride 1 and SAME padding runs as one
call of :func:`conv3x3_affine_relu_kmajor`, with the conv's bias and the
BatchNorm after it (if any) folded into a per-channel scale and shift and
the ReLU after it (if any) fused; on a CUDA tensor that is the
hand-written kernel.  1x1 convs, transposed convs, strided convs and a
BatchNorm that comes before its conv run stock torch ops, as the JAX
package runs them outside Pallas.  The eval-mode forward is for inference:
no gradient flows through the kernel.  In train mode the blocks run stock
torch ops.
"""

from __future__ import annotations

import torch
from torch import nn

from jcfszxc_unet_tpu_torch.ops.kernels.conv_fused import (
    conv3x3_affine_relu_kmajor,
)
from jcfszxc_unet_tpu_torch.ops.layers import (
    BatchNorm2d,
    Conv2d,
    ConvTranspose2d,
    cat_channels,
    channels_last,
    nhwc,
    pad_or_crop_to,
    upsample_nearest,
)


def fold(conv: Conv2d, bn: BatchNorm2d | None = None):
    """Eval-mode conv bias -> BN as f32 (scale, shift) per output channel:
    ``shift = beta - mean*scale + bias*scale``; without a BN, scale 1 and
    the bias (or 0) as the shift."""
    if bn is None:
        cout = conv.out_channels
        scale = torch.ones(cout, device=conv.weight.device)
        shift = (torch.zeros(cout, device=conv.weight.device)
                 if conv.bias is None else conv.bias.float())
        return scale, shift
    scale, shift = bn.folded()
    if conv.bias is not None:
        shift = shift + conv.bias.float() * scale
    return scale, shift


def kmajor(conv: Conv2d, dtype):
    """(Cout, 3, 3, Cin) weights in ``dtype``, the kernel's layout: one
    copy at most (none for a channels_last f32 weight)."""
    return conv.weight.to(dtype).permute(0, 2, 3, 1).contiguous()


def conv3x3_folded(x, w_km, scale, shift, relu: bool):
    """One kernel call on NCHW ``x``; returns NCHW channels_last in
    x.dtype."""
    return conv3x3_affine_relu_kmajor(nhwc(x), w_km, scale, shift,
                                      relu).permute(0, 3, 1, 2)


def conv_bn_relu_fused(x, conv: Conv2d, bn: BatchNorm2d | None = None,
                       relu: bool = True):
    """Eval-mode conv3x3 (bias or not) -> optional BN -> optional ReLU as
    one fused call."""
    scale, shift = fold(conv, bn)
    return conv3x3_folded(x, kmajor(conv, x.dtype), scale, shift, relu)


def _same3x3(conv: Conv2d) -> bool:
    return (conv.kernel_size == (3, 3) and conv.stride == (1, 1)
            and conv.padding == (1, 1) and conv.dilation == (1, 1)
            and conv.groups == 1)


class DoubleConv(nn.Module):
    """(Conv3x3 no-bias -> BN -> ReLU) x2.  Reference unet_parts.py:17-34."""

    def __init__(self, in_channels: int, out_channels: int,
                 mid_channels: int | None = None):
        super().__init__()
        mid = mid_channels or out_channels
        self.double_conv = nn.Sequential(
            Conv2d(in_channels, mid, 3, padding=1, bias=False),
            BatchNorm2d(mid),
            nn.ReLU(inplace=True),
            Conv2d(mid, out_channels, 3, padding=1, bias=False),
            BatchNorm2d(out_channels),
            nn.ReLU(inplace=True),
        )

    def forward(self, x):
        if self.training:
            return self.double_conv(x)
        seq = self.double_conv
        x = conv_bn_relu_fused(x, seq[0], seq[1])
        return conv_bn_relu_fused(x, seq[3], seq[4])


class Down(nn.Module):
    """MaxPool2 -> DoubleConv.  Reference unet_parts.py:37-47."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.maxpool_conv = nn.Sequential(
            nn.MaxPool2d(2), DoubleConv(in_channels, out_channels))

    def forward(self, x):
        return self.maxpool_conv(x)


class Up(nn.Module):
    """ConvTranspose(k2, s2, C -> C/2) -> pad-to-skip -> cat[skip, x] ->
    DoubleConv.  Reference unet_parts.py:50-70."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.up = ConvTranspose2d(in_channels, in_channels // 2, 2, stride=2)
        self.conv = DoubleConv(in_channels, out_channels)

    def forward(self, x1, x2):
        x1 = pad_or_crop_to(self.up(x1), x2.shape[2], x2.shape[3])
        # No copy when both inputs are channels_last (the 2^k patches of
        # tiled evaluation); a padded x1 may come back in another layout.
        return self.conv(cat_channels(x2, x1))


class OutConv(nn.Module):
    """Conv1x1 head.  Reference unet_parts.py:73-79."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, 1)

    def forward(self, x):
        return self.conv(x)


class ConvBlockBN(nn.Module):
    """(Conv3x3 bias -> BN -> ReLU) x2, the reference's ``conv_block``
    (unet_parts.py:82-96)."""

    def __init__(self, ch_in: int, ch_out: int):
        super().__init__()
        self.conv = nn.Sequential(
            Conv2d(ch_in, ch_out, 3, padding=1),
            BatchNorm2d(ch_out),
            nn.ReLU(inplace=True),
            Conv2d(ch_out, ch_out, 3, padding=1),
            BatchNorm2d(ch_out),
            nn.ReLU(inplace=True),
        )

    def forward(self, x):
        if self.training:
            return self.conv(x)
        seq = self.conv
        x = conv_bn_relu_fused(x, seq[0], seq[1])
        return conv_bn_relu_fused(x, seq[3], seq[4])


class UpConvBlock(nn.Module):
    """Nearest-upsample x2 -> Conv3x3 bias -> BN -> ReLU, the reference's
    ``up_conv`` (unet_parts.py:99-111)."""

    def __init__(self, ch_in: int, ch_out: int):
        super().__init__()
        self.up = nn.Sequential(
            nn.Upsample(scale_factor=2),
            Conv2d(ch_in, ch_out, 3, padding=1),
            BatchNorm2d(ch_out),
            nn.ReLU(inplace=True),
        )

    def forward(self, x):
        if self.training:
            return self.up(x)
        return conv_bn_relu_fused(upsample_nearest(x), self.up[1], self.up[2])


class RecurrentBlock(nn.Module):
    """Shared Conv3x3 bias -> BN -> ReLU applied t+1 times: once on x,
    then t times on x + the last output, the reference's
    ``Recurrent_block`` (unet_parts.py:114-132).  In train mode the shared
    BN updates its running statistics on each of the t+1 calls."""

    def __init__(self, ch_out: int, t: int = 2):
        super().__init__()
        self.t = t
        self.conv = nn.Sequential(
            Conv2d(ch_out, ch_out, 3, padding=1),
            BatchNorm2d(ch_out),
            nn.ReLU(inplace=True),
        )

    def forward(self, x):
        if self.training:
            f = self.conv
        else:
            # one fold and one weight re-layout for the t+1 launches
            scale, shift = fold(self.conv[0], self.conv[1])
            w_km = kmajor(self.conv[0], x.dtype)

            def f(v):
                return conv3x3_folded(v, w_km, scale, shift, relu=True)
        x1 = f(x)
        for _ in range(self.t):
            x1 = f(x + x1)
        return x1


class RRCNNBlock(nn.Module):
    """Conv1x1 -> 2 RecurrentBlocks -> residual add, the reference's
    ``RRCNN_block`` (unet_parts.py:135-146)."""

    def __init__(self, ch_in: int, ch_out: int, t: int = 2):
        super().__init__()
        self.RCNN = nn.Sequential(RecurrentBlock(ch_out, t),
                                  RecurrentBlock(ch_out, t))
        self.Conv_1x1 = Conv2d(ch_in, ch_out, 1)

    def forward(self, x):
        x = channels_last(self.Conv_1x1(x))
        return x + self.RCNN(x)


class AttentionBlock(nn.Module):
    """Additive attention gate, the reference's ``Attention_block``
    (unet_parts.py:149-176): psi = sigmoid(BN(Conv1x1(ReLU(BN(W_g g) +
    BN(W_x x))))); returns x * psi.  1x1 convs: stock ops in both modes."""

    def __init__(self, F_g: int, F_l: int, F_int: int):
        super().__init__()
        self.W_g = nn.Sequential(Conv2d(F_g, F_int, 1), BatchNorm2d(F_int))
        self.W_x = nn.Sequential(Conv2d(F_l, F_int, 1), BatchNorm2d(F_int))
        self.psi = nn.Sequential(Conv2d(F_int, 1, 1), BatchNorm2d(1),
                                 nn.Sigmoid())

    def forward(self, g, x):
        psi = self.psi(torch.relu(self.W_g(g) + self.W_x(x)))
        return channels_last(x * psi)


class ResidualConv(nn.Module):
    """Pre-activation residual unit, the reference's ``ResidualConv``
    (unet_parts.py:454-475): BN -> ReLU -> Conv3x3(stride) -> BN -> ReLU ->
    Conv3x3, plus a Conv3x3(stride) -> BN skip.

    Eval mode at stride 1: three kernel calls (conv_block.2 with its BN
    and ReLU, conv_block.5 with its bias as the shift, conv_skip with its
    BN).  At stride 2 only conv_block.5 goes to the kernel.  The leading
    BN -> ReLU is applied before its conv and stays a stock op."""

    def __init__(self, input_dim: int, output_dim: int, stride: int,
                 padding: int):
        super().__init__()
        self.conv_block = nn.Sequential(
            BatchNorm2d(input_dim),
            nn.ReLU(),
            Conv2d(input_dim, output_dim, 3, stride=stride, padding=padding),
            BatchNorm2d(output_dim),
            nn.ReLU(),
            Conv2d(output_dim, output_dim, 3, padding=1),
        )
        self.conv_skip = nn.Sequential(
            Conv2d(input_dim, output_dim, 3, stride=stride, padding=1),
            BatchNorm2d(output_dim),
        )

    def forward(self, x):
        if self.training:
            return self.conv_block(x) + self.conv_skip(x)
        cb, sk = self.conv_block, self.conv_skip
        h = torch.relu(cb[0](x))
        if _same3x3(cb[2]):
            h = conv_bn_relu_fused(h, cb[2], cb[3])
        else:
            h = torch.relu(cb[3](cb[2](h)))
        h = conv_bn_relu_fused(h, cb[5], relu=False)
        if _same3x3(sk[0]):
            s = conv_bn_relu_fused(x, sk[0], sk[1], relu=False)
        else:
            s = sk(x)
        return channels_last(h + s)


class UpsampleT(nn.Module):
    """Bare ConvTranspose2d(kernel, stride), the reference's ``Upsample``
    (unet_parts.py:478-487, ResUNet's decoder)."""

    def __init__(self, input_dim: int, output_dim: int, kernel: int,
                 stride: int):
        super().__init__()
        self.upsample = ConvTranspose2d(input_dim, output_dim, kernel,
                                        stride=stride)

    def forward(self, x):
        return self.upsample(x)
