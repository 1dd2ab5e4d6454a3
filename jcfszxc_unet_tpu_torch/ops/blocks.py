"""The zoo's blocks, counterparts of the classes of the same role in
``jcfszxc_unet_tpu/ops/blocks.py`` (reference unet_parts.py): UNet's
``DoubleConv``/``Down``/``Up``/``OutConv`` (:17-79), ``ConvBlockBN``
(conv_block, :82-96), ``UpConvBlock`` (up_conv, :99-111),
``RecurrentBlock`` (:114-132), ``RRCNNBlock`` (:135-146),
``AttentionBlock`` (:149-176), ``ResidualConv`` (:454-475),
``UpsampleT`` (Upsample, :478-487), DenseUNet's ``SingleLevelDensenet``
(:346-363), ``down_sample`` (:366) and ``UpsampleNConcat`` (:372-386),
FRUNet's ``FRConv``, ``FeatureFuse``, ``FRUp``, ``FRDown`` and ``FRBlock``
(:495-632), MultiResUNet's ``Conv2dBatchnorm``, ``Multiresblock`` and
``Respath`` (:635-789), BCDU-Net's ``ConvBlockPlain`` (:792),
``ConvLSTM2D`` (:847-900) and ``UpConvT`` (:903), and the attention
family's ``BAModule``, ``BABasicBlock``, ``ChannelAttentionModule``,
``SpatialAttentionModule``, ``CBAM``, ``SEBlock`` (:214-343),
``BasicConv2d``, ``InceptionA``, ``UpV1`` (:389-451) and
``MultiHeadSelfAttention`` (:919-957).

Attribute names follow the reference (``double_conv.0``, ``conv.3``,
``up.1``, ``RCNN.0``, ``W_g.0``, ``conv_block.5``, ``cell.conv``,
``shortcuts.0.conv1``, ``cur_fusion.0``, ``shared_MLP.2``, ``b4_3``,
``mha.in_proj_weight``, ...), so reference-keyed state dicts load with
``strict=True``.  Tensors are NCHW in ``torch.channels_last``.

In eval mode every 3x3 conv with stride 1 and SAME padding runs as one
call of :func:`conv3x3_affine_relu_kmajor`, with the conv's bias and the
BatchNorm after it (if any) folded into a per-channel scale and shift and
the ReLU after it (if any) fused; on a CUDA tensor that is the
hand-written kernel.  1x1 convs, transposed convs, strided convs, a
BatchNorm that comes before its conv, the attention gates' Linears, 1x1
MLPs and 7x7 convs and the self-attention run stock torch ops, as the JAX
package runs them outside Pallas.  The eval-mode forward is for inference:
a backward through the kernel's operator raises.  In train mode the
blocks run stock torch ops.

FRUNet's and MultiResUNet's blocks also run in space-to-depth space
(``ops/s2d.py``), as the JAX blocks' ``s2d``/``s2d_io`` do: the same
parameters applied to the (B, 4C, H/2, W/2) form, where each 3x3 (also
the dilated one) has an s2d 3x3 that goes to the kernel the same way
(:func:`conv_bn_relu_fused_s2d`), BatchNorm runs per original channel
(``BatchNorm2d.s2d``) and Dropout2d drops original channels
(:func:`dropout2d_s2d`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from jcfszxc_unet_tpu_torch.ops.kernels.conv_fused import (
    conv3x3_affine_relu_kmajor,
)
from jcfszxc_unet_tpu_torch.ops.layers import (
    BatchNorm1d,
    BatchNorm2d,
    Conv2d,
    ConvTranspose2d,
    Linear,
    adaptive_avg_pool_1x1,
    adaptive_max_pool_1x1,
    avg_pool2d,
    cat_channels,
    channels_last,
    nhwc,
    pad_or_crop_to,
    upsample_bilinear,
    upsample_nearest,
)
from jcfszxc_unet_tpu_torch.ops.s2d import (
    depth_to_space,
    expand_vector,
    space_to_depth,
)
from jcfszxc_unet_tpu_torch.parallel import spatial


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


def kmajor(conv: Conv2d | torch.Tensor, dtype):
    """(Cout, 3, 3, Cin) weights in ``dtype``, the kernel's layout, of a
    conv or of OIHW weights: one copy at most (none for a channels_last
    f32 weight)."""
    w = conv.weight if isinstance(conv, nn.Module) else conv
    return w.to(dtype).permute(0, 2, 3, 1).contiguous()


def conv3x3_folded(x, w_km, scale, shift, relu: bool):
    """One kernel call on NCHW ``x``; returns NCHW channels_last in
    x.dtype.  On a row-sharded map (``parallel.spatial``) the kernel runs
    on the slab with one halo row on each side, whose SAME padding then
    only touches the two halo output rows, which are dropped."""
    if spatial.active() is not None:
        y = conv3x3_affine_relu_kmajor(nhwc(spatial.halo_slab(x, 1, 1)),
                                       w_km, scale, shift, relu)
        return y[:, 1:-1].permute(0, 3, 1, 2)
    return conv3x3_affine_relu_kmajor(nhwc(x), w_km, scale, shift,
                                      relu).permute(0, 3, 1, 2)


def conv_bn_relu_fused(x, conv: Conv2d, bn: BatchNorm2d | None = None,
                       relu: bool = True):
    """Eval-mode conv3x3 (bias or not) -> optional BN -> optional ReLU as
    one fused call."""
    scale, shift = fold(conv, bn)
    return conv3x3_folded(x, kmajor(conv, x.dtype), scale, shift, relu)


def conv_bn_relu_fused_s2d(x, conv: Conv2d, bn: BatchNorm2d | None = None,
                           relu: bool = True):
    """:func:`conv_bn_relu_fused` in space-to-depth space: ``x`` is the s2d
    form (B, 4 Cin, H/2, W/2) and the conv's s2d kernel is a SAME 3x3
    (from a 3x3, a dilated 3x3 or a 5x5), (4 Cout, 4 Cin, 3, 3); the fold's
    scale and shift repeat 4x.  One kernel call; returns the s2d output."""
    scale, shift = fold(conv, bn)
    return conv3x3_folded(x, kmajor(conv.s2d_weight(x.dtype), x.dtype),
                          expand_vector(scale), expand_vector(shift), relu)


def _same3x3(conv: Conv2d) -> bool:
    return (conv.kernel_size == (3, 3) and conv.stride == (1, 1)
            and conv.padding == (1, 1) and conv.dilation == (1, 1)
            and conv.groups == 1)


def conv_bn_relu(x, conv: Conv2d, bn: nn.Module | None = None,
                 relu: bool = True, s2d: bool = False):
    """Conv -> optional BN -> optional ReLU: one fused call in eval mode
    where the conv is a 3x3 with stride 1 and SAME padding, stock torch
    ops otherwise (train mode, 1x1 and strided convs).  ``s2d``: ``x`` and
    the result are space-to-depth tensors, and a conv with a 3x3 s2d form
    fuses the same way (:func:`conv_bn_relu_fused_s2d`).

    The blocks of the earlier models keep one ``if self.training`` per
    block instead: their train branch is the reference's whole
    ``nn.Sequential`` call, and their eval branch chains fused calls that
    this helper's per-conv test would not shorten."""
    if s2d:
        if not conv.training and conv.kernel_size[0] > 1:
            return conv_bn_relu_fused_s2d(x, conv, bn, relu)
        y = conv.s2d(x)
        if bn is not None:
            y = bn.s2d(y)
        return torch.relu(y) if relu else y
    if not conv.training and _same3x3(conv):
        return conv_bn_relu_fused(x, conv, bn, relu)
    y = conv(x)
    if bn is not None:
        y = bn(y)
    return torch.relu(y) if relu else y


def dropout2d_s2d(drop: nn.Dropout2d, x):
    """``drop`` (Dropout2d) on the s2d form of a map: whole ORIGINAL
    channels drop, their 4 phases together.  Feature dropout of the (B, C,
    4, h, w) view draws a (B, C) mask, the draw the plain Dropout2d makes
    on (B, C, H, W), so one RNG state gives the same mask in both modes;
    Dropout2d on the s2d tensor would drop single phases."""
    b, c4, h, w = x.shape
    y = F.dropout3d(x.view(b, c4 // 4, 4, h, w), drop.p, drop.training)
    return channels_last(y.reshape(b, c4, h, w))


def even_hw(x) -> bool:
    """H and W of NCHW ``x`` both even: a map that has an s2d form."""
    return x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0


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


# DenseUNet's blocks (reference unet_parts.py:346-393).


class SingleLevelDensenet(nn.Module):
    """``num_conv`` steps of Conv3x3 bias -> + every earlier output but its
    own input -> BN -> ReLU, the reference's ``Single_level_densenet``
    (unet_parts.py:346-367): dense *additive* skips.

    Eval mode: the first conv has nothing to add and runs with its BN and
    ReLU fused.  The others add earlier outputs before their BN, so they
    launch with the bias as the shift and ReLU off, and the adds, the BN
    and the ReLU stay stock ops, in the JAX order."""

    def __init__(self, filters: int, num_conv: int = 4):
        super().__init__()
        self.conv_list = nn.ModuleList(
            Conv2d(filters, filters, 3, padding=1) for _ in range(num_conv))
        self.bn_list = nn.ModuleList(
            BatchNorm2d(filters) for _ in range(num_conv))

    def forward(self, x):
        outs = [x]
        for i, (conv, bn) in enumerate(zip(self.conv_list, self.bn_list)):
            if self.training:
                t = conv(outs[i])
            elif i == 0:
                outs.append(conv_bn_relu_fused(x, conv, bn))
                continue
            else:
                t = conv_bn_relu_fused(outs[i], conv, relu=False)
            for j in range(i):
                t = t + outs[j]
            outs.append(torch.relu(bn(t)))
        return outs[-1]


def down_sample(x):
    """2x2 max pool returning (pooled, the map before the pool), the
    reference's ``Down_sample`` (unet_parts.py:370-377; no parameters)."""
    return F.max_pool2d(x, 2), x


class UpsampleNConcat(nn.Module):
    """ConvTranspose(k4, s2, p1) -> cat[x, skip] -> Conv3x3 bias -> BN ->
    ReLU, the reference's ``Upsample_n_Concat`` (unet_parts.py:380-393)."""

    def __init__(self, filters: int):
        super().__init__()
        self.upsample_layer = ConvTranspose2d(filters, filters, 4, stride=2,
                                              padding=1)
        self.conv = Conv2d(2 * filters, filters, 3, padding=1)
        self.bn = BatchNorm2d(filters)

    def forward(self, x, y):
        x = cat_channels(self.upsample_layer(x), y)
        if self.training:
            return torch.relu(self.bn(self.conv(x)))
        return conv_bn_relu_fused(x, self.conv, self.bn)


# FRUNet's blocks (reference unet_parts.py:490-591).


class FRConv(nn.Module):
    """(Conv3x3 no-bias -> BN -> Dropout2d -> LeakyReLU(0.1)) x2, FRUNet's
    ``conv`` (unet_parts.py:490-507).  The reference builds both convs
    out_c -> out_c whatever ``in_c`` is; its callers pass in_c == out_c.

    Eval mode: each conv runs with its BN folded and ReLU off (LeakyReLU is
    not the kernel's and stays a stock op); Dropout2d is the identity.
    ``forward(x, s2d=True)`` takes and returns the s2d form: the same
    convs through their s2d kernels (eval: fused), the BNs per original
    channel and Dropout2d per original channel (:func:`dropout2d_s2d`)."""

    def __init__(self, in_c: int, out_c: int, dp: float = 0.0):
        super().__init__()
        layers = []
        for _ in range(2):
            layers += [Conv2d(out_c, out_c, 3, padding=1, bias=False),
                       BatchNorm2d(out_c), nn.Dropout2d(dp),
                       nn.LeakyReLU(0.1)]
        self.conv = nn.Sequential(*layers)

    def forward(self, x, s2d: bool = False):
        seq = self.conv
        if self.training and not s2d:
            return seq(x)
        for k in (0, 4):
            if not self.training:
                x = conv_bn_relu(x, seq[k], seq[k + 1], relu=False, s2d=s2d)
            else:
                x = dropout2d_s2d(seq[k + 2], seq[k + 1].s2d(seq[k].s2d(x)))
            x = F.leaky_relu(x, 0.1)
        return x


class FeatureFuse(nn.Module):
    """Conv1x1 + Conv3x3 + dilated Conv3x3 (d = 2), all without bias,
    summed -> BN, the reference's ``feature_fuse`` (unet_parts.py:510-525).
    Eval mode: the plain 3x3 runs on the kernel with scale 1, shift 0 and
    ReLU off; the 1x1 and the dilated 3x3 are stock ops.

    ``forward(x, s2d=True)`` takes and returns the s2d form.  There the
    three convs' s2d kernels are all SAME on the same input (the 1x1's a
    1x1, the other two 3x3s), so eval mode sums them (the 1x1 at the 3x3's
    centre tap), in f32, and runs the sum with the BN folded in as one
    kernel call."""

    def __init__(self, in_c: int, out_c: int):
        super().__init__()
        self.conv11 = Conv2d(in_c, out_c, 1, bias=False)
        self.conv33 = Conv2d(in_c, out_c, 3, padding=1, bias=False)
        self.conv33_di = Conv2d(in_c, out_c, 3, padding=2, dilation=2,
                                bias=False)
        self.norm = BatchNorm2d(out_c)

    def s2d_weight(self) -> torch.Tensor:
        """The three convs' s2d kernels summed, (4 out_c, 4 in_c, 3, 3),
        f32."""
        f32 = torch.float32
        return (F.pad(self.conv11.s2d_weight(f32), [1, 1, 1, 1])
                + self.conv33.s2d_weight(f32)
                + self.conv33_di.s2d_weight(f32))

    def forward(self, x, s2d: bool = False):
        if s2d:
            if not self.training:
                scale, shift = self.norm.folded()
                return conv3x3_folded(
                    x, kmajor(self.s2d_weight(), x.dtype),
                    expand_vector(scale), expand_vector(shift), relu=False)
            return self.norm.s2d(self.conv11.s2d(x) + self.conv33.s2d(x)
                                 + self.conv33_di.s2d(x))
        x2 = (self.conv33(x) if self.training
              else conv_bn_relu_fused(x, self.conv33, relu=False))
        return self.norm(self.conv11(x) + x2 + self.conv33_di(x))


class FRUp(nn.Module):
    """ConvTranspose(k2, s2, no bias) -> BN -> LeakyReLU(0.1), FRUNet's
    ``up`` (unet_parts.py:528-541)."""

    def __init__(self, in_c: int, out_c: int):
        super().__init__()
        self.up = nn.Sequential(
            ConvTranspose2d(in_c, out_c, 2, stride=2, bias=False),
            BatchNorm2d(out_c), nn.LeakyReLU(0.1))

    def forward(self, x):
        return self.up(x)


class FRDown(nn.Module):
    """Conv(k2, s2, no bias) -> BN -> LeakyReLU(0.1), FRUNet's ``down``
    (unet_parts.py:544-555)."""

    def __init__(self, in_c: int, out_c: int):
        super().__init__()
        self.down = nn.Sequential(
            Conv2d(in_c, out_c, 2, stride=2, bias=False),
            BatchNorm2d(out_c), nn.LeakyReLU(0.1))

    def forward(self, x):
        return self.down(x)


class FRBlock(nn.Module):
    """FRUNet's grid node, the reference's ``block`` (unet_parts.py:558-591):
    FeatureFuse (only where in_c != out_c) -> FRConv, then the optional up
    and down branches.  Returns x, (x, x_up), (x, x_down) or
    (x, x_up, x_down).

    The reference also builds a ``fuse`` where in_c == out_c that its
    forward never applies; this block, like the JAX one, has none, so its
    state dict lacks those dead keys.

    ``s2d``: FeatureFuse and FRConv run on the input's space-to-depth form
    where its H and W are even (else plain, as the JAX block falls back),
    and the branches take the unpacked output."""

    def __init__(self, in_c: int, out_c: int, dp: float = 0.0,
                 is_up: bool = False, is_down: bool = False,
                 s2d: bool = False):
        super().__init__()
        self.s2d = s2d
        self.fuse = FeatureFuse(in_c, out_c) if in_c != out_c else None
        self.conv = FRConv(out_c, out_c, dp)
        self.up = FRUp(out_c, out_c // 2) if is_up else None
        self.down = FRDown(out_c, out_c * 2) if is_down else None

    def forward(self, x):
        use_s2d = self.s2d and even_hw(x)
        if use_s2d:
            x = space_to_depth(x)
        if self.fuse is not None:
            x = self.fuse(x, s2d=use_s2d)
        x = self.conv(x, s2d=use_s2d)
        if use_s2d:
            x = depth_to_space(x)
        branches = [b(x) for b in (self.up, self.down) if b is not None]
        return (x, *branches) if branches else x


# MultiResUNet's blocks (reference unet_parts.py:617-791).


class Conv2dBatchnorm(nn.Module):
    """Conv ("same" padding, bias) -> BN -> optional ReLU, the reference's
    ``Conv2d_batchnorm`` (unet_parts.py:617-656).  The conv is built with
    integer padding (k // 2), which holds the same state dict as
    ``padding="same"`` and which the fused path recognises.  Eval mode: a
    3x3 runs as one kernel call with its BN folded and its ReLU fused.
    ``forward(x, s2d=True)``: the same on space-to-depth input and output
    (a 3x3 through its s2d kernel, still one call in eval mode; a 1x1 as a
    stock 1x1 conv on 4x the channels)."""

    def __init__(self, num_in_filters: int, num_out_filters: int,
                 kernel_size: int, activation: str = "relu"):
        super().__init__()
        self.relu = activation == "relu"
        self.conv1 = Conv2d(num_in_filters, num_out_filters, kernel_size,
                            padding=kernel_size // 2)
        self.batchnorm = BatchNorm2d(num_out_filters)

    def forward(self, x, s2d: bool = False):
        return conv_bn_relu(x, self.conv1, self.batchnorm, self.relu, s2d)


class Multiresblock(nn.Module):
    """Three chained 3x3 Conv2dBatchnorms (3x3, 5x5 and 7x7 receptive
    fields), their concat -> BN, + a 1x1 shortcut -> BN -> ReLU, the
    reference's ``Multiresblock`` (unet_parts.py:659-715).  Widths use the
    reference's int() truncation of ``num_filters * alpha * {0.167, 0.333,
    0.5}``.

    ``forward(x, s2d_io=True)``: space-to-depth execution, the JAX block's
    persistent form, whose input and output are s2d tensors (the model
    owns the transforms).  The concat needs no change: in the c-major
    layout it is the s2d form of the plain concat."""

    def __init__(self, num_in_channels: int, num_filters: int,
                 alpha: float = 1.67):
        super().__init__()
        w = num_filters * alpha
        f3, f5, f7 = int(w * 0.167), int(w * 0.333), int(w * 0.5)
        out_f = f3 + f5 + f7
        self.shortcut = Conv2dBatchnorm(num_in_channels, out_f, 1,
                                        activation="None")
        self.conv_3x3 = Conv2dBatchnorm(num_in_channels, f3, 3)
        self.conv_5x5 = Conv2dBatchnorm(f3, f5, 3)
        self.conv_7x7 = Conv2dBatchnorm(f5, f7, 3)
        self.batch_norm1 = BatchNorm2d(out_f)
        self.batch_norm2 = BatchNorm2d(out_f)

    def forward(self, x, s2d_io: bool = False):
        shortcut = self.shortcut(x, s2d_io)
        a = self.conv_3x3(x, s2d_io)
        b = self.conv_5x5(a, s2d_io)
        c = self.conv_7x7(b, s2d_io)
        bn1, bn2 = ((self.batch_norm1.s2d, self.batch_norm2.s2d) if s2d_io
                    else (self.batch_norm1, self.batch_norm2))
        return torch.relu(bn2(bn1(cat_channels(a, b, c)) + shortcut))


class Respath(nn.Module):
    """A chain of ``respath_length`` residual units along a skip, the
    reference's ``Respath`` (unet_parts.py:718-791): per unit a 1x1
    shortcut, a 3x3 Conv2dBatchnorm, then the unit's one BN applied twice,
    relu(bn(x)) and relu(bn(x + shortcut)), as the reference does.  In
    train mode that BN updates its running statistics twice per unit.
    ``forward(x, s2d_io=True)`` as for :class:`Multiresblock`: the whole
    chain stays in s2d space."""

    def __init__(self, num_in_filters: int, num_out_filters: int,
                 respath_length: int):
        super().__init__()
        ins = [num_in_filters] + [num_out_filters] * (respath_length - 1)
        self.shortcuts = nn.ModuleList(
            Conv2dBatchnorm(c, num_out_filters, 1, activation="None")
            for c in ins)
        self.convs = nn.ModuleList(
            Conv2dBatchnorm(c, num_out_filters, 3) for c in ins)
        self.bns = nn.ModuleList(BatchNorm2d(num_out_filters) for _ in ins)

    def forward(self, x, s2d_io: bool = False):
        for shortcut, conv, bn in zip(self.shortcuts, self.convs, self.bns):
            norm = bn.s2d if s2d_io else bn
            s = shortcut(x, s2d_io)
            x = torch.relu(norm(conv(x, s2d_io)))
            x = torch.relu(norm(x + s))
        return x


# BCDU-Net's blocks (reference unet_parts.py:794-885).


class ConvBlockPlain(nn.Module):
    """(Conv3x3 bias -> ReLU) x2 without BN, BCDU-Net's ``ConvBlock``
    (unet_parts.py:794-806).  Eval mode: two kernel calls, each bias as the
    shift, ReLU fused."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Sequential(
            Conv2d(in_channels, out_channels, 3, padding=1),
            nn.ReLU(inplace=True),
            Conv2d(out_channels, out_channels, 3, padding=1),
            nn.ReLU(inplace=True),
        )

    def forward(self, x):
        if self.training:
            return self.conv(x)
        return conv_bn_relu_fused(conv_bn_relu_fused(x, self.conv[0]),
                                  self.conv[2])


class _ConvLSTMCell(nn.Module):
    """Holds the cell's one conv, (4 * hidden, input + hidden, 3, 3), as
    the reference's ``ConvLSTM2DCell`` does (key ``cell.conv``)."""

    def __init__(self, input_dim: int, hidden_dim: int):
        super().__init__()
        self.conv = Conv2d(input_dim + hidden_dim, 4 * hidden_dim, 3,
                           padding=1)


class ConvLSTM2D(nn.Module):
    """ConvLSTM over a sequence of NCHW maps, returning the last hidden
    state, the reference's ``ConvLSTM2D`` (unet_parts.py:809-869): one conv
    of [x, h] to the gates i, f, o, g; zero initial state;
    ``go_backwards`` runs the sequence from its last step to its first.

    As in the JAX block, conv([x, h], W) is split along the input axis
    into conv(x, W[:, :input_dim]) + bias + conv(h, W[:, input_dim:]): the
    x-half of every step runs as one call on the steps stacked on the
    batch, and the first step's h-half, whose h is exactly zero, is
    skipped.  Eval mode: both halves run on the kernel, each folded and
    re-laid once per call, the x-half with the bias as the shift, the
    h-half with shift 0, ReLU off; the gate nonlinearities are stock."""

    def __init__(self, input_dim: int, hidden_dim: int,
                 go_backwards: bool = False):
        super().__init__()
        self.input_dim = input_dim
        self.go_backwards = go_backwards
        self.cell = _ConvLSTMCell(input_dim, hidden_dim)

    def forward(self, *steps):
        if self.go_backwards:
            steps = steps[::-1]
        conv, n = self.cell.conv, self.input_dim
        w_x, w_h = conv.weight[:, :n], conv.weight[:, n:]
        xs = channels_last(torch.cat(steps, dim=0))
        if self.training:
            dt = xs.dtype
            gates_x = F.conv2d(xs, w_x.to(dt), conv.bias.to(dt), padding=1)

            def gates_h(h):
                return F.conv2d(h, w_h.to(dt), padding=1)
        else:
            scale, shift = fold(conv)
            wx_km, wh_km = kmajor(w_x, xs.dtype), kmajor(w_h, xs.dtype)
            gates_x = conv3x3_folded(xs, wx_km, scale, shift, relu=False)
            zero = torch.zeros_like(shift)

            def gates_h(h):
                return conv3x3_folded(h, wh_km, scale, zero, relu=False)
        for k, gates in enumerate(gates_x.chunk(len(steps))):
            if k:
                gates = gates + gates_h(hidden)
            i, f, o, g = gates.chunk(4, dim=1)
            i, f, o, g = (torch.sigmoid(i), torch.sigmoid(f),
                          torch.sigmoid(o), torch.tanh(g))
            cell = f * cell + i * g if k else i * g
            hidden = o * torch.tanh(cell)
        return channels_last(hidden)


class UpConvT(nn.Module):
    """ConvTranspose(k2, s2) -> BN -> ReLU, BCDU-Net's ``UpConv``
    (unet_parts.py:872-885)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.up = nn.Sequential(
            ConvTranspose2d(in_channels, out_channels, 2, stride=2),
            BatchNorm2d(out_channels), nn.ReLU(inplace=True))

    def forward(self, x):
        return self.up(x)


# The attention family's blocks: BARUNet's and BIARUNet's (reference
# unet_parts.py:188-343), MCUNet's (:396-451) and TransFuseNet's attention
# (RetinaLiteNet.py:72-80).


class BAModule(nn.Module):
    """Bridge attention, the reference's ``BA_module_resnet``
    (unet_parts.py:188-224, reduction 16): each GAP-pooled input
    (N, C, 1, 1) through Linear (no bias) -> BatchNorm1d, summed, then ReLU -> Linear (no bias)
    -> sigmoid; returns the channel gate (N, C, 1, 1).  Stock ops."""

    def __init__(self, pre_channels, cur_channel: int):
        super().__init__()
        red = cur_channel // 16

        def fusion(c):
            return nn.Sequential(Linear(c, red, bias=False), BatchNorm1d(red))

        self.cur_fusion = fusion(cur_channel)
        self.pre_fusions = nn.ModuleList(fusion(c) for c in pre_channels)
        self.generation = nn.Sequential(nn.ReLU(),
                                        Linear(red, cur_channel, bias=False))

    def forward(self, pre_layers, cur_layer):
        fused = self.cur_fusion(cur_layer.flatten(1))
        for fuse, pre in zip(self.pre_fusions, pre_layers):
            fused = fused + fuse(pre.flatten(1))
        w = torch.sigmoid(self.generation(fused))
        return w[:, :, None, None]


class BABasicBlock(nn.Module):
    """Conv3x3 -> BN -> ReLU -> Conv3x3 -> BN, gated by a BAModule over the
    two convs' pooled outputs, + a 1x1 conv residual with Dropout(0.5) ->
    ReLU, the reference's ``BABasicBlock`` (unet_parts.py:227-275).

    Stride 1, the only one the models use.  Eval mode: two kernel calls,
    the first with its BN and ReLU, the second with its BN and ReLU off
    (the gate and the residual add come after it)."""

    def __init__(self, ch_in: int, ch_out: int):
        super().__init__()
        self.conv1 = Conv2d(ch_in, ch_out, 3, padding=1, bias=False)
        self.bn1 = BatchNorm2d(ch_out)
        self.conv2 = Conv2d(ch_out, ch_out, 3, padding=1, bias=False)
        self.bn2 = BatchNorm2d(ch_out)
        self.ba = BAModule((ch_out,), ch_out)
        self.conv3 = Conv2d(ch_in, ch_out, 1, bias=False)
        self.dropout = nn.Dropout(0.5)

    def forward(self, x):
        out = conv_bn_relu(x, self.conv1, self.bn1)
        f1 = adaptive_avg_pool_1x1(out)
        out = conv_bn_relu(out, self.conv2, self.bn2, relu=False)
        att = self.ba([f1], adaptive_avg_pool_1x1(out))
        residual = self.dropout(self.conv3(x))
        return channels_last(torch.relu(out * att + residual))


def channel_mlp(channel: int):
    """CBAM's shared MLP, ratio 16: Conv1x1 (no bias) -> ReLU -> Conv1x1
    (no bias)."""
    return nn.Sequential(Conv2d(channel, channel // 16, 1, bias=False),
                         nn.ReLU(),
                         Conv2d(channel // 16, channel, 1, bias=False))


def channel_attention(mlp, x):
    """sigmoid(mlp(avg-pool x) + mlp(max-pool x)), (N, C, 1, 1)."""
    return torch.sigmoid(mlp(adaptive_avg_pool_1x1(x))
                         + mlp(adaptive_max_pool_1x1(x)))


def spatial_attention(conv, x):
    """sigmoid(conv([mean over C, max over C])), (N, 1, H, W)."""
    y = torch.cat([x.mean(dim=1, keepdim=True), x.amax(dim=1, keepdim=True)],
                  dim=1)
    return torch.sigmoid(conv(y))


class ChannelAttentionModule(nn.Module):
    """The reference's ``ChannelAttentionModule`` (unet_parts.py:278-294,
    ratio 16)."""

    def __init__(self, channel: int):
        super().__init__()
        self.shared_MLP = channel_mlp(channel)

    def forward(self, x):
        return channel_attention(self.shared_MLP, x)


class SpatialAttentionModule(nn.Module):
    """The reference's ``SpatialAttentionModule`` (unet_parts.py:297-310):
    a 7x7 conv, with a bias."""

    def __init__(self):
        super().__init__()
        self.conv2d = Conv2d(2, 1, 7, padding=3)

    def forward(self, x):
        return spatial_attention(self.conv2d, x)


class CBAM(nn.Module):
    """Channel attention times x, then spatial attention times that, the
    reference's ``CBAM`` (unet_parts.py:313-322).  Stock ops in both
    modes."""

    def __init__(self, channel: int):
        super().__init__()
        self.channel_attention = ChannelAttentionModule(channel)
        self.spatial_attention = SpatialAttentionModule()

    def forward(self, x):
        out = self.channel_attention(x) * x
        return channels_last(self.spatial_attention(out) * out)


class SEBlock(nn.Module):
    """GAP -> Linear down (ratio 16) -> ReLU -> Linear up -> sigmoid,
    scaling x per channel, the reference's ``se_block``
    (unet_parts.py:325-343)."""

    def __init__(self, channel: int):
        super().__init__()
        self.fc = nn.Sequential(
            Linear(channel, channel // 16, bias=False), nn.ReLU(),
            Linear(channel // 16, channel, bias=False), nn.Sigmoid())

    def forward(self, x):
        y = self.fc(spatial.row_mean(x, (2, 3)))
        return channels_last(x * y[:, :, None, None])


class BasicConv2d(nn.Module):
    """torchvision's ``BasicConv2d``: Conv (no bias) -> BN (eps 1e-3) ->
    ReLU, InceptionA's unit (unet_parts.py:396-422).  Eval mode: a 3x3 runs
    as one kernel call, its BN folded with its own eps."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 padding: int = 0):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel_size,
                           padding=padding, bias=False)
        self.bn = BatchNorm2d(out_channels, eps=1e-3)

    def forward(self, x):
        return conv_bn_relu(x, self.conv, self.bn)


class InceptionA(nn.Module):
    """Four branches concatenated to 32 + 32 + 64 + 128 = 256 channels at
    the input's resolution (reference unet_parts.py:396-422): avg-pool 3x3
    -> 1x1; 1x1; 1x1 -> 3x3; 1x1 -> 3x3 -> 3x3."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.b1_2 = BasicConv2d(in_channels, 32, 1)
        self.b2 = BasicConv2d(in_channels, 32, 1)
        self.b3_1 = BasicConv2d(in_channels, 32, 1)
        self.b3_2 = BasicConv2d(32, 64, 3, padding=1)
        self.b4_1 = BasicConv2d(in_channels, 32, 1)
        self.b4_2 = BasicConv2d(32, 64, 3, padding=1)
        self.b4_3 = BasicConv2d(64, 128, 3, padding=1)

    def forward(self, x):
        return cat_channels(self.b1_2(avg_pool2d(x, 3, 1, 1)), self.b2(x),
                            self.b3_2(self.b3_1(x)),
                            self.b4_3(self.b4_2(self.b4_1(x))))


class UpV1(nn.Module):
    """Bilinear (align corners) x2, or ConvTranspose(k2, s2) -> pad or crop
    to the skip -> cat[skip, x] -> DoubleConv, the reference's ``Up_v1``
    (unet_parts.py:425-451).  Behind MCUNet's InceptionA, which keeps the
    resolution, the "pad" is negative: a center crop."""

    def __init__(self, in_channels: int, out_channels: int,
                 bilinear: bool = True):
        super().__init__()
        if bilinear:
            self.up = nn.Upsample(scale_factor=2, mode="bilinear",
                                  align_corners=True)
            self.conv = DoubleConv(in_channels, out_channels,
                                   in_channels // 2)
        else:
            self.up = ConvTranspose2d(in_channels, in_channels // 2, 2,
                                      stride=2)
            self.conv = DoubleConv(in_channels, out_channels)

    def forward(self, x1, x2):
        # the module's own interpolation, as ``upsample_bilinear`` (which
        # also takes a row-sharded map)
        x1 = (upsample_bilinear(x1) if isinstance(self.up, nn.Upsample)
              else self.up(x1))
        x1 = pad_or_crop_to(x1, x2.shape[2], x2.shape[3])
        # a crop is a view in another layout: the concat brings it back
        return self.conv(cat_channels(x2, x1))


class MultiHeadSelfAttention(nn.Module):
    """Self-attention of ``torch.nn.MultiheadAttention(batch_first=True)``
    on (B, L, E), held as ``mha`` (reference RetinaLiteNet.py:72-80, key
    ``mha.in_proj_weight`` ...).  The forward runs its projections in the
    input's dtype and the attention through ``F.scaled_dot_product_attention``,
    which never holds the L x L scores (the JAX block's two einsums do).
    On a row-sharded map's tokens (row-major, so a rank's are one
    contiguous stretch) the local queries attend to every rank's keys
    and values, which ``parallel.spatial.gather_h`` brings."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.mha = nn.MultiheadAttention(embed_dim, num_heads,
                                         batch_first=True)

    def forward(self, x):
        b, n, e = x.shape
        mha, dt = self.mha, x.dtype
        qkv = F.linear(x, mha.in_proj_weight.to(dt), mha.in_proj_bias.to(dt))
        q, k, v = (t.view(b, n, self.num_heads, -1).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        if spatial.active() is not None:
            k, v = spatial.gather_h(torch.stack([k, v]), dim=3).unbind(0)
        out = F.scaled_dot_product_attention(q, k, v)
        out = out.transpose(1, 2).reshape(b, n, e)
        return F.linear(out, mha.out_proj.weight.to(dt),
                        mha.out_proj.bias.to(dt))
