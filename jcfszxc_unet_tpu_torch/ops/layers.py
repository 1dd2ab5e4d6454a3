"""The layers UNet needs, on NCHW tensors held in ``torch.channels_last``.

Counterpart of ``jcfszxc_unet_tpu/ops/layers.py``.  Parameters and
BatchNorm statistics stay float32; the convolutions compute in the
activation's dtype (bf16 by default, f32 on request), as the JAX layers
do with ``dtype=`` and ``param_dtype=float32``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that casts its f32 parameters to the input's dtype."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` that casts its f32 parameters to the input's
    dtype (UNet uses it with kernel 2, stride 2, no padding)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv_transpose2d(
            x, self.weight.to(x.dtype), bias, self.stride, self.padding,
            self.output_padding, self.groups, self.dilation)


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1) with :meth:`folded`."""

    def folded(self):
        """Eval-mode BN as ``y = x * scale + shift`` per channel, in f32:
        scale = gamma * rsqrt(running_var + eps), shift = beta - mean*scale."""
        scale = self.weight.float() * torch.rsqrt(
            self.running_var.float() + self.eps)
        shift = self.bias.float() - self.running_mean.float() * scale
        return scale, shift


def pad_or_crop_to(x, target_h: int, target_w: int):
    """Center-pad to (target_h, target_w), or center-crop where the target
    is smaller: ``F.pad`` with pads [d//2, d - d//2], negative pads crop
    (reference unet_parts.py:65-67)."""
    dh, dw = target_h - x.shape[2], target_w - x.shape[3]
    if dh == 0 and dw == 0:
        return x
    return F.pad(x, [dw // 2, dw - dw // 2, dh // 2, dh - dh // 2])


@torch.no_grad()
def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every conv's parameters with torch's default initialisation
    (kaiming-uniform with a = sqrt(5), bias uniform in +-1/sqrt(fan_in)),
    from ``generator``, so that a seed fixes the model.  BatchNorms get
    gamma 1, beta 0, running mean 0 and var 1."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5),
                                     generator=generator)
            if m.bias is not None:
                fan_in, _ = nn.init._calculate_fan_in_and_fan_out(m.weight)
                bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
                nn.init.uniform_(m.bias, -bound, bound, generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
