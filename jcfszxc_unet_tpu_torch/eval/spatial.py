"""Whole-image evaluation on one device, counterpart of
``jcfszxc_unet_tpu/parallel/spatial.py`` with a mesh of one: the images
are zero-padded at the bottom and right to a multiple of ``divisor`` (the
model's total downsampling factor; 32 covers the zoo), go through one
eval-mode forward without tiling or stitching, and the probabilities are
cropped back.  The padding lies outside the FOV, which masks it away
downstream.  Sharding the rows over several devices is not ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def pad_to_multiple(images: torch.Tensor, divisor: int) -> torch.Tensor:
    """Zero-pad (N, H, W, C) images at the bottom and right so that H and
    W are multiples of ``divisor``."""
    _, h, w, _ = images.shape
    ph, pw = -h % divisor, -w % divisor
    if ph == 0 and pw == 0:
        return images
    return F.pad(images, (0, 0, 0, pw, 0, ph))


def spatial_predict(forward: Callable[[torch.Tensor], torch.Tensor],
                    images: torch.Tensor, divisor: int = 32) -> torch.Tensor:
    """Whole-image probabilities (N, H, W) of (N, H, W, C) images.
    ``forward`` maps (B, H', W', C) images to (B, H', W', 1)
    probabilities, as ``Predictor._forward`` does."""
    _, h, w, _ = images.shape
    probs = forward(pad_to_multiple(images, divisor))
    return probs[:, :h, :w, 0]
