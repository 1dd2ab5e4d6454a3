"""Whole-image evaluation, counterpart of
``jcfszxc_unet_tpu/parallel/spatial.py``: the images are zero-padded at
the bottom and right to a multiple of ``divisor`` (the model's total
downsampling factor; 32 covers the zoo), go through one eval-mode forward
without tiling or stitching, and the probabilities are cropped back.  The
padding lies outside the FOV, which masks it away downstream.

With a ``world`` of several ranks the image's rows are sharded over them
(``parallel.spatial.spatial_forward``, the steps of JAX
``make_spatial_forward``): H is padded to a multiple of ``size *
divisor``, as JAX pads for its mesh, so the maps near the bottom edge
differ from one device's, in JAX too.
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
                    images: torch.Tensor, divisor: int = 32,
                    world=None) -> torch.Tensor:
    """Whole-image probabilities (N, H, W) of (N, H, W, C) images.
    ``forward`` maps (B, H', W', C) images to (B, H', W', 1)
    probabilities, as ``Predictor._forward`` does.  With a ``world`` of
    several ranks (``parallel.World``), every rank passes the same images,
    ``forward`` sees this rank's rows, and every rank gets the whole
    maps."""
    if world is not None and world.size > 1:
        from jcfszxc_unet_tpu_torch.parallel.spatial import spatial_forward

        return spatial_forward(forward, images, world, divisor)
    _, h, w, _ = images.shape
    probs = forward(pad_to_multiple(images, divisor))
    return probs[:, :h, :w, 0]
