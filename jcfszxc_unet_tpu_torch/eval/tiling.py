"""Tiled inference: patch grid -> chunked forward -> count-averaged stitch,
counterpart of ``stitch_patches`` and ``tiled_predict`` in
``jcfszxc_unet_tpu/eval/tiling.py`` (reference evaluate.py:225-307).

Patches are sliced and stitched on the images' device; the grid is built
on the host.  The forward runs eagerly in chunks of
``inference_batch_size``, so the tail chunk may be short (the JAX version
pads it by wrapping, which changes no output).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from jcfszxc_unet_tpu_torch.data.sampler import (
    build_grid_sample_map,
    extract_patches,
)


def stitch_patches(probs: torch.Tensor, centers: np.ndarray, n_images: int,
                   image_h: int, image_w: int) -> torch.Tensor:
    """Add (B, P, P) probabilities into (N, H, W) canvases in patch order
    and count-average the overlaps (reference evaluate.py:291-307)."""
    patch = probs.shape[1]
    half = patch // 2
    canvas = torch.zeros((n_images, image_h, image_w), dtype=torch.float32,
                         device=probs.device)
    counts = torch.zeros_like(canvas)
    for k, (i, x, y) in enumerate(np.asarray(centers).tolist()):
        rows = slice(x - half, x - half + patch)
        cols = slice(y - half, y - half + patch)
        canvas[i, rows, cols] += probs[k].float()
        counts[i, rows, cols] += 1.0
    return torch.where(counts > 0, canvas / counts.clamp(min=1.0),
                       torch.zeros_like(canvas))


def tiled_predict(forward: Callable[[torch.Tensor], torch.Tensor],
                  images: torch.Tensor, patch_size: int,
                  inference_batch_size: int = 32) -> torch.Tensor:
    """Full-image prediction by grid tiling and stitching.

    ``forward`` maps (B, P, P, C) patches to (B, P, P, 1) probabilities
    (the caller applies the sigmoid, as evaluate.py:282 does).  Returns
    (N, H, W) float32 stitched maps on the images' device.
    """
    n, h, w, _ = images.shape
    if patch_size > h or patch_size > w:
        raise ValueError(
            f"patch_size {patch_size} exceeds the image size {h}x{w}; "
            f"pass a smaller --patch-size (the 512 default assumes "
            f"584x565 DRIVE images)")
    centers = build_grid_sample_map(n, h, w, patch_size // 2)
    patches = extract_patches(images, centers, patch_size)
    bs = min(inference_batch_size, patches.shape[0])
    probs = torch.cat([forward(patches[i:i + bs])
                       for i in range(0, patches.shape[0], bs)])
    return stitch_patches(probs.squeeze(-1), centers, n, h, w)
