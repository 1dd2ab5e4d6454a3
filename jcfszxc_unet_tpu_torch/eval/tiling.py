"""Patch-based inference, counterpart of ``stitch_patches``,
``tiled_predict``, ``sliding_window_predict`` and ``dihedral_tta`` in
``jcfszxc_unet_tpu/eval/tiling.py``: patch grid -> chunked forward ->
count-averaged stitch (reference evaluate.py:225-307), the
sliding-window protocol (reference evaluate.py:28-96) and dihedral-8
test-time augmentation.

Patches are cut and stitched on the images' device; the grid is built on
the host.  The forward runs eagerly in chunks of the batch size, so the
tail chunk may be short (the JAX version pads it by wrapping, which
changes no output).
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


def _chunked(forward, patches: torch.Tensor, batch_size: int):
    bs = min(batch_size, patches.shape[0])
    return torch.cat([forward(patches[i:i + bs])
                      for i in range(0, patches.shape[0], bs)])


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
    probs = _chunked(forward, extract_patches(images, centers, patch_size),
                     inference_batch_size)
    return stitch_patches(probs.squeeze(-1), centers, n, h, w)


def sliding_window_predict(forward: Callable[[torch.Tensor], torch.Tensor],
                           image: torch.Tensor, patch_size: int = 256,
                           overlap: float = 0.5, batch_size: int = 4
                           ) -> torch.Tensor:
    """Single-image sliding window: top-left-anchored windows at stride
    ``int(patch_size * (1 - overlap))``, count-averaged; border pixels no
    window covers stay 0.  image: (H, W, C); returns (H, W) float32."""
    h, w, _ = image.shape
    if patch_size > h or patch_size > w:
        raise ValueError(
            f"patch_size {patch_size} exceeds the image size {h}x{w}; "
            f"pass a smaller patch size (the reference protocol would "
            f"silently produce an empty window grid here)")
    step = int(patch_size * (1 - overlap))
    half = patch_size // 2
    centers = np.array(
        [(0, y + half, x + half)
         for y in range(0, h - patch_size + 1, step)
         for x in range(0, w - patch_size + 1, step)], dtype=np.int32)
    probs = _chunked(forward, extract_patches(image[None], centers,
                                              patch_size), batch_size)
    return stitch_patches(probs.squeeze(-1), centers, 1, h, w)[0]


def dihedral_tta(forward: Callable[[torch.Tensor], torch.Tensor]
                 ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Wrap a square-patch forward, (B, P, P, C) -> (B, P, P, 1), with
    dihedral-8 test-time augmentation: the 8 flips/transposes of the
    batch, each output mapped back and the 8 averaged (8x the compute).
    Each variant is made contiguous before the forward, since a transpose
    is a strided view and the model's kernels take contiguous NHWC."""

    def fwd(batch):
        acc = None
        for t in (False, True):
            xb = batch.transpose(1, 2) if t else batch
            for hflip in (False, True):
                for vflip in (False, True):
                    dims = [d for d, on in ((2, hflip), (1, vflip)) if on]
                    x = xb.flip(dims) if dims else xb
                    y = forward(x.contiguous())
                    # invert: flips are their own inverses, then transpose
                    y = y.flip(dims) if dims else y
                    y = y.transpose(1, 2) if t else y
                    acc = y if acc is None else acc + y
        return acc / 8.0

    return fwd
