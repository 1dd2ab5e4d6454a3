"""Patch grid and patch extraction for tiled evaluation, counterpart of
``build_grid_sample_map`` and ``extract_patches`` in
``jcfszxc_unet_tpu/data/sampler.py``.  A patch at center (x, y) spans
[x - half, x + half) x [y - half, y + half)."""

from __future__ import annotations

import numpy as np
import torch


def build_grid_sample_map(n_images: int, h: int, w: int,
                          half_patch: int) -> np.ndarray:
    """Half-overlapping grid of patch centers: arange(half, dim, half)
    clipped to [half, dim - half].  Returns int32 (num_patches, 3) of
    (img_idx, x, y).  Reference train.py:159-184 / evaluate.py:200-213."""
    xs = np.clip(np.arange(half_patch, h, half_patch), half_patch,
                 h - half_patch)
    ys = np.clip(np.arange(half_patch, w, half_patch), half_patch,
                 w - half_patch)
    ii, xx, yy = np.meshgrid(np.arange(n_images), xs, ys, indexing="ij")
    return np.stack([ii, xx, yy], axis=-1).reshape(-1, 3).astype(np.int32)


def extract_patches(pool: torch.Tensor, centers: np.ndarray,
                    patch_size: int) -> torch.Tensor:
    """Slice (B, P, P, C) patches out of a (N, H, W, C) pool on its device.
    ``centers`` is the host-side (B, 3) int array of (img_idx, x, y)."""
    half = patch_size // 2
    return torch.stack([
        pool[i, x - half:x - half + patch_size, y - half:y - half + patch_size]
        for i, x, y in np.asarray(centers).tolist()
    ])
