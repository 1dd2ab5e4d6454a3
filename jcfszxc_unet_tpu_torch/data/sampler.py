"""Patch sampling for training and tiled evaluation, counterpart of
``jcfszxc_unet_tpu/data/sampler.py``.

  * train sample map: (img_idx, x, y) of mask != 0 pixels whose patch
    lies inside the image (reference train.py:138-152);
  * grid map: centers at stride half_patch clipped to the valid interior
    (reference train.py:159-184, evaluate.py:200-213);
  * a patch at center (x, y) spans [x - half, x + half) x [y - half, y + half).

The dataset and the sample map live on the device; centers are drawn
there from an explicit ``torch.Generator`` and patches are cut by one
gather, so a training step does no host work per patch.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def build_train_sample_map(masks: np.ndarray, half_patch: int) -> np.ndarray:
    """Centers of in-bounds FOV pixels.  masks: (N, H, W), nonzero inside
    the field of view.  Returns int32 (num_valid, 3) of (img_idx, x, y)."""
    n, h, w = masks.shape
    ii, xx, yy = np.nonzero(masks != 0)
    valid = ((xx >= half_patch) & (xx < h - half_patch)
             & (yy >= half_patch) & (yy < w - half_patch))
    return np.stack([ii[valid], xx[valid], yy[valid]],
                    axis=-1).astype(np.int32)


def build_grid_sample_map(n_images: int, h: int, w: int,
                          half_patch: int) -> np.ndarray:
    """Half-overlapping grid of patch centers: arange(half, dim, half)
    clipped to [half, dim - half].  Returns int32 (num_patches, 3) of
    (img_idx, x, y)."""
    xs = np.clip(np.arange(half_patch, h, half_patch), half_patch,
                 h - half_patch)
    ys = np.clip(np.arange(half_patch, w, half_patch), half_patch,
                 w - half_patch)
    ii, xx, yy = np.meshgrid(np.arange(n_images), xs, ys, indexing="ij")
    return np.stack([ii, xx, yy], axis=-1).reshape(-1, 3).astype(np.int32)


def extract_patches(pool: torch.Tensor, centers, patch_size: int
                    ) -> torch.Tensor:
    """(B, P, P, ...) patches of a (N, H, W, ...) pool, cut by one gather
    on the pool's device.  ``centers``: (B, 3) ints (numpy or tensor) of
    (img_idx, x, y); every patch must lie inside the image."""
    c = torch.as_tensor(centers, device=pool.device).long()
    half = patch_size // 2
    offs = torch.arange(patch_size, device=pool.device)
    rows = (c[:, 1] - half)[:, None] + offs
    cols = (c[:, 2] - half)[:, None] + offs
    return pool[c[:, 0, None, None], rows[:, :, None], cols[:, None, :]]


def sample_centers(generator: torch.Generator, sample_map: torch.Tensor,
                   batch_size: int) -> torch.Tensor:
    """``batch_size`` rows of the (num_valid, 3) map, uniformly with
    replacement (reference train.py:201-209).  The generator lies on the
    map's device."""
    idx = torch.randint(0, sample_map.shape[0], (batch_size,),
                        generator=generator, device=sample_map.device)
    return sample_map[idx]


def sample_batch(generator: torch.Generator, images: torch.Tensor,
                 labels: torch.Tensor, sample_map: torch.Tensor,
                 batch_size: int, patch_size: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One training batch: random FOV centers, then the patch gather.
    images (N, H, W, C), labels (N, H, W, 1) -> (B, P, P, C), (B, P, P, 1)."""
    centers = sample_centers(generator, sample_map, batch_size)
    return (extract_patches(images, centers, patch_size),
            extract_patches(labels, centers, patch_size))


def apply_dihedral(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Per-sample dihedral-8 element of (B, P, P, C) square patches:
    (optional transpose) o (optional H flip) o (optional V flip), as
    three selects over the batch (sampler.py:449-456).  ``bits``: (3, B)
    booleans, one row per select."""
    t, h, v = (b.view(-1, 1, 1, 1) for b in bits.to(torch.bool))
    x = torch.where(t, x.transpose(1, 2), x)
    x = torch.where(h, x.flip(2), x)
    return torch.where(v, x.flip(1), x)


def augment_batch(generator: torch.Generator, imgs: torch.Tensor,
                  labs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same random dihedral-8 element on image and label patches,
    each of the three selects drawn with p = 1/2."""
    bits = torch.rand((3, imgs.shape[0]), generator=generator,
                      device=imgs.device) < 0.5
    return apply_dihedral(imgs, bits), apply_dihedral(labs, bits)
