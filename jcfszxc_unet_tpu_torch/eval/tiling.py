"""Patch-based inference, counterpart of ``stitch_patches``,
``stitch_patches_scatter``, ``tiled_predict``, ``sliding_window_predict``
and ``dihedral_tta`` in ``jcfszxc_unet_tpu/eval/tiling.py``: patch grid ->
chunked forward -> count-averaged stitch (reference evaluate.py:225-307),
the sliding-window protocol (reference evaluate.py:28-96) and dihedral-8
test-time augmentation.

Patches are cut and stitched on the images' device; the grid is built on
the host.  The forward runs eagerly in chunks of the batch size, so the
tail chunk may be short (the JAX version pads it by wrapping, which
changes no output).  With a ``world`` (``parallel/mesh.py``) the patch
grid is split over the ranks, as the JAX version shards each chunk over
its mesh: each rank cuts and forwards its contiguous share in chunks of
the batch size over the ranks' count, the probabilities are gathered,
and every rank stitches them as one process would (the stitch is
replicated, as in JAX).

Under a profiler the steps are spans (``utils.profiling.annotate``):
``unet.eval.gather`` (with ``unet.sync`` around the grid's copy to the
device, where the host waits for it), one ``unet.eval.forward`` per chunk
and ``unet.eval.stitch``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from jcfszxc_unet_tpu_torch.data.sampler import (
    build_grid_sample_map,
    extract_patches,
)
from jcfszxc_unet_tpu_torch.parallel.mesh import gather_rows, row_bounds
from jcfszxc_unet_tpu_torch.utils.profiling import annotate


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


def stitch_patches_scatter(probs: torch.Tensor, centers, n_images: int,
                           image_h: int, image_w: int) -> torch.Tensor:
    """:func:`stitch_patches` as one flat ``index_add_`` of the B*P*P
    values and one of their counts (the JAX version's segment-sum
    formulation, the one that shards over a mesh).  Every patch must lie
    inside its image (grid centers do); the sums may differ from
    :func:`stitch_patches`'s in the last bits where patches overlap."""
    b, patch, _ = probs.shape
    half = patch // 2
    c = torch.as_tensor(centers, device=probs.device).long()
    offs = torch.arange(patch, device=probs.device)
    rows = (c[:, 1, None] - half) + offs                    # (B, P)
    cols = (c[:, 2, None] - half) + offs                    # (B, P)
    flat = (c[:, 0, None, None] * (image_h * image_w)
            + rows[:, :, None] * image_w + cols[:, None, :]).reshape(-1)
    size = n_images * image_h * image_w
    vals = probs.float().reshape(-1)
    canvas = torch.zeros(size, device=probs.device).index_add_(0, flat, vals)
    counts = torch.zeros(size, device=probs.device).index_add_(
        0, flat, torch.ones_like(vals))
    canvas = canvas.view(n_images, image_h, image_w)
    counts = counts.view(n_images, image_h, image_w)
    return torch.where(counts > 0, canvas / counts.clamp(min=1.0),
                       torch.zeros_like(canvas))


def _chunked(forward, patches: torch.Tensor, batch_size: int):
    bs = min(batch_size, patches.shape[0])

    def chunk(i):
        with annotate("unet.eval.forward"):
            return forward(patches[i:i + bs])

    return torch.cat([chunk(i) for i in range(0, patches.shape[0], bs)])


def _gather(images: torch.Tensor, centers, patch_size: int) -> torch.Tensor:
    """``extract_patches`` of the host-built grid ``centers``, whose copy
    to the images' device is a host sync on the card."""
    with annotate("unet.eval.gather"):
        with annotate("unet.sync"):
            idx = torch.as_tensor(centers, device=images.device)
        return extract_patches(images, idx, patch_size)


def tiled_predict(forward: Callable[[torch.Tensor], torch.Tensor],
                  images: torch.Tensor, patch_size: int,
                  inference_batch_size: int = 32, world=None
                  ) -> torch.Tensor:
    """Full-image prediction by grid tiling and stitching.

    ``forward`` maps (B, P, P, C) patches to (B, P, P, 1) probabilities
    (the caller applies the sigmoid, as evaluate.py:282 does).  Returns
    (N, H, W) float32 stitched maps on the images' device.  With a
    ``world``, every rank returns the maps, having forwarded its share of
    the patches (see the module doc).
    """
    n, h, w, _ = images.shape
    if patch_size > h or patch_size > w:
        raise ValueError(
            f"patch_size {patch_size} exceeds the image size {h}x{w}; "
            f"pass a smaller --patch-size (the 512 default assumes "
            f"584x565 DRIVE images)")
    centers = build_grid_sample_map(n, h, w, patch_size // 2)
    if world is None:
        probs = _chunked(forward, _gather(images, centers, patch_size),
                         inference_batch_size)
    else:
        total = centers.shape[0]
        bs = max(min(inference_batch_size, total) // world.size, 1)
        start, stop = row_bounds(total, world)
        local = (_chunked(forward, _gather(
            images, centers[start:stop], patch_size), bs)
            if stop > start else torch.zeros(
                (0, patch_size, patch_size, 1), device=images.device))
        probs = gather_rows(local, total, world)
    with annotate("unet.eval.stitch"):
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
    probs = _chunked(forward, _gather(image[None], centers, patch_size),
                     batch_size)
    with annotate("unet.eval.stitch"):
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
