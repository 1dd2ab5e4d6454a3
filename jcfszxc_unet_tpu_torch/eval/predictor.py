"""Serving-oriented prediction API, counterpart of
``jcfszxc_unet_tpu/eval/predictor.py``:

    p = Predictor.from_checkpoint("best_model.pt")     # on the card; also
                                                       # a .ckpt or a .pth
    probs = p.predict_images(images_nhwc)              # tiled + stitched
    probs1 = p.predict_full_image(image_hwc)           # sliding window
    probs2 = p.predict_spatial(images_nhwc)            # whole image

``tta=True`` wraps the patch forward with dihedral-8 test-time
augmentation (tiled and sliding-window paths only).  Inputs and outputs
keep the JAX layout (NHWC images, (N, H, W) maps); the model runs on NCHW
``channels_last`` tensors in ``compute_dtype`` under
``torch.inference_mode``.

``world`` (``parallel.World``) makes the predictor one rank of a
multi-device evaluation, as the JAX ``Predictor(mesh=...)``:
``predict_images`` splits the patch grid over the ranks
(``eval.tiling.tiled_predict``) and ``predict_spatial`` the padded
image's rows (``parallel.spatial``); both return the whole maps on every
rank, and the model runs on ``world.device``.  TTA composes with the
tiled path, since it wraps the forward.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from jcfszxc_unet_tpu_torch.eval.spatial import spatial_predict
from jcfszxc_unet_tpu_torch.eval.tiling import (
    dihedral_tta,
    sliding_window_predict,
    tiled_predict,
)
from jcfszxc_unet_tpu_torch.utils.device import resolve_device


def sigmoid_forward(model: nn.Module, batch: torch.Tensor,
                    compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(B, H, W, C) contiguous images -> (B, H, W, 1) float32
    probabilities: the NCHW ``channels_last`` view of ``batch`` in
    ``compute_dtype``, the model, a sigmoid in f32, back to NHWC.  The
    forward that :class:`Predictor` serves and that ``eval/export.py``
    exports (JAX ``export_forward``'s closure)."""
    x = batch.permute(0, 3, 1, 2).to(compute_dtype)  # channels_last
    return torch.sigmoid(model(x).float()).permute(0, 2, 3, 1)


class Predictor:
    def __init__(self, model: nn.Module, compute_dtype=torch.bfloat16,
                 patch_size: int = 512, inference_batch_size: int = 32,
                 device="cuda", tta: bool = False, world=None):
        self.world = world
        self.device = (world.device if world is not None
                       else resolve_device(device))
        self.model = model.to(device=self.device,
                              memory_format=torch.channels_last).eval()
        self.compute_dtype = compute_dtype
        self.patch_size = patch_size
        self.inference_batch_size = inference_batch_size
        self.tta = tta
        self._fwd = dihedral_tta(self._forward) if tta else self._forward

    @classmethod
    def from_checkpoint(cls, path: str, device="cuda", s2d: bool = False,
                        **kwargs) -> "Predictor":
        """Build from a port checkpoint, a JAX ``.ckpt`` or a reference
        ``.pth`` (``train.checkpoint.load_model_any``; a BCDU model gets
        ``N`` = ``patch_size``, 512 by default).  ``s2d=True`` opts a
        FRUNet, MultiResUNet or NestedUNet into space-to-depth execution;
        a checkpoint that records the mode runs in it anyway."""
        from jcfszxc_unet_tpu_torch.train.checkpoint import (
            load_model_any,
            opt_in_s2d,
        )

        model, config = load_model_any(
            path, device=resolve_device(device),
            patch_size=kwargs.get("patch_size", 512))
        if s2d:
            model, _ = opt_in_s2d(model, config)
        return cls(model, device=device, **kwargs)

    def _forward(self, batch: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) contiguous images -> (B, H, W, 1) float32
        probabilities (:func:`sigmoid_forward`)."""
        return sigmoid_forward(self.model, batch, self.compute_dtype)

    def _as_images(self, images) -> torch.Tensor:
        return torch.as_tensor(images, device=self.device).contiguous()

    @torch.inference_mode()
    def predict_patches(self, patches) -> torch.Tensor:
        """Raw patch-batch probabilities (B, P, P, 1)."""
        return self._fwd(self._as_images(patches))

    @torch.inference_mode()
    def predict_images(self, images, patch_size: Optional[int] = None
                       ) -> torch.Tensor:
        """Tiled, count-average-stitched (N, H, W) probabilities of
        (N, H, W, C) images, FOV-unmasked (the caller applies masks)."""
        return tiled_predict(self._fwd, self._as_images(images),
                             patch_size or self.patch_size,
                             self.inference_batch_size, world=self.world)

    @torch.inference_mode()
    def predict_full_image(self, image, patch_size: int = 256,
                           overlap: float = 0.5, batch_size: int = 4
                           ) -> torch.Tensor:
        """Sliding-window (H, W) probabilities of one (H, W, C) image (the
        API form of the reference's predict_full_image,
        evaluate.py:28-96)."""
        return sliding_window_predict(self._fwd, self._as_images(image),
                                      patch_size, overlap, batch_size)

    @torch.inference_mode()
    def predict_spatial(self, images, divisor: int = 32) -> torch.Tensor:
        """Whole-image (N, H, W) probabilities of (N, H, W, C) images,
        ``inference_batch_size`` images per forward; ``divisor`` must
        cover the model's total downsampling factor (32 covers the zoo).
        With a world of several ranks, every rank passes the same images,
        runs its rows of them and gets the whole maps."""
        if self.tta:
            raise ValueError("tta needs square patches; use predict_images/"
                             "predict_full_image, not predict_spatial")
        images = self._as_images(images)
        bs = self.inference_batch_size
        return torch.cat([spatial_predict(self._forward, images[i:i + bs],
                                          divisor, self.world)
                          for i in range(0, images.shape[0], bs)])
