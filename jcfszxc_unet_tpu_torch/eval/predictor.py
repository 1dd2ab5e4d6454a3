"""Serving-oriented prediction API, counterpart of
``jcfszxc_unet_tpu/eval/predictor.py`` (tiled path):

    p = Predictor.from_checkpoint("best_model.pt")     # on the card
    probs = p.predict_images(images_nhwc)              # tiled + stitched

Inputs and outputs keep the JAX layout (NHWC images, (N, H, W) maps); the
model runs on NCHW ``channels_last`` tensors in ``compute_dtype`` under
``torch.inference_mode``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from jcfszxc_unet_tpu_torch.eval.tiling import tiled_predict
from jcfszxc_unet_tpu_torch.utils.device import resolve_device


class Predictor:
    def __init__(self, model: nn.Module, compute_dtype=torch.bfloat16,
                 patch_size: int = 512, inference_batch_size: int = 32,
                 device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(device=self.device,
                              memory_format=torch.channels_last).eval()
        self.compute_dtype = compute_dtype
        self.patch_size = patch_size
        self.inference_batch_size = inference_batch_size

    @classmethod
    def from_checkpoint(cls, path: str, device="cuda", **kwargs
                        ) -> "Predictor":
        """Build from a port checkpoint (train/checkpoint.py)."""
        from jcfszxc_unet_tpu_torch.train.checkpoint import load_model

        model, _ = load_model(path, device=resolve_device(device))
        return cls(model, device=device, **kwargs)

    def _forward(self, batch: torch.Tensor) -> torch.Tensor:
        """(B, P, P, C) patches -> (B, P, P, 1) float32 probabilities."""
        x = batch.permute(0, 3, 1, 2).to(self.compute_dtype)  # channels_last
        return torch.sigmoid(self.model(x).float()).permute(0, 2, 3, 1)

    @torch.inference_mode()
    def predict_patches(self, patches) -> torch.Tensor:
        """Raw patch-batch probabilities (B, P, P, 1)."""
        return self._forward(torch.as_tensor(patches, device=self.device))

    @torch.inference_mode()
    def predict_images(self, images, patch_size: Optional[int] = None
                       ) -> torch.Tensor:
        """Tiled, count-average-stitched (N, H, W) probabilities of
        (N, H, W, C) images, FOV-unmasked (the caller applies masks)."""
        images = torch.as_tensor(images, device=self.device).contiguous()
        return tiled_predict(self._forward, images,
                             patch_size or self.patch_size,
                             self.inference_batch_size)
