"""PNG artifact writers of the evaluation path (reference evaluate.py:99-161
and 320-334), counterpart of ``jcfszxc_unet_tpu/utils/vis.py``.

PIL is imported only when a file is written.  All functions take HWC/HW
float numpy arrays in [0, 1].
"""

from __future__ import annotations

import os

import numpy as np


def _to_hwc3(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return img


def _save(arr01: np.ndarray, path: str) -> None:
    from PIL import Image

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray((np.clip(arr01, 0, 1) * 255).astype(np.uint8)).save(path)


def save_triptych(image: np.ndarray, pred: np.ndarray, label: np.ndarray,
                  path: str, sep: int = 16) -> None:
    """image | prediction | label, stacked along the height with blank
    separators (reference evaluate.py:323-334)."""
    image, pred, label = map(_to_hwc3, (image, pred, label))
    blank = np.zeros((sep, image.shape[1], 3), np.float32)
    _save(np.concatenate([image, blank, pred, blank, label], axis=0), path)


def save_grayscale(img: np.ndarray, path: str) -> None:
    """One HxW [0, 1] map as 8-bit grayscale (reference evaluate.py:320-321)."""
    _save(img, path)


def save_error_panel(image: np.ndarray, true_mask: np.ndarray,
                     pred_mask: np.ndarray, path: str, sep: int = 16) -> float:
    """image | truth | TP green / FP red / FN blue panel (twice); returns the
    panel's hard Dice (reference evaluate.py:99-161)."""
    image = _to_hwc3(np.asarray(image))
    t = np.asarray(true_mask) > 0.5
    p = np.asarray(pred_mask) > 0.5
    h, w = t.shape
    truth_rgb = np.zeros((h, w, 3), np.float32)
    truth_rgb[..., 1] = t
    panel = np.zeros((h, w, 3), np.float32)
    panel[..., 1] = t & p
    panel[..., 0] = ~t & p
    panel[..., 2] = t & ~p
    blank = np.zeros((h, sep, 3), np.float32)
    _save(np.concatenate(
        [image, blank, truth_rgb, blank, panel, blank, panel], axis=1), path)
    denom = t.sum() + p.sum()
    return float(2.0 * (t & p).sum() / denom) if denom else 0.0
