"""DRIVE preprocessing (reference preprocess.py), the port's own copy of
``jcfszxc_unet_tpu/data/preprocess.py``: host numpy, no torch.

Walks ``<dataset>/{training,test}/`` with ``images/*.tif``,
``mask/<stem>_mask.gif`` and ``1st_manual/<id>_manual1.gif`` (reference
preprocess.py:96-111), scales to float32 in [0, 1] (:117-119) and writes
one file per split with the keys ``images, masks, labels, filenames`` as
h5 (default), pickle or joblib (:147-191).  The optional grayscale, CLAHE
and gamma enhancements, which the reference lacks, are off by default, so
the default output equals the reference's.

PIL, ``h5py`` and ``joblib`` are imported only by the functions that use
them: the card's image may lack them.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Dict, Optional

import numpy as np


# ---------------------------------------------------------------------------
# Optional enhancements (JAX preprocess.py:40-111)
# ---------------------------------------------------------------------------


def to_grayscale(img: np.ndarray) -> np.ndarray:
    """ITU-R BT.601 luma of an HxWx3 float image -> HxW."""
    return img @ np.array([0.299, 0.587, 0.114], dtype=img.dtype)


def gamma_correct(img: np.ndarray, gamma: float) -> np.ndarray:
    """Pointwise gamma on a [0, 1] float image."""
    return np.clip(img, 0.0, 1.0) ** gamma


def clahe(img: np.ndarray, clip_limit: float = 2.0, n_tiles: int = 8,
          n_bins: int = 256) -> np.ndarray:
    """Contrast-limited adaptive histogram equalization of a [0, 1] HxW
    image: per-tile clipped-histogram CDFs, bilinearly interpolated
    between the four surrounding tiles."""
    h, w = img.shape
    q = np.clip((img * (n_bins - 1)).astype(np.int32), 0, n_bins - 1)
    th, tw = (h + n_tiles - 1) // n_tiles, (w + n_tiles - 1) // n_tiles
    luts = np.zeros((n_tiles, n_tiles, n_bins), np.float32)
    for ty in range(n_tiles):
        for tx in range(n_tiles):
            tile = q[ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw]
            hist = np.bincount(tile.ravel(),
                               minlength=n_bins).astype(np.float32)
            limit = clip_limit * tile.size / n_bins
            excess = np.maximum(hist - limit, 0.0).sum()
            hist = np.minimum(hist, limit) + excess / n_bins
            cdf = np.cumsum(hist)
            luts[ty, tx] = (cdf - cdf[0]) / max(cdf[-1] - cdf[0], 1e-8)
    yy = (np.arange(h) + 0.5) / th - 0.5
    xx = (np.arange(w) + 0.5) / tw - 0.5
    y0 = np.clip(np.floor(yy).astype(int), 0, n_tiles - 1)
    x0 = np.clip(np.floor(xx).astype(int), 0, n_tiles - 1)
    y1 = np.clip(y0 + 1, 0, n_tiles - 1)
    x1 = np.clip(x0 + 1, 0, n_tiles - 1)
    fy = np.clip(yy - y0, 0.0, 1.0)[:, None]
    fx = np.clip(xx - x0, 0.0, 1.0)[None, :]
    v00 = luts[y0[:, None], x0[None, :], q]
    v01 = luts[y0[:, None], x1[None, :], q]
    v10 = luts[y1[:, None], x0[None, :], q]
    v11 = luts[y1[:, None], x1[None, :], q]
    out = (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
           + v10 * fy * (1 - fx) + v11 * fy * fx)
    return out.astype(np.float32)


def enhance_image(img: np.ndarray, grayscale: bool = False,
                  use_clahe: bool = False, gamma: Optional[float] = None
                  ) -> np.ndarray:
    """The optional enhancement chain; the identity by default.  Grayscale
    output is replicated to 3 channels."""
    if grayscale:
        g = to_grayscale(img)
        if use_clahe:
            g = clahe(g)
        if gamma is not None:
            g = gamma_correct(g, gamma)
        return np.repeat(g[..., None], 3, axis=-1)
    if use_clahe:
        img = np.stack([clahe(img[..., c]) for c in range(img.shape[-1])],
                       axis=-1)
    if gamma is not None:
        img = gamma_correct(img, gamma)
    return img


# ---------------------------------------------------------------------------
# DRIVE splits (reference preprocess.py:18-191)
# ---------------------------------------------------------------------------


def process_data_subset(data_path: str, subset_name: str = "dataset",
                        grayscale: bool = False, use_clahe: bool = False,
                        gamma: Optional[float] = None) -> Dict:
    """One DRIVE split as float32 [0, 1] arrays: ``images/x.tif`` pairs
    with ``mask/x_mask.gif`` and ``1st_manual/<id>_manual1.gif``, id =
    x.split('_')[0] (reference preprocess.py:106-111)."""
    from PIL import Image

    images, masks, labels, filenames = [], [], [], []
    for image_path in sorted(glob.glob(os.path.join(data_path, "images",
                                                    "*.tif"))):
        image_name = os.path.basename(image_path)
        stem = image_name.split(".")[0]
        mask_file = os.path.join(data_path, "mask", stem + "_mask.gif")
        label_file = os.path.join(data_path, "1st_manual",
                                  stem.split("_")[0] + "_manual1.gif")
        image = np.asarray(Image.open(image_path), dtype=np.float32) / 255.0
        mask = np.asarray(Image.open(mask_file), dtype=np.float32) / 255.0
        label = np.asarray(Image.open(label_file), dtype=np.float32) / 255.0
        image = enhance_image(image, grayscale, use_clahe, gamma)
        print(f"[{subset_name}] {image_name}: image {image.shape}, "
              f"mask {mask.shape}, label {label.shape}")
        images.append(image)
        masks.append(mask)
        labels.append(label)
        filenames.append(image_name)
    return {"images": np.array(images), "masks": np.array(masks),
            "labels": np.array(labels), "filenames": filenames}


def save_data(dataset: Dict, output_dir: str, file_prefix: str,
              save_method: str = "h5") -> str:
    """Write a split; the h5 schema of reference preprocess.py:174-184
    (datasets ``images``, ``masks``, ``labels`` and a vlen-str
    ``filenames``).  Returns the file's path."""
    os.makedirs(output_dir, exist_ok=True)
    if save_method == "h5":
        import h5py

        output_file = os.path.join(output_dir, file_prefix + ".h5")
        with h5py.File(output_file, "w") as f:
            for key in ("images", "masks", "labels"):
                f.create_dataset(key, data=dataset[key])
            f.create_dataset("filenames", data=np.array(
                dataset["filenames"], dtype=h5py.special_dtype(vlen=str)))
    elif save_method == "pickle":
        output_file = os.path.join(output_dir, file_prefix + ".pkl")
        with open(output_file, "wb") as f:
            pickle.dump(dataset, f)
    elif save_method == "joblib":
        import joblib

        output_file = os.path.join(output_dir, file_prefix + ".joblib")
        joblib.dump(dataset, output_file, compress=3)
    else:
        raise ValueError(f"Unsupported save method: {save_method}")
    print(f"Saved {len(dataset['images'])} images to {output_file}")
    return output_file


def load_preprocessed_data(file_path: str,
                           load_method: Optional[str] = None) -> Dict:
    """Load a split written by the preprocessing CLI (h5, pickle or joblib;
    the format follows the extension unless ``load_method`` names it).
    Returns {"images", "masks", "labels", "filenames"}."""
    if load_method is None:
        for ext, method in ((".pkl", "pickle"), (".joblib", "joblib"),
                            (".h5", "h5")):
            if file_path.endswith(ext):
                load_method = method
                break
        else:
            raise ValueError(f"Cannot infer load method from: {file_path}")
    if load_method == "pickle":
        with open(file_path, "rb") as f:
            return pickle.load(f)
    if load_method == "joblib":
        import joblib

        return joblib.load(file_path)
    if load_method == "h5":
        import h5py

        with h5py.File(file_path, "r") as f:
            return {
                "images": f["images"][:],
                "masks": f["masks"][:],
                "labels": f["labels"][:],
                "filenames": [n.decode("utf-8") if isinstance(n, bytes)
                              else n for n in f["filenames"][:]],
            }
    raise ValueError(f"Unsupported load method: {load_method}")


def preprocess_dataset(dataset_path: str = "../datasets/drive_eye/",
                       output_dir: str = "data/", save_method: str = "h5",
                       include_test: bool = True, grayscale: bool = False,
                       use_clahe: bool = False, gamma: Optional[float] = None
                       ) -> Dict:
    """Process the training split (and the test split unless
    ``include_test`` is false) into ``output_dir`` under the reference's
    file names (reference preprocess.py:18-85).  Returns {"train": info,
    "test": info or None}, each info holding the sample count, the array
    shapes and the output file."""

    def info(ds, path):
        n = len(ds["images"])
        return {"num_samples": n,
                "image_shape": ds["images"].shape if n else None,
                "mask_shape": ds["masks"].shape if n else None,
                "label_shape": ds["labels"].shape if n else None,
                "output_file": path}

    result = {"train": None, "test": None}
    for split, subset, prefix in (("train", "training", "train_eye_dataset"),
                                  ("test", "test", "test_eye_dataset")):
        if split == "test" and not include_test:
            break
        ds = process_data_subset(os.path.join(dataset_path, subset), split,
                                 grayscale, use_clahe, gamma)
        result[split] = info(ds, save_data(ds, output_dir, prefix,
                                           save_method))
    return result
