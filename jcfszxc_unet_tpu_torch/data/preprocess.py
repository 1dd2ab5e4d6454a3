"""Loading of preprocessed DRIVE splits (reference preprocess.py:194-232),
the port's own copy of ``load_preprocessed_data`` from
``jcfszxc_unet_tpu/data/preprocess.py``.  ``h5py`` and ``joblib`` are
imported only when a file of their format is read."""

from __future__ import annotations

import pickle
from typing import Dict, Optional


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
