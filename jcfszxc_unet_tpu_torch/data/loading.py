"""Dataset loading and summary (reference data_loading.py:16-115),
counterpart of ``jcfszxc_unet_tpu/data/loading.py``."""

from __future__ import annotations

import os
import random
from typing import Dict

from jcfszxc_unet_tpu_torch.data.preprocess import load_preprocessed_data  # noqa: F401


def display_dataset_info(dataset: Dict) -> None:
    """Print a dataset summary (reference data_loading.py:68-79)."""
    print("\nDataset info:")
    print(f"num images: {len(dataset['images'])}")
    print(f"image shape: {dataset['images'][0].shape}")
    print(f"mask shape: {dataset['masks'][0].shape}")
    print(f"label shape: {dataset['labels'][0].shape}")
    print("\nSample filenames:")
    for i, filename in enumerate(dataset["filenames"]):
        print(f"sample {i + 1}: {filename}")


def visualize_samples(dataset: Dict, num_samples: int = 3,
                      output_dir: str = "visualizations/") -> None:
    """Save a grid of (image, mask, label) rows for random samples
    (reference data_loading.py:82-115); skipped where matplotlib is
    missing, as in the JAX package."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return

    num_samples = min(num_samples, len(dataset["images"]))
    indices = random.sample(range(len(dataset["images"])), num_samples)
    fig, axes = plt.subplots(num_samples, 3, figsize=(15, 5 * num_samples),
                             squeeze=False)
    for row, idx in enumerate(indices):
        axes[row, 0].imshow(dataset["images"][idx])
        axes[row, 0].set_title(f"Original Image: {dataset['filenames'][idx]}")
        axes[row, 1].imshow(dataset["masks"][idx], cmap="gray")
        axes[row, 1].set_title("Mask")
        axes[row, 2].imshow(dataset["labels"][idx], cmap="gray")
        axes[row, 2].set_title("Vessel Label")
        for c in range(3):
            axes[row, c].axis("off")
    plt.tight_layout()
    os.makedirs(output_dir, exist_ok=True)
    plt.savefig(os.path.join(output_dir, "sample_visualization.png"))
    plt.close(fig)
