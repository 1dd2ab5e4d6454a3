"""Preprocessing CLI of the port, counterpart of
``jcfszxc_unet_tpu/cli/preprocess.py`` (the reference's preprocess.py
``__main__``, :235-257): process the DRIVE train and test splits, save
them (h5 by default), then reload each as a smoke test.  Host numpy only:
no torch, no device.  Flags of the JAX CLI: the dataset path, the output
directory, the save method and the optional grayscale, CLAHE and gamma
enhancements (off by default)."""

from __future__ import annotations

import argparse

from jcfszxc_unet_tpu_torch.data.preprocess import (
    load_preprocessed_data,
    preprocess_dataset,
)


def get_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Preprocess the DRIVE dataset (PyTorch port)")
    parser.add_argument("--dataset-path", type=str,
                        default="../datasets/drive_eye/",
                        help="DRIVE root containing training/ and test/")
    parser.add_argument("--output-dir", type=str, default="data/",
                        help="Output directory for the split files")
    parser.add_argument("--save-method", type=str, default="h5",
                        choices=["h5", "pickle", "joblib"])
    parser.add_argument("--no-test", action="store_true",
                        help="Skip the test split")
    parser.add_argument("--grayscale", action="store_true",
                        help="Convert to grayscale (replicated to 3 channels)")
    parser.add_argument("--clahe", action="store_true",
                        help="Apply CLAHE contrast enhancement")
    parser.add_argument("--gamma", type=float, default=None,
                        help="Apply gamma correction with this exponent")
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    info = preprocess_dataset(
        dataset_path=args.dataset_path, output_dir=args.output_dir,
        save_method=args.save_method, include_test=not args.no_test,
        grayscale=args.grayscale, use_clahe=args.clahe, gamma=args.gamma)
    for split in ("train", "test"):
        if info[split]:
            print(f"\n{split.capitalize()} split info:")
            for key, value in info[split].items():
                print(f"{key}: {value}")
    # Reload smoke test (reference preprocess.py:249-257)
    print("\nVerifying reload...")
    for split in ("train", "test"):
        if info[split]:
            data = load_preprocessed_data(info[split]["output_file"])
            print(f"Reloaded {split} split - images: {len(data['images'])}")


if __name__ == "__main__":
    main()
