"""Image-file inference CLI of the port, counterpart of
``jcfszxc_unet_tpu/cli/predict.py``: from image files to probability and
binary vessel maps, through ``eval.predictor.Predictor``:

    python -m jcfszxc_unet_tpu_torch.cli.predict retina.tif -m best_model.pt -o out/
    python -m jcfszxc_unet_tpu_torch.cli.predict *.tif --mode spatial

The model comes from a port checkpoint, a JAX ``.ckpt`` or a reference
``.pth`` (``train.checkpoint.load_model_any``) and runs on the card unless
``--device cpu`` is given.  :func:`predict_arrays` holds the input
normalisation and the protocols and works on arrays;
:func:`predict_files` reads and writes the files around it (PIL is
imported only there).
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from jcfszxc_unet_tpu_torch.eval.predictor import Predictor

MODES = ("tiled", "sliding", "spatial")


def check_mode(mode: str, tta: bool) -> None:
    if mode not in MODES:
        raise ValueError(f"mode {mode!r} is not one of {MODES}")
    if tta and mode == "spatial":
        raise ValueError("--tta needs square patches; use the tiled or "
                         "sliding modes")


def normalize_image(raw: np.ndarray) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1] from an image file's array: integer
    inputs over their dtype's max (16-bit TIFFs are common for retinal
    imagery), grayscale replicated to 3 channels, RGBA without alpha."""
    raw = np.asarray(raw)
    scale = float(np.iinfo(raw.dtype).max) if raw.dtype.kind in "iu" else 1.0
    img = raw.astype(np.float32) / scale
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    elif img.shape[-1] == 4:
        img = img[..., :3]
    return img


def predict_arrays(predictor: Predictor, raw_images, mode: str = "tiled",
                   patch_size: int = 512, overlap: float = 0.5,
                   inference_batch_size: int = 32):
    """(H, W) float32 probability maps of raw image arrays, one image at a
    time (they may differ in size).  ``mode``: ``tiled`` (grid and
    count-averaged stitch, the evaluate protocol, at the predictor's
    patch size), ``sliding`` (top-left-anchored windows at stride
    ``patch_size * (1 - overlap)``) or ``spatial`` (whole image, no
    tiling)."""
    check_mode(mode, predictor.tta)
    maps = []
    for raw in raw_images:
        img = normalize_image(raw)
        if mode == "spatial":
            probs = predictor.predict_spatial(img[None])[0]
        elif mode == "sliding":
            probs = predictor.predict_full_image(
                img, patch_size=patch_size, overlap=overlap,
                batch_size=inference_batch_size)
        else:
            probs = predictor.predict_images(img[None])[0]
        maps.append(probs.cpu().numpy())
    return maps


def predict_files(paths, model_path: str = "best_model.ckpt",
                  output_dir: str = "./predictions", patch_size: int = 512,
                  mode: str = "tiled", overlap: float = 0.5,
                  threshold: float = 0.5, inference_batch_size: int = 32,
                  compute_dtype=torch.bfloat16, tta: bool = False,
                  device="cuda"):
    """Run inference on image files; writes ``<stem>_prob.png`` and
    ``<stem>_mask.png`` per input and returns the probability maps."""
    from PIL import Image

    from jcfszxc_unet_tpu_torch.utils.vis import save_grayscale

    check_mode(mode, tta)
    predictor = Predictor.from_checkpoint(
        model_path, device=device, compute_dtype=compute_dtype,
        patch_size=patch_size, inference_batch_size=inference_batch_size,
        tta=tta)
    os.makedirs(output_dir, exist_ok=True)
    prob_maps = []
    for path in paths:
        (probs,) = predict_arrays(predictor, [np.asarray(Image.open(path))],
                                  mode, patch_size, overlap,
                                  inference_batch_size)
        stem = os.path.splitext(os.path.basename(path))[0]
        save_grayscale(probs, os.path.join(output_dir, f"{stem}_prob.png"))
        save_grayscale((probs > threshold).astype(np.float32),
                       os.path.join(output_dir, f"{stem}_mask.png"))
        logging.info(f"{path}: vessel fraction "
                     f"{float((probs > threshold).mean()):.4f}")
        prob_maps.append(probs)
    return prob_maps


def get_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Run a trained model on image files (no h5 needed; "
                    "PyTorch port)")
    parser.add_argument("inputs", nargs="+", help="Image files (tif/png/...)")
    parser.add_argument("--model", "-m", type=str, default="best_model.ckpt",
                        help="Checkpoint path (the port's, a JAX .ckpt or a "
                             "reference .pth)")
    parser.add_argument("--output-dir", "-o", type=str, default="./predictions",
                        help="Directory for <stem>_prob.png / <stem>_mask.png")
    parser.add_argument("--patch-size", "-p", type=int, default=512,
                        help="Patch size (tiled/sliding modes)")
    parser.add_argument("--mode", choices=list(MODES), default="tiled",
                        help="Inference protocol")
    parser.add_argument("--overlap", type=float, default=0.5,
                        help="Window overlap (sliding mode)")
    parser.add_argument("--threshold", type=float, default=0.5,
                        help="Binarization threshold for the mask output")
    parser.add_argument("--inference-batch-size", type=int, default=32,
                        help="Patch batch size")
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"], help="Compute dtype")
    parser.add_argument("--tta", action="store_true",
                        help="Dihedral-8 test-time augmentation "
                             "(8x compute; tiled/sliding modes)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (cuda, cuda:N or cpu)")
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    try:
        check_mode(args.mode, args.tta)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    predict_files(
        args.inputs, model_path=args.model, output_dir=args.output_dir,
        patch_size=args.patch_size, mode=args.mode, overlap=args.overlap,
        threshold=args.threshold,
        inference_batch_size=args.inference_batch_size,
        compute_dtype=(torch.bfloat16 if args.dtype == "bfloat16"
                       else torch.float32),
        tta=args.tta, device=args.device)


if __name__ == "__main__":
    main()
