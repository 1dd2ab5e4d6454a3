"""Fractal-training CLI of the port, counterpart of
``jcfszxc_unet_tpu/cli/train_demo.py`` (reference train-demo.py:667-735,
whose flags clone train.py's), plus ``--device``.

Trains a model together with the fractal input-enhancement CNN on
multi-scale patches, with the FOV masks as targets and whole-image
validation (``train/fractal.py``); writes ``best_model.ckpt`` and the
``best_fractal_model.ckpt`` bundle in the working directory, in the
background unless ``--sync-checkpoints`` is given.  ``--load``
takes the port's file, a JAX ``.ckpt`` or a reference ``.pth``
(``train.checkpoint.load_model_any``) and trains its weights.

The JAX CLI enables its XLA compile cache here; the port's counterpart is
the nvcc build cache of ``ops/kernels/build.py``, which needs no flag.
"""

from __future__ import annotations

import argparse
import logging
import os

import torch

from jcfszxc_unet_tpu_torch.models import (
    MODEL_REGISTRY,
    create_model,
    registry_name,
)
from jcfszxc_unet_tpu_torch.train import checkpoint as ckpt
from jcfszxc_unet_tpu_torch.train.fractal import (
    train_with_fractal_optimization,
)
from jcfszxc_unet_tpu_torch.utils.device import resolve_device
from jcfszxc_unet_tpu_torch.utils.seed import set_seed


def get_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Train a UNet with fractal optimization (PyTorch port)")
    parser.add_argument("--data-file", "-d", type=str,
                        default="./data/train_eye_dataset.h5",
                        help="Path to the h5 dataset")
    parser.add_argument("--batch-size", "-b", dest="batch_size", metavar="B",
                        type=int, default=32, help="Batch size")
    parser.add_argument("--learning-rate", "-l", metavar="LR", type=float,
                        default=1e-6, help="Learning rate", dest="lr")
    parser.add_argument("--load", "-f", type=str, default=False,
                        help="Load the model from a checkpoint: the port's, "
                             "a JAX .ckpt or a reference .pth")
    parser.add_argument("--validation", "-v", dest="val", type=float,
                        default=10.0,
                        help="Percent of the data used as validation (0-100)")
    parser.add_argument("--patch-size", "-p", dest="patch_size", type=int,
                        default=128, help="Size of training patches")
    parser.add_argument("--steps", "-s", type=int, default=100,
                        help="Number of steps per epoch")
    parser.add_argument("--seed", type=int, default=42, help="Random seed")
    parser.add_argument("--early-stopping-patience", "-esp",
                        dest="early_stopping_patience", type=int, default=20,
                        help="Epochs with no improvement before stopping")
    parser.add_argument("--model", "-m", type=str, default="UNet.UNet",
                        help="Registry model name; ported: "
                             + ", ".join(sorted(MODEL_REGISTRY)))
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"],
                        help="Compute dtype (params stay float32)")
    parser.add_argument("--max-epochs", type=int, default=0,
                        help="Optional epoch cap (0 = until early stopping)")
    parser.add_argument("--sync-checkpoints", action="store_true",
                        help="Block training on each checkpoint write, as "
                             "cli/train.py's flag does. Default (background) "
                             "overlaps the host copy and the disk write with "
                             "the next epoch, so a hard kill (SIGKILL/OOM) "
                             "can lose the last queued best-model writes; "
                             "pass this flag for strict durability")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (cuda, cuda:N or cpu)")
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    if not args.load:
        try:
            model_name = registry_name(args.model)
        except KeyError as e:
            raise SystemExit(str(e)) from None
    device = resolve_device(args.device)
    logging.info(f"Using device: {device}")
    compute_dtype = (torch.bfloat16 if args.dtype == "bfloat16"
                     else torch.float32)

    if args.load:
        model, cfg = ckpt.load_model_any(args.load, device,
                                         patch_size=args.patch_size)
        model_name = cfg["model_name"]
        model_kwargs = ckpt.port_kwargs(cfg["model_kwargs"])
        logging.info(f"Model loaded from {args.load}")
    else:
        from jcfszxc_unet_tpu_torch.ops.layers import reset_parameters

        model_kwargs = {}
        model = create_model(model_name)
        reset_parameters(model, set_seed(args.seed))

    logging.info(f"Network:\n\t{model.n_channels} input channels\n"
                 f"\t{model.n_classes} output channels (classes)\n")
    os.makedirs("visualizations", exist_ok=True)
    train_with_fractal_optimization(
        model=model,
        model_name=model_name,
        model_kwargs=model_kwargs,
        input_data=args.data_file,
        steps=args.steps,
        batch_size=args.batch_size,
        learning_rate=args.lr,
        val_percent=args.val / 100,
        patch_size=args.patch_size,
        seed=args.seed,
        early_stopping_patience=args.early_stopping_patience,
        compute_dtype=compute_dtype,
        max_epochs=args.max_epochs or None,
        async_checkpoints=not args.sync_checkpoints,
        device=device,
    )


if __name__ == "__main__":
    main()
