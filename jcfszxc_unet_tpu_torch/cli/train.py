"""Training CLI of the port, counterpart of ``jcfszxc_unet_tpu/cli/train.py``
(flags and defaults of reference train.py:419-487, plus ``--model``,
``--dtype`` and ``--device``).

``train_model`` loads a preprocessed split and calls :func:`train_arrays`,
which holds the epoch loop and works on arrays alone, so a caller without
an h5 file runs the same code.  Per epoch: ``steps`` train steps on
patches sampled on the device, the optional precise-BN pass, one
validation pass through the eval-mode kernels, the plateau scheduler,
best-checkpoint-on-improvement, early stopping, the epoch line,
``--metrics-file``, ``--latest-path`` and PNG artifacts.

``--logit-head`` makes a model that ends in a sigmoid (BCDU_net_D3/D1,
TransFuseNet) or in a softmax over one channel (BARUNet, BIARUNet) return
the head before it, recorded in the checkpoint's ``model_kwargs``; other
models exit with the list of those that take it.  BCDU models get
``N`` = the patch size, as in the JAX CLI.  Not ported yet, refused with a
message that says so: ``--devices`` > 1, ``--s2d``, ``--profile-dir`` and
``--remat``.

``--load`` takes a port checkpoint, a JAX ``.ckpt`` or a reference ``.pth``
(``train.checkpoint.load_model_any``); ``--resume`` needs a port checkpoint
(``--latest-path``), since a JAX file's optax state is not mapped to the
port's RMSprop.  Checkpoints are written in the background
(``train.checkpoint.AsyncCheckpointWriter``: snapshot on the device at the
end of the epoch, host copy and disk write on a worker thread);
``--sync-checkpoints`` writes them on the training loop instead.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
import time

import numpy as np
import torch

from jcfszxc_unet_tpu_torch.data.loading import (
    display_dataset_info,
    load_preprocessed_data,
    visualize_samples,
)
from jcfszxc_unet_tpu_torch.data.sampler import (
    build_grid_sample_map,
    build_train_sample_map,
)
from jcfszxc_unet_tpu_torch.models import (
    MODEL_REGISTRY,
    create_model,
    logit_head_capable,
    model_takes,
    registry_name,
)
from jcfszxc_unet_tpu_torch.train import checkpoint as ckpt
from jcfszxc_unet_tpu_torch.train.optim import (
    ReduceLROnPlateau,
    get_current_lr,
    make_optimizer,
    set_current_lr,
)
from jcfszxc_unet_tpu_torch.train.state import TrainState
from jcfszxc_unet_tpu_torch.train.trainer import (
    build_val_patches,
    make_epoch_fn,
    make_precise_bn_fn,
    make_val_fn,
)
from jcfszxc_unet_tpu_torch.utils.device import resolve_device
from jcfszxc_unet_tpu_torch.utils.profiling import Throughput
from jcfszxc_unet_tpu_torch.utils.seed import set_seed

DATA_SEED_OFFSET = 0xDA7A  # the sampling generator's seed is seed + this


def bn_saturation_signature(dice_history, mean_prob=None,
                            peak=0.3, floor=0.05):
    """True when the val Dice just collapsed to ~0 (<= ``floor``) after an
    earlier epoch exceeded ``peak``: the eval-mode logit saturation that
    lagging BatchNorm running statistics cause while train mode still
    learns.  Fires on the transition only; ``mean_prob`` (the val set's
    mean sigmoid output), when given, must be saturated (<= 0.05 or
    >= 0.95)."""
    if len(dice_history) < 2 or dice_history[-1] > floor:
        return False
    if not all(math.isfinite(d) for d in dice_history):
        return False  # NaN dices are the NaN guard's domain, not BN lag
    if dice_history[-2] <= floor:
        return False  # already collapsed: warned at the transition
    if max(dice_history[:-1]) < peak:
        return False  # never learned: not the saturation signature
    if mean_prob is not None and 0.05 < mean_prob < 0.95:
        return False  # eval outputs are not saturated: another failure
    return True


def split_indices(n_samples: int, val_percent: float):
    """(val_idx, train_idx) by the host RNG protocol of train.py:79: a
    numpy shuffle right after the seed is set."""
    n_val = int(n_samples * val_percent)
    indices = np.arange(n_samples)
    np.random.shuffle(indices)
    return indices[:n_val], indices[n_val:]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_arrays(model, images, masks, labels, *,
                 model_name: str = "UNet.UNet", model_kwargs=None,
                 steps: int = 100, batch_size: int = 32,
                 learning_rate: float = 1e-6, val_percent: float = 0.1,
                 patch_size: int = 128, weight_decay: float = 1e-8,
                 momentum: float = 0.999, seed: int = 42,
                 early_stopping_patience: int = 20,
                 save_path: str = "best_model.ckpt",
                 compute_dtype=torch.bfloat16, max_epochs: int | None = None,
                 visualize: bool = True, latest_path: str | None = None,
                 resume_from: str | None = None, precise_bn: int = 0,
                 augment: bool = False, metrics_file: str | None = None,
                 async_checkpoints: bool = True, device="cuda"):
    """The reference training protocol on arrays: images (N, H, W, C),
    masks and labels (N, H, W), float in [0, 1].

    Shuffled val split, FOV-guided random patches, 1/2 BCE + 1/2 Dice,
    clipped RMSprop with the plateau schedule, early stopping on the val
    Dice, best checkpoint on improvement.  ``model`` is trained in place
    on ``device``.  With ``async_checkpoints`` an epoch's checkpoints
    (best and ``latest_path``) go to the background writer as one
    submission at the epoch's end; all are on disk when this returns.
    Returns ``{"best_dice", "history"}``, one history record per epoch
    (the ``--metrics-file`` fields plus the seconds of
    the train steps and of the validation pass, each ending in a device
    sync).
    """
    dev = resolve_device(device)
    model_kwargs = dict(model_kwargs or {})
    set_seed(seed)
    val_idx, train_idx = split_indices(len(images), val_percent)
    n_val = len(val_idx)

    images = np.asarray(images, np.float32)
    masks = np.asarray(masks, np.float32)
    labels = np.asarray(labels, np.float32)[..., None]

    half_patch = patch_size // 2
    train_map = build_train_sample_map(masks[train_idx], half_patch)
    n, h, w = masks[val_idx].shape if n_val else (0, *masks.shape[1:])
    val_map = build_grid_sample_map(n, h, w, half_patch)

    logging.info(
        f"Starting training:\n"
        f"  Batch size:      {batch_size}\n"
        f"  Learning rate:   {learning_rate}\n"
        f"  Training size:   {len(train_idx)}\n"
        f"  Validation size: {n_val}\n"
        f"  Patch size:      {patch_size}\n"
        f"  Steps/epoch:     {steps}\n"
        f"  Device:          {dev}\n"
        f"  Compute dtype:   {str(compute_dtype).split('.')[-1]}")

    # Device-resident pools and sample map; the val patches are cut once.
    train_images = torch.as_tensor(images[train_idx], device=dev)
    train_labels = torch.as_tensor(labels[train_idx], device=dev)
    train_map_dev = torch.as_tensor(train_map, device=dev).long()
    val_imgs, val_labs = build_val_patches(
        images[val_idx], labels[val_idx], val_map, patch_size, device=dev)

    model = model.to(device=dev, memory_format=torch.channels_last)
    model.train()
    optimizer = make_optimizer(model.parameters(), learning_rate,
                               weight_decay, momentum)
    state = TrainState(model=model, optimizer=optimizer)
    epoch_fn = make_epoch_fn(
        n_classes=model.n_classes, batch_size=batch_size,
        patch_size=patch_size, steps=steps, compute_dtype=compute_dtype,
        augment=augment)
    val_fn = make_val_fn(model, compute_dtype=compute_dtype)
    precise_bn_fn = make_precise_bn_fn(
        batch_size=batch_size, patch_size=patch_size, k_batches=precise_bn,
        compute_dtype=compute_dtype) if precise_bn else None
    scheduler = ReduceLROnPlateau(factor=0.7, patience=5, threshold=0.01,
                                  cooldown=2)

    best_dice = 0.0
    patience_counter = 0
    epoch = 0
    dice_history = []
    history = []

    # Exact resume from a --latest-path checkpoint: optimizer, scheduler
    # and progress (the params come from --load).
    if resume_from:
        extra = ckpt.load_extra(resume_from)
        if extra and "optimizer" in extra:
            optimizer.load_state_dict(extra["optimizer"])
            prog = extra.get("progress", {})
            epoch = int(prog.get("epoch", 0))
            best_dice = float(prog.get("best_dice", 0.0))
            patience_counter = int(prog.get("patience_counter", 0))
            scheduler.best = float(prog.get("scheduler_best", float("-inf")))
            scheduler.num_bad_epochs = int(prog.get("scheduler_bad", 0))
            scheduler.cooldown_counter = int(
                prog.get("scheduler_cooldown", 0))
            logging.info(f"Resumed full training state from {resume_from} "
                         f"(epoch {epoch}, best dice {best_dice:.4f})")

    generator = torch.Generator(device=dev).manual_seed(
        seed + DATA_SEED_OFFSET)
    throughput = Throughput()  # steady-state patches/s, first epoch dropped

    # An epoch's checkpoints (best, then --latest-path) share one snapshot
    # of the weights, taken when the epoch's last one is queued; with the
    # writer that is one submission, so the epoch never waits on a write
    # of its own.
    writer = ckpt.AsyncCheckpointWriter() if async_checkpoints else None
    saves = []  # this epoch's (path, extra)

    def write_all(jobs, state_dict):
        for path, extra in jobs:
            ckpt.save_state(path, model_name, model_kwargs, state_dict, extra)

    def flush_saves():
        if not saves:
            return
        jobs, saves[:] = list(saves), []
        if writer is None:
            write_all(jobs, model.state_dict())
        else:
            writer.submit(write_all, jobs, model.state_dict())

    try:
        while True:
            epoch += 1
            if max_epochs is not None and epoch > max_epochs:
                break
            _sync(dev)
            t0 = time.perf_counter()
            train_metrics = epoch_fn(state, train_images, train_labels,
                                     train_map_dev, generator)
            if precise_bn_fn is not None:
                precise_bn_fn(model, train_images, train_map_dev, generator)
            _sync(dev)
            t1 = time.perf_counter()
            metrics, probs = val_fn(val_imgs, val_labs)
            dice = float(metrics["dice"])  # syncs
            t2 = time.perf_counter()
            epoch_loss = float(train_metrics["epoch_loss"])
            skipped = int(train_metrics["skipped"])
            dice_avg = float(metrics["dice_avg"])
            pps = throughput.tick(steps * batch_size)

            dice_history.append(dice)
            mean_prob = float(probs.mean()) if n_val else None
            if bn_saturation_signature(dice_history, mean_prob):
                logging.warning(
                    f"Validation Dice collapsed to {dice:.3f} after reaching "
                    f"{max(dice_history[:-1]):.3f} with the val set's mean "
                    f"sigmoid output at "
                    f"{'n/a' if mean_prob is None else f'{mean_prob:.3f}'}"
                    " — the signature of BN running-statistics lag (eval-mode "
                    "logit saturation; the train-mode forward is still "
                    "learning)."
                    + ("" if precise_bn else
                       "  Re-run with --precise-bn 8 to recalibrate the "
                       "running stats each epoch."))

            lr = get_current_lr(optimizer)
            new_lr = scheduler.step(dice, lr)
            if new_lr != lr:
                set_current_lr(optimizer, new_lr)
                logging.info(f"Plateau scheduler: lr {lr:.2e} -> {new_lr:.2e}")

            stop = False
            if dice > best_dice:
                best_dice = dice
                patience_counter = 0
                saves.append((save_path, None))
            else:
                patience_counter += 1
                print(f"Dice score did not improve. Patience: "
                      f"{patience_counter}/{early_stopping_patience}")
                if patience_counter >= early_stopping_patience:
                    print(f"Early stopping triggered after {epoch} epochs. "
                          f"Best dice score: {best_dice:.4f}")
                    stop = True

            record = {"epoch": epoch, "lr": new_lr,
                      "loss": epoch_loss / steps, "dice": dice,
                      "dice_avg": dice_avg, "best_dice": best_dice,
                      "patches_per_sec": pps, "skipped_steps": skipped,
                      "train_seconds": t1 - t0, "val_seconds": t2 - t1}
            history.append(record)
            if stop:
                break

            print(f"Epoch {epoch} - "
                  f"LR: {new_lr:.2e} - "
                  f"Loss: {epoch_loss / steps:.4g} - "
                  f"Dice: {dice:.4g} - "
                  f"Avg Dice: {dice_avg:.4g} - "
                  f"Best Dice: {best_dice:.4g}"
                  + ((f" - {pps:.1f} patches/s" if pps < 10 else
                      f" - {pps:.0f} patches/s") if pps else "")
                  + (f" - skipped {skipped} NaN steps" if skipped else ""))

            if latest_path:
                saves.append((latest_path, {
                    "optimizer": optimizer.state_dict(),
                    "progress": {
                        "epoch": epoch,
                        "best_dice": best_dice,
                        "patience_counter": patience_counter,
                        "scheduler_best": scheduler.best,
                        "scheduler_bad": scheduler.num_bad_epochs,
                        "scheduler_cooldown": scheduler.cooldown_counter,
                    }}))

            if metrics_file:
                with open(metrics_file, "a") as f:
                    f.write(json.dumps({k: record[k] for k in (
                        "epoch", "lr", "loss", "dice", "dice_avg", "best_dice",
                        "patches_per_sec", "skipped_steps")}) + "\n")

            if visualize and n_val:
                from jcfszxc_unet_tpu_torch.utils.vis import save_triptych

                sample_num = min(100, val_imgs.shape[0] - 1)
                save_triptych(
                    val_imgs[sample_num].cpu().numpy(),
                    probs[sample_num, ..., 0].cpu().numpy(),
                    val_labs[sample_num, ..., 0].cpu().numpy(),
                    f"visualizations/{epoch:03d}_{sample_num:03d}.png")
            flush_saves()  # one snapshot, one submission per epoch
    finally:
        flush_saves()  # the saves of an epoch that stopped early
        if writer is not None:
            writer.close()  # re-raises a failed write; files on disk
    return {"best_dice": best_dice, "history": history}


def train_model(model, model_name: str, model_kwargs: dict,
                input_data: str = "./data/train_eye_dataset.h5",
                seed: int = 42, visualize: bool = True, **kwargs):
    """Load a preprocessed split and run :func:`train_arrays` on it;
    returns the best val Dice, like the JAX ``train_model``."""
    set_seed(seed)
    dataset = load_preprocessed_data(input_data)
    display_dataset_info(dataset)
    if visualize:
        visualize_samples(dataset, num_samples=3)
    result = train_arrays(
        model, dataset["images"], dataset["masks"], dataset["labels"],
        model_name=model_name, model_kwargs=model_kwargs, seed=seed,
        visualize=visualize, **kwargs)
    return result["best_dice"]


def get_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Train a UNet-family model on DRIVE patches "
                    "(PyTorch port)")
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
    parser.add_argument("--save-path", type=str, default="best_model.ckpt",
                        help="Best-checkpoint output path")
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"],
                        help="Compute dtype (params stay float32)")
    parser.add_argument("--devices", type=int, default=0,
                        help="Number of devices (only 1 is ported; 0 = 1)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (cuda, cuda:N or cpu)")
    parser.add_argument("--max-epochs", type=int, default=0,
                        help="Optional epoch cap (0 = until early stopping)")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="Write a profiler trace here (not ported yet)")
    parser.add_argument("--remat", action="store_true",
                        help="Rematerialize activations in the backward "
                             "pass (not ported yet)")
    parser.add_argument("--metrics-file", type=str, default=None,
                        help="Append one JSON object per epoch here "
                             "(machine-readable mirror of the epoch line)")
    parser.add_argument("--augment", action="store_true",
                        help="Per-sample random flips/90-degree rotations "
                             "on training patches (the reference trains "
                             "un-augmented)")
    parser.add_argument("--s2d", action="store_true",
                        help="Space-to-depth execution (not ported yet)")
    parser.add_argument("--logit-head", action="store_true",
                        help="Train the models whose forward ends in a "
                             "sigmoid or in a softmax over one channel on "
                             "the head before it; supported: "
                             + ", ".join(logit_head_capable()))
    parser.add_argument("--latest-path", type=str, default=None,
                        help="Also save the FULL training state (optimizer "
                             "+ scheduler + progress) here every epoch")
    parser.add_argument("--resume", type=str, default=None,
                        help="Exact-resume from a --latest-path checkpoint "
                             "of the port (implies loading its params too)")
    parser.add_argument("--precise-bn", type=int, default=0, metavar="K",
                        help="After each epoch, re-estimate the BN running "
                             "statistics as the mean of pure batch "
                             "statistics over K fresh training batches "
                             "(off by default, not in the reference)")
    parser.add_argument("--sync-checkpoints", action="store_true",
                        help="Block training on each checkpoint write. "
                             "Default (background) overlaps the host copy "
                             "and the disk write with the next epoch, so a "
                             "hard kill (SIGKILL/OOM) can lose the last "
                             "epoch's queued best/latest writes; pass this "
                             "flag for strict durability")
    return parser.parse_args(argv)


def main(argv=None):
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    for flag, on in (("--devices > 1", args.devices > 1),
                     ("--s2d", args.s2d), ("--profile-dir", args.profile_dir),
                     ("--remat", args.remat)):
        if on:
            raise SystemExit(
                f"{flag} is not ported to PyTorch yet; the port trains "
                f"{', '.join(sorted(MODEL_REGISTRY))} on one device")
    device = resolve_device(args.device)
    logging.info(f"Using device: {device}")
    compute_dtype = (torch.bfloat16 if args.dtype == "bfloat16"
                     else torch.float32)

    if args.resume and ckpt.checkpoint_format(args.resume) == "jax":
        raise SystemExit(
            f"{args.resume} is a JAX .ckpt: --load takes it, --resume needs "
            f"a port checkpoint (its optax state is not mapped to RMSprop)")
    if args.resume and not args.load:
        args.load = args.resume  # --resume implies loading params from it
    model = None
    if args.load:
        model, cfg = ckpt.load_model_any(args.load, device,
                                         patch_size=args.patch_size)
        model_name = cfg["model_name"]
        model_kwargs = ckpt.port_kwargs(cfg["model_kwargs"])
        logging.info(f"Model loaded from {args.load}")
    else:
        try:
            model_name, model_kwargs = registry_name(args.model), {}
        except KeyError as e:
            raise SystemExit(str(e)) from None
        if model_takes(model_name, "N"):
            model_kwargs["N"] = args.patch_size  # reference train.py:518
    if args.logit_head and not model_kwargs.get("logit_head"):
        # a forward flag over the same parameters: it composes with --load
        # and is recorded for the eval CLI
        if not model_takes(model_name, "logit_head"):
            raise SystemExit(
                f"--logit-head is not supported by {model_name} (its "
                "forward already returns logits); supported: "
                + ", ".join(logit_head_capable()))
        model_kwargs["logit_head"] = True
        if model is not None:
            model.logit_head = True
    if model is None:
        from jcfszxc_unet_tpu_torch.ops.layers import reset_parameters

        model = create_model(model_name, **model_kwargs)
        reset_parameters(model, set_seed(args.seed))

    logging.info(f"Network:\n\t{model.n_channels} input channels\n"
                 f"\t{model.n_classes} output channels (classes)\n")
    os.makedirs("visualizations", exist_ok=True)
    train_model(
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
        save_path=args.save_path,
        compute_dtype=compute_dtype,
        max_epochs=args.max_epochs or None,
        latest_path=args.latest_path,
        resume_from=args.resume,
        precise_bn=args.precise_bn,
        augment=args.augment,
        metrics_file=args.metrics_file,
        async_checkpoints=not args.sync_checkpoints,
        device=device,
    )


if __name__ == "__main__":
    main()
