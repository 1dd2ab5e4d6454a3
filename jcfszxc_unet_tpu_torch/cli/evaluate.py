"""Evaluation CLI of the port, counterpart of ``jcfszxc_unet_tpu/cli/evaluate.py``
(flags and defaults of reference evaluate.py:349-404): inference over the
test split by one of three protocols, FOV masking, per-image Dice and AUC,
and PNG artifacts.  The protocols: grid tiling with count-averaged
stitching (the default), ``--sliding-window`` (top-left-anchored windows
at ``--overlap``, on ``--num-images`` or ``--image-indices``) and
``--spatial`` (whole images, padded to a multiple of 32); ``--tta`` adds
dihedral-8 test-time augmentation to the two patch protocols.

``eval_model`` loads a split and calls :func:`evaluate_arrays`, which works
on arrays alone, so a caller without an h5 file runs the same code.  ``-m``
takes a port checkpoint, a JAX ``.ckpt`` or a reference ``.pth``
(``train.checkpoint.load_model_any``).

``--s2d`` evaluates FRUNet, MultiResUNet and NestedUNet in
space-to-depth execution (``ops/s2d.py``; same parameters): any
checkpoint of those models can opt in, and one trained with ``--s2d``
evaluates in that mode without the flag; another model exits naming the
three.

``--devices N`` evaluates over N ranks (``parallel/``); 0 (the default)
means every visible device of the ``--device`` kind, as in the JAX CLI.
N > 1 spawns N ranks (or joins torchrun's job, as the train CLI does).
The tiled protocol splits the patch grid over the ranks, as the JAX CLI
shards its tiles over a mesh; ``--sliding-window``, which takes no mesh
in JAX, splits the images over the ranks instead (each rank runs its
images' windows); ``--spatial`` splits each padded image's rows over the
ranks (``parallel/spatial.py``; H padded to a multiple of 32 N, as the
JAX CLI pads for its mesh), with ``--s2d`` too.  Rank 0 gathers the maps,
computes Dice and AUC and writes every output.  A collective waits
torch's default time before it fails the run (``--dist-timeout`` sets
it).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np
import torch

from jcfszxc_unet_tpu_torch.data.loading import (
    display_dataset_info,
    load_preprocessed_data,
    visualize_samples,
)
from jcfszxc_unet_tpu_torch.eval.metrics import (
    binary_dice,
    classification_metrics,
    roc_auc,
)
from jcfszxc_unet_tpu_torch.eval.predictor import Predictor
from jcfszxc_unet_tpu_torch.parallel.launch import rank_logging, spawn
from jcfszxc_unet_tpu_torch.parallel.mesh import (
    gather_rows,
    initialize_distributed,
    is_main,
    row_bounds,
    shutdown,
)
from jcfszxc_unet_tpu_torch.utils.device import (
    resolve_device,
    resolve_device_count,
)
from jcfszxc_unet_tpu_torch.utils.seed import set_seed

THRESHOLD_SWEEP = (0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 0.99)


def _check_protocol(sliding_window: bool, spatial: bool, tta: bool):
    if spatial and sliding_window:
        raise ValueError("--spatial and --sliding-window select different "
                         "evaluation protocols; pass at most one")
    if spatial and tta:
        raise ValueError("--tta needs square patches; it composes with the "
                         "tiled/sliding protocols, not --spatial")


def evaluate_arrays(model, images, masks, labels, patch_size: int = 256,
                    inference_batch_size: int = 32,
                    compute_dtype=torch.float32, compute_auc: bool = True,
                    threshold: float = 0.5, full_metrics: bool = False,
                    threshold_sweep: bool = False, sliding_window: bool = False,
                    overlap: float = 0.5, spatial: bool = False,
                    tta: bool = False, device="cuda", world=None):
    """One evaluation protocol on arrays: images (N, H, W, C), masks and
    labels (N, H, W), float in [0, 1].

    Tiled by default (grid centers at stride patch/2, count-averaged
    stitch); ``sliding_window``: windows at stride patch*(1-overlap), one
    image at a time; ``spatial``: whole images padded to a multiple of 32
    (32 x the ranks in H under a ``world``);
    ``tta``: dihedral-8 averaging of each patch.  Then sigmoid, FOV mask
    multiply, binarize > ``threshold``, per-image Dice (one fused
    ``dice_sums`` call) and AUC.  Returns a dict of host values:
    ``pred_maps`` (N, H, W) numpy, ``dice`` and ``auc`` lists, and the
    optional ``classification`` rows and ``threshold_sweep`` table.

    With a ``world``, this is one rank of a data-parallel evaluation (see
    the module doc): the maps are gathered, and rank 0 alone computes the
    metrics and returns them; the other ranks return an empty dict.
    """
    _check_protocol(sliding_window, spatial, tta)
    dev = world.device if world is not None else resolve_device(device)
    predictor = Predictor(model, compute_dtype=compute_dtype,
                          patch_size=patch_size,
                          inference_batch_size=inference_batch_size,
                          device=dev, tta=tta, world=world)
    images = torch.as_tensor(np.asarray(images, np.float32), device=dev)
    masks = torch.as_tensor(np.asarray(masks, np.float32), device=dev)
    labels = torch.as_tensor(np.asarray(labels, np.float32), device=dev)
    if spatial:
        pred_maps = predictor.predict_spatial(images)
    elif sliding_window:
        start, stop = row_bounds(images.shape[0], world)
        pred_maps = gather_rows(torch.stack([
            predictor.predict_full_image(image, patch_size, overlap,
                                         inference_batch_size)
            for image in images[start:stop]]) if stop > start
            else masks.new_zeros((0,) + masks.shape[1:]),
            images.shape[0], world)
    else:
        pred_maps = predictor.predict_images(images)
    if not is_main(world):
        return {}
    pred_maps = pred_maps * masks  # evaluate.py:309
    result = {}
    if compute_auc:
        result["auc"] = [float(roc_auc(pred_maps[i], labels[i], masks[i]))
                         for i in range(pred_maps.shape[0])]
    binary = (pred_maps > threshold).float()
    result["dice"] = binary_dice(binary, labels).tolist()
    if full_metrics:
        result["classification"] = [
            [float(v) for v in classification_metrics(binary[i], labels[i],
                                                      masks[i])]
            for i in range(pred_maps.shape[0])]
    if threshold_sweep:
        result["threshold_sweep"] = [
            (th, float(binary_dice((pred_maps > th).float(), labels).mean()))
            for th in THRESHOLD_SWEEP]
    result["pred_maps"] = pred_maps.cpu().numpy()
    return result


def eval_model(model, output_dir: str,
               input_data: str = "./data/test_eye_dataset.h5",
               seed: int = 42, patch_size: int = 256,
               inference_batch_size: int = 32, compute_dtype=torch.float32,
               visualize: bool = True, compute_auc: bool = True,
               error_panels: bool = False, full_metrics: bool = False,
               threshold: float = 0.5, threshold_sweep: bool = False,
               metrics_json: str | None = None, sliding_window: bool = False,
               overlap: float = 0.5, num_images=None, image_indices=None,
               spatial: bool = False, tta: bool = False, device="cuda",
               world=None):
    """Evaluation of a preprocessed split; returns (mean_dice,
    per_image_dice, mean_auc) like the JAX ``eval_model``.  With
    ``sliding_window`` only the images ``image_indices`` (or the first
    ``num_images``) are evaluated, as in the JAX version.  As one rank of
    a ``world`` every rank loads the split and predicts its share; rank 0
    alone prints and writes, and the other ranks return None."""
    main = is_main(world)
    if world is None:
        resolve_device(device)
    set_seed(seed)
    dataset = load_preprocessed_data(input_data)
    if main:
        display_dataset_info(dataset)
        if visualize:
            visualize_samples(dataset, num_samples=3)
    images = np.asarray(dataset["images"], np.float32)
    masks = np.asarray(dataset["masks"], np.float32)
    labels = np.asarray(dataset["labels"], np.float32)
    if sliding_window:
        if image_indices:
            sel = list(image_indices)
        elif num_images:
            sel = list(range(min(int(num_images), images.shape[0])))
        else:
            sel = list(range(images.shape[0]))
        images, masks, labels = images[sel], masks[sel], labels[sel]
    res = evaluate_arrays(
        model, images, masks, labels, patch_size=patch_size,
        inference_batch_size=inference_batch_size,
        compute_dtype=compute_dtype, compute_auc=compute_auc,
        threshold=threshold, full_metrics=full_metrics,
        threshold_sweep=threshold_sweep, sliding_window=sliding_window,
        overlap=overlap, spatial=spatial, tta=tta, device=device,
        world=world)
    if not main:
        return None
    dice_scores, aucs = res["dice"], res.get("auc", [])
    if visualize:
        from jcfszxc_unet_tpu_torch.utils.vis import (
            save_error_panel,
            save_grayscale,
            save_triptych,
        )

        for i, pred_img in enumerate(res["pred_maps"]):
            save_grayscale(pred_img, f"demo/prediction_{i}.png")
            save_grayscale(labels[i], f"demo/label_{i}.png")
            save_triptych(images[i], pred_img, labels[i],
                          f"{output_dir}/prediction_{i}.png")
            if error_panels:
                save_error_panel(images[i], labels[i], pred_img,
                                 f"{output_dir}/errors_{i}.png")
    if threshold_sweep:
        print("Threshold sweep (mean Dice):")
        rows = res["threshold_sweep"]
        best_th, best_d = max(rows, key=lambda r: r[1])
        for th, d in rows:
            mark = "  <- best" if th == best_th else ""
            print(f"  threshold {th:.2f}: Dice {d:.4f}{mark}")

    mean_dice = float(np.mean(dice_scores)) if dice_scores else 0.0
    print(f"Average Dice Score: {mean_dice:.4f}")
    if aucs:
        print(f"Average AUC: {float(np.mean(aucs)):.4f}")
    cls_rows = res.get("classification")
    if cls_rows:
        acc, se, sp = np.mean(np.asarray(cls_rows), axis=0)
        print(f"Average Accuracy: {acc:.4f}")
        print(f"Average Sensitivity: {se:.4f}")
        print(f"Average Specificity: {sp:.4f}")
    if metrics_json:
        rec = {"mean_dice": mean_dice,
               "per_image_dice": [float(d) for d in dice_scores],
               "threshold": threshold, "n_images": len(dice_scores)}
        if aucs:
            rec["mean_auc"] = float(np.mean(aucs))
            rec["per_image_auc"] = [float(a) for a in aucs]
        if cls_rows:
            rec["accuracy"], rec["sensitivity"], rec["specificity"] = (
                float(v) for v in np.mean(np.asarray(cls_rows), axis=0))
        if threshold_sweep:
            best_th, best_d = max(res["threshold_sweep"], key=lambda r: r[1])
            rec["threshold_sweep"] = {"rows": res["threshold_sweep"],
                                      "best_threshold": best_th,
                                      "best_dice": best_d}
        with open(metrics_json, "w") as f:
            f.write(json.dumps(rec) + "\n")
    return mean_dice, dice_scores, (float(np.mean(aucs)) if aucs else None)


def get_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Predict on full images using the trained model")
    parser.add_argument("--model", "-m", type=str, default="best_model.ckpt",
                        help="Path to the model checkpoint: the port's, a "
                             "JAX .ckpt or a reference .pth")
    parser.add_argument("--data-file", "-d", type=str,
                        default="./data/test_eye_dataset.h5",
                        help="Path to the h5 dataset")
    parser.add_argument("--output-dir", "-o", type=str,
                        default="./predictions",
                        help="Directory to save predictions")
    parser.add_argument("--batch-size", "-b", type=int, default=4,
                        help="Batch size for prediction")
    parser.add_argument("--patch-size", "-p", type=int, default=512,
                        help="Size of patches for prediction")
    parser.add_argument("--spatial", action="store_true",
                        help="Whole-image forward, padded to a multiple of "
                             "32 (no tiling or stitching); under --devices "
                             "N > 1 each image's rows are split over the "
                             "ranks, H padded to a multiple of 32 N")
    parser.add_argument("--s2d", action="store_true",
                        help="Space-to-depth execution of the narrow blocks "
                             "(FRUNet, MultiResUNet, NestedUNet; same "
                             "parameters)")
    parser.add_argument("--sliding-window", action="store_true",
                        help="Use the sliding-window predictor "
                             "(predict_full_image protocol) driven by "
                             "--overlap/--num-images/--image-indices; "
                             "under --devices N > 1 the images are split "
                             "over the ranks (the JAX CLI runs this "
                             "protocol on one device)")
    parser.add_argument("--overlap", type=float, default=0.5,
                        help="Overlap between patches (0-1; sliding-window "
                             "predictor only)")
    parser.add_argument("--num-images", "-n", type=int, default=5,
                        help="Number of images to process (sliding-window "
                             "predictor only)")
    parser.add_argument("--image-indices", "-i", type=str, default=None,
                        help="Comma-separated image indices (sliding-window "
                             "predictor only)")
    parser.add_argument("--inference-batch-size", type=int, default=32,
                        help="Batch size for inference")
    parser.add_argument("--dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"], help="Compute dtype")
    parser.add_argument("--devices", type=int, default=0,
                        help="Shard the tiles (--spatial: the rows) over "
                             "this many ranks (0 = every visible device of "
                             "the --device kind: the visible cards, or 1 "
                             "on the CPU)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on (cuda, cuda:N or cpu)")
    parser.add_argument("--dist-timeout", type=float, default=None,
                        metavar="SECONDS",
                        help="With --devices > 1: the seconds a collective "
                             "may wait before the run fails (default: "
                             "torch's, 10 min for NCCL, 30 for gloo)")
    parser.add_argument("--error-panels", action="store_true",
                        help="Also write TP/FP/FN color-coded panels")
    parser.add_argument("--threshold", type=float, default=0.5,
                        help="Binarization threshold for Dice and "
                             "--full-metrics (reference uses 0.5)")
    parser.add_argument("--tta", action="store_true",
                        help="Dihedral-8 test-time augmentation: average "
                             "probabilities over all flips/rotations of "
                             "each patch (8x compute; tiled/sliding only)")
    parser.add_argument("--full-metrics", action="store_true",
                        help="Also report FOV accuracy/sensitivity/"
                             "specificity")
    parser.add_argument("--metrics-json", type=str, default=None,
                        help="Write the final metrics as one JSON object to "
                             "this path")
    parser.add_argument("--threshold-sweep", action="store_true",
                        help="Also print mean Dice across binarization cuts "
                             "(0.3-0.99) from the same probability maps")
    return parser.parse_args(argv)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = get_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    world = initialize_distributed(  # torchrun's job
        device=args.device, timeout_s=args.dist_timeout)
    n = (world.size if world is not None
         else resolve_device_count(args.devices, args.device))
    try:
        _check_protocol(args.sliding_window, args.spatial, args.tta)
    except ValueError as e:
        shutdown(world)
        raise SystemExit(str(e)) from None
    if world is None and n > 1:
        spawn(_rank_main, n, argv, device=args.device,
              timeout_s=args.dist_timeout)
        return
    try:
        run(args, world)
    finally:
        shutdown(world)


def _rank_main(world, argv):
    """One spawned rank of ``main``."""
    rank_logging(world)
    run(get_args(argv), world)


def run(args, world=None):
    """The CLI's evaluation from parsed ``args``, in this process or as
    one rank of ``world``."""
    device = world.device if world is not None else resolve_device(
        args.device)
    if is_main(world):
        os.makedirs(args.output_dir, exist_ok=True)
        os.makedirs("demo", exist_ok=True)
    logging.info(f"Using device: {device}")
    from jcfszxc_unet_tpu_torch.train.checkpoint import (
        load_model_any,
        opt_in_s2d,
    )

    logging.info(f"Loading model from {args.model}")
    model, config = load_model_any(args.model, device,
                                   patch_size=args.patch_size)
    if args.s2d:
        try:
            model, _ = opt_in_s2d(model, config)
        except ValueError as e:
            raise SystemExit(str(e)) from None
    eval_model(
        model=model,
        input_data=args.data_file,
        inference_batch_size=args.inference_batch_size,
        output_dir=args.output_dir,
        patch_size=args.patch_size,
        compute_dtype=(torch.bfloat16 if args.dtype == "bfloat16"
                       else torch.float32),
        error_panels=args.error_panels,
        full_metrics=args.full_metrics,
        threshold=args.threshold,
        threshold_sweep=args.threshold_sweep,
        metrics_json=args.metrics_json,
        sliding_window=args.sliding_window,
        overlap=args.overlap,
        num_images=args.num_images if args.sliding_window else None,
        image_indices=(
            [int(s) for s in args.image_indices.split(",")]
            if (args.sliding_window and args.image_indices) else None),
        spatial=args.spatial,
        tta=args.tta,
        device=device,
        world=world,
    )


if __name__ == "__main__":
    main()
