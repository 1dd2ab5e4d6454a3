"""Fractal-optimization trainer, counterpart of
``jcfszxc_unet_tpu/train/fractal.py`` (the reference's experimental
``train-demo.py``): multi-scale "fractal" patch sampling, a trainable
input-enhancement CNN and a box-counting fractal-dimension loss.

What differs in mechanism from the JAX package:

  * An epoch is a Python loop of steps (the JAX package scans them in one
    program).  Each step draws its centers on the device from an explicit
    generator (``data.sampler.sample_centers`` per level), then gathers
    and resizes
    the patches (:func:`fractal_sample_batch`), so a test can feed the
    JAX package's centers to the gather.
  * The NaN guard reads ``isfinite(loss)`` on the host after the backward
    and skips the update, as the port's trainer does; the JAX step selects
    the old state.  Parameters and optimizer state agree.
  * Validation runs the eval-mode forward of the extractor and the model
    on whole images in chunks under ``torch.inference_mode()``: the
    extractor's two undilated 3x3 convs (one launch, their weights
    stacked) and every stride-1 3x3 conv of the model go through the
    ``conv3x3_affine_relu`` kernel, and the Dice through one ``dice_sums``
    launch.  The train step runs stock ops.

Reference quirks kept, as in the JAX package: the FOV *masks* are the
training targets and the validation truth; FractalLoss's Dice is the
global 1 - 2*sum(p*t)/(sum(p + t) + 1e-8); validation samples
min(200, V) whole images; the best checkpoint is written with a bundle
that adds the extractor's and the optimizer's state.
"""

from __future__ import annotations

import logging
import math
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from jcfszxc_unet_tpu_torch.data.loading import (
    display_dataset_info,
    load_preprocessed_data,
    visualize_samples,
)
from jcfszxc_unet_tpu_torch.data.sampler import (
    extract_patches,
    sample_centers,
)
from jcfszxc_unet_tpu_torch.ops.blocks import conv3x3_folded, fold, kmajor
from jcfszxc_unet_tpu_torch.ops.kernels.dice_fused import dice_coeff_hard
from jcfszxc_unet_tpu_torch.ops.layers import (
    Conv2d,
    cat_channels,
    reset_parameters,
    resize_linear_align_corners,
    resize_nearest_align_corners,
)
from jcfszxc_unet_tpu_torch.train import checkpoint as ckpt
from jcfszxc_unet_tpu_torch.train.losses import bce_with_logits
from jcfszxc_unet_tpu_torch.train.optim import (
    ReduceLROnPlateau,
    clip_and_step,
    get_current_lr,
    make_optimizer,
    set_current_lr,
)
from jcfszxc_unet_tpu_torch.train.trainer import _nchw, split_indices, sync
from jcfszxc_unet_tpu_torch.utils.device import resolve_device
from jcfszxc_unet_tpu_torch.utils.seed import set_seed

# Whole images per validation forward.
VAL_CHUNK = 8

# Seeds of the extractor's initialisation and of the sampling generator,
# as offsets from the run's seed.
EXTRACTOR_SEED_OFFSET = 1
DATA_SEED_OFFSET = 0xF4AC


# ========================= fractal feature extractor ======================


class FractalFeatureExtractor(nn.Module):
    """Input-enhancement CNN (reference train-demo.py:194-235): a 3x3 ->
    1x1 "fractal" branch and 3x3 convs dilated 1, 2, 4 and 8, fused by a
    1x1 conv and added to the input.  NCHW in ``torch.channels_last``.

    In eval mode ``fractal_conv1`` and ``ms_conv_d1`` (both 3x3, stride 1,
    SAME, bias, ReLU, on x) run as one kernel call with their weights
    stacked to 32 output channels."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.in_channels = in_channels
        self.fractal_conv1 = Conv2d(in_channels, 16, 3, padding=1)
        self.fractal_conv2 = Conv2d(16, 1, 1)
        for scale in (1, 2, 4, 8):
            setattr(self, f"ms_conv_d{scale}",
                    Conv2d(in_channels, 16, 3, padding=scale,
                           dilation=scale))
        self.fusion_conv = Conv2d(16 * 4 + 1, in_channels, 1)

    def _undilated(self, x):
        """relu(fractal_conv1(x)), relu(ms_conv_d1(x))."""
        if self.training:
            return (torch.relu(self.fractal_conv1(x)),
                    torch.relu(self.ms_conv_d1(x)))
        folds = [fold(c) for c in (self.fractal_conv1, self.ms_conv_d1)]
        w_km = torch.cat([kmajor(self.fractal_conv1, x.dtype),
                          kmajor(self.ms_conv_d1, x.dtype)])
        y = conv3x3_folded(x, w_km, torch.cat([s for s, _ in folds]),
                           torch.cat([t for _, t in folds]), relu=True)
        return y[:, :16], y[:, 16:]

    def forward(self, x):
        f, d1 = self._undilated(x)
        f = self.fractal_conv2(f)
        feats = [d1] + [torch.relu(getattr(self, f"ms_conv_d{s}")(x))
                        for s in (2, 4, 8)]
        return self.fusion_conv(cat_channels(*feats, f)) + x


# ========================= box-counting fractal dimension =================


def box_dimension(mask: torch.Tensor, max_scales: int = 4) -> torch.Tensor:
    """Box-counting fractal dimension of each (H, W) map of ``mask``
    (..., H, W), as f32 (reference train-demo.py:252-315): binarize at
    0.5; for boxes of 2^1..2^max_scales count the occupied ones (pad,
    reshape, max); the least-squares slope of log(count + 1e-10) against
    log(box size) in closed form; dimension = -slope, 0 for an empty
    map.

    The counts are exact; the regression runs in f64.  In f32, as the JAX
    package runs it, its cancellation (n*sxy - sx*sy) turns the one-ulp
    differences of ``logf`` between the card and the CPU into ~3e-6 of
    the dimension; in f64 both give the same f32 result, within ~3e-6 of
    the JAX package's."""
    binary = (mask > 0.5).float()
    *lead, h, w = binary.shape
    counts = []
    for s in range(1, max_scales + 1):
        b = 2 ** s
        hp, wp = -(-h // b) * b, -(-w // b) * b
        padded = F.pad(binary, (0, wp - w, 0, hp - h))
        occ = padded.reshape(*lead, hp // b, b, wp // b, b).amax(dim=(-3, -1))
        counts.append(occ.sum(dim=(-2, -1)))
    log_counts = torch.log(torch.stack(counts, dim=-1).double() + 1e-10)
    # log 2^s, made on the device: a host tensor's copy would sync it
    log_sizes = torch.arange(1, max_scales + 1, dtype=torch.float64,
                             device=binary.device) * math.log(2.0)
    n = float(max_scales)
    sx, sy = log_sizes.sum(), log_counts.sum(dim=-1)
    sxy = (log_sizes * log_counts).sum(dim=-1)
    sxx = (log_sizes * log_sizes).sum()
    slope = ((n * sxy - sx * sy) / (n * sxx - sx * sx)).float()
    empty = binary.sum(dim=(-2, -1)) == 0
    return torch.where(empty, torch.zeros_like(slope), -slope)


def fractal_sample_indices(generator: torch.Generator, batch: int,
                           sample_size: int = 4) -> torch.Tensor:
    """The first min(sample_size, batch) entries of a random permutation
    of the batch, drawn on the generator's device: the samples whose
    dimensions :func:`fractal_loss` compares."""
    perm = torch.randperm(batch, generator=generator,
                          device=generator.device)
    return perm[:min(sample_size, batch)]


def fractal_loss(logits: torch.Tensor, target: torch.Tensor,
                 idx: torch.Tensor, alpha: float = 0.3, beta: float = 0.3,
                 gamma: float = 0.4) -> torch.Tensor:
    """FractalLoss (reference train-demo.py:239-347, alpha 0.3, beta 0.3,
    gamma 0.4 as instantiated at :488): alpha*BCE + beta*global Dice +
    gamma*mean |boxdim(target_i) - boxdim(pred_i)| over the batch samples
    ``idx``.  NHWC (B, P, P, 1); the dimension term has no gradient (it
    binarizes)."""
    logits = logits.float()
    target = target.float()
    probs = torch.sigmoid(logits)
    bce = bce_with_logits(logits, target)
    dice = 1.0 - 2.0 * (probs * target).sum() / ((probs + target).sum()
                                                  + 1e-8)
    td = box_dimension(target[idx][..., 0])
    pd = box_dimension(probs[idx][..., 0])
    frac = (td - pd).abs().mean()
    return alpha * bce + beta * dice + gamma * frac


# ========================= fractal self-supervised loss ===================


def _sobel_gradients(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel |Sobel| gradients of NHWC ``x`` with reflect padding
    (reference train-demo.py:371-389): a depthwise 3x3 cross-correlation."""
    gx = torch.tensor([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]],
                      dtype=torch.float32, device=x.device)
    c = x.shape[-1]
    xp = F.pad(x.float().permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")

    def conv(k):
        kernel = k.expand(c, 1, 3, 3)
        return F.conv2d(xp, kernel, groups=c).permute(0, 2, 3, 1).abs()

    return conv(gx), conv(gx.t())


def fractal_self_supervised_loss(pred_large, pred_small,
                                 original_image=None):
    """Self-similarity consistency + Sobel branch-structure consistency
    (reference train-demo.py:350-402; defined there and never called)."""
    consistency = ((pred_large - pred_small) ** 2).mean()
    lgx, lgy = _sobel_gradients(pred_large)
    sgx, sgy = _sobel_gradients(pred_small)
    branch = (((lgx + lgy) - (sgx + sgy)) ** 2).mean()
    return consistency + 0.5 * branch


# ========================= fractal multi-scale sampling ===================


def build_fractal_sample_maps(masks: np.ndarray, patch_size: int,
                              fractal_levels: int = 3):
    """Per-level candidate center maps and level patch sizes (reference
    train-demo.py:77-137), on the host, once.

    masks: (N, H, W).  Level selectors: 0 -> mask > 0.7 (main vessels);
    1 -> top-decile |gradient| of the mask (branch points); 2+ -> mask >
    0.3.  A level with no in-bounds center falls back to mask > 0.1, then
    to any interior pixel.  Returns (patch_sizes, maps), maps[i] an int32
    (K_i, 3) array of (img_idx, x, y).

    DELIBERATE DIVERGENCE from the *executed* reference, as in the JAX
    package: train-demo.py passes masks as (N, 1, H, W), so its
    ``np.where(masks_data > 0.7)`` at levels 0 and 2 returns four index
    arrays whose ``[1]`` is the all-zero channel axis; the in-bounds
    filter then drops every candidate and only level 1 ever yields patches
    (train-demo.py:100, 108, 111-124).  This implements the documented
    three-level intent with the right axes.
    """
    n, h, w = masks.shape
    scale_factors = [1 / (1.5 ** i) for i in range(fractal_levels)]
    patch_sizes = [max(int(patch_size * sf), 16) for sf in scale_factors]

    grad_mag = (np.abs(np.gradient(masks, axis=1))
                + np.abs(np.gradient(masks, axis=2)))

    maps = []
    for level, ps in enumerate(patch_sizes):
        half = ps // 2
        if level == 0:
            cand = masks > 0.7
        elif level == 1:
            cand = grad_mag > np.percentile(grad_mag, 90)
        else:
            cand = masks > 0.3

        def in_bounds(sel):
            ii, xx, yy = np.nonzero(sel)
            ok = ((xx >= half) & (xx < h - half)
                  & (yy >= half) & (yy < w - half))
            return np.stack([ii[ok], xx[ok], yy[ok]], -1).astype(np.int32)

        m = in_bounds(cand)
        if len(m) == 0:
            m = in_bounds(masks > 0.1)
        if len(m) == 0:  # degenerate dataset: any interior pixel
            m = in_bounds(np.ones_like(masks, bool))
        maps.append(m)
    return patch_sizes, maps


def level_sample_counts(batch_size: int, fractal_levels: int = 3
                        ) -> List[int]:
    """Power-law split (train-demo.py:86-89): level i gets B*(1/2)^i, and
    the remainder, negative for three levels, goes to level 0 (32 ->
    [8, 16, 8])."""
    dist = [int(batch_size * (0.5 ** i)) for i in range(fractal_levels)]
    dist[0] += batch_size - sum(dist)
    return dist


def fractal_sample_batch(images: torch.Tensor, targets: torch.Tensor,
                         centers: Sequence[torch.Tensor],
                         patch_sizes: Sequence[int], out_patch: int):
    """One fractal multi-scale batch from per-level ``centers``: for each
    level a patch gather at the level's size, then an align-corners linear
    (images) and nearest (targets) resize to ``out_patch``, the grids of
    the reference's scipy.zoom order 1 and 0 (train-demo.py:163-174).
    images (N, H, W, C), targets (N, H, W, 1) -> (B, P, P, C),
    (B, P, P, 1).

    The reference slices [center - half, center + half), so an odd level
    size cuts the even window 2*(ps//2) (train-demo.py:152-161)."""
    imgs_out, tgts_out = [], []
    for c, ps in zip(centers, patch_sizes):
        if c.shape[0] == 0:
            continue
        ps = 2 * (ps // 2)
        ip = extract_patches(images, c, ps)
        tp = extract_patches(targets, c, ps)
        if ps != out_patch:
            ip = resize_linear_align_corners(ip, out_patch, out_patch)
            tp = resize_nearest_align_corners(tp, out_patch, out_patch)
        imgs_out.append(ip)
        tgts_out.append(tp)
    return torch.cat(imgs_out), torch.cat(tgts_out)


# ========================= steps =========================================


def make_fractal_step_fn(model: nn.Module, extractor: nn.Module,
                         optimizer: torch.optim.Optimizer, *,
                         compute_dtype=torch.float32,
                         clip_norm: float = 1.0):
    """The per-batch update ``(imgs, tgts, idx) -> (loss, ok)``: the
    extractor and the model in train mode, :func:`fractal_loss` on the
    samples ``idx``, backward, clip by global norm over both, RMSprop.
    ``loss`` is a 0-d f32 tensor (0 when skipped); ``ok`` is False when
    the loss was not finite and the update was skipped."""

    def step(imgs, tgts, idx):
        model.train()
        extractor.train()
        enhanced = extractor(_nchw(imgs, compute_dtype))
        logits = model(enhanced).permute(0, 2, 3, 1)
        loss = fractal_loss(logits, tgts, idx)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        # One host sync, after the backward has been queued (trainer.py).
        if not bool(torch.isfinite(loss)):
            optimizer.zero_grad(set_to_none=True)
            return torch.zeros((), device=loss.device), False
        clip_and_step(optimizer, clip_norm)
        return loss.detach().float(), True

    return step


def make_fractal_val_fn(model: nn.Module, extractor: nn.Module, *,
                        chunk_size: int = VAL_CHUNK,
                        compute_dtype=torch.float32):
    """``(images (V, H, W, C), masks (V, H, W, 1)) -> (dice, probs (V, H,
    W, 1) f32)``: the extractor and the model in eval mode on whole images,
    ``chunk_size`` at a time, sigmoid, and the mean per-image Dice of
    ``probs > 0.5`` against the masks (eps 1e-5, as the JAX package's
    ``dice_coeff(..., reduce_batch_first=False)``).  Both modules are put
    back in the mode they were in."""

    @torch.inference_mode()
    def val_fn(images: torch.Tensor, masks: torch.Tensor):
        modes = (model.training, extractor.training)
        model.eval()
        extractor.eval()
        try:
            probs = torch.cat([
                torch.sigmoid(model(extractor(_nchw(chunk, compute_dtype)))
                              .float()).permute(0, 2, 3, 1)
                for chunk in images.split(chunk_size)])
        finally:
            model.train(modes[0])
            extractor.train(modes[1])
        binary = (probs[..., 0] > 0.5).float().contiguous()
        dice = dice_coeff_hard(binary, masks[..., 0].float().contiguous())
        return dice, probs

    return val_fn


# ========================= training engine ================================


def fractal_train_arrays(model: nn.Module, images, masks, *,
                         model_name: str = "UNet.UNet", model_kwargs=None,
                         steps: int = 100, batch_size: int = 32,
                         learning_rate: float = 1e-6,
                         val_percent: float = 0.1, patch_size: int = 128,
                         weight_decay: float = 1e-8, momentum: float = 0.999,
                         seed: int = 42, early_stopping_patience: int = 20,
                         compute_dtype=torch.float32,
                         max_epochs: Optional[int] = None,
                         visualize: bool = True,
                         save_path: str = "best_model.ckpt",
                         bundle_path: str = "best_fractal_model.ckpt",
                         async_checkpoints: bool = True,
                         device="cuda"):
    """The reference train-demo.py:405-665 protocol on arrays: images
    (N, H, W, C) and FOV masks (N, H, W), float in [0, 1]; the masks are
    the targets.  ``model`` is trained in place on ``device`` together
    with a new :class:`FractalFeatureExtractor`.

    With ``async_checkpoints`` the best checkpoint and the bundle go to
    the background writer; all are on disk when this returns.

    Returns ``{"best_dice", "history", "extractor"}``, one history record
    per epoch (loss, Dice, skipped steps, the seconds of the train steps
    and of the validation pass, each ending in a device sync, and
    ``train_end_seconds``, the time from the first epoch's start to the
    end of this epoch's train steps, the previous epoch's checkpoint
    write included)."""
    dev = resolve_device(device)
    model_kwargs = dict(model_kwargs or {})
    set_seed(seed)
    val_idx, train_idx = split_indices(len(images), val_percent)
    n_val = len(val_idx)

    images = np.asarray(images, np.float32)
    masks = np.asarray(masks, np.float32)
    patch_sizes, maps_np = build_fractal_sample_maps(masks[train_idx],
                                                     patch_size)
    counts = level_sample_counts(batch_size)

    train_images = torch.as_tensor(images[train_idx], device=dev)
    train_masks = torch.as_tensor(masks[train_idx, ..., None], device=dev)
    level_maps = [torch.as_tensor(m, device=dev).long() for m in maps_np]
    val_images = torch.as_tensor(images[val_idx], device=dev)
    val_masks = torch.as_tensor(masks[val_idx, ..., None], device=dev)

    model = model.to(device=dev, memory_format=torch.channels_last)
    extractor = FractalFeatureExtractor(model.n_channels)
    reset_parameters(extractor, torch.Generator().manual_seed(
        seed + EXTRACTOR_SEED_OFFSET))
    extractor = extractor.to(device=dev, memory_format=torch.channels_last)
    optimizer = make_optimizer(
        list(model.parameters()) + list(extractor.parameters()),
        learning_rate, weight_decay, momentum)
    step = make_fractal_step_fn(model, extractor, optimizer,
                                compute_dtype=compute_dtype)
    val_fn = make_fractal_val_fn(model, extractor,
                                 compute_dtype=compute_dtype)
    scheduler = ReduceLROnPlateau(factor=0.7, patience=5, threshold=0.01,
                                  cooldown=2)
    generator = torch.Generator(device=dev).manual_seed(
        seed + DATA_SEED_OFFSET)

    logging.info(
        f"Starting training with fractal optimization:\n"
        f"  Batch size:    {batch_size} (levels {counts} at patches "
        f"{patch_sizes})\n"
        f"  Learning rate: {learning_rate}\n"
        f"  Training size: {len(train_idx)}  Validation size: {n_val}\n"
        f"  Device:        {dev}")

    def write_best(model_sd, extractor_sd, optimizer_sd):
        ckpt.save_state(save_path, model_name, model_kwargs, model_sd)
        # The bundle: model + extractor + optimizer, the counterpart of the
        # reference's best_fractal_model.pth (train-demo.py:600-604).
        ckpt.save_state(bundle_path, model_name, model_kwargs, model_sd,
                        extra={"extractor": extractor_sd,
                               "optimizer": optimizer_sd})

    writer = ckpt.AsyncCheckpointWriter() if async_checkpoints else None
    best_dice = 0.0
    patience_counter = 0
    epoch = 0
    history = []
    t_start = time.perf_counter()
    try:
        while True:
            epoch += 1
            if max_epochs is not None and epoch > max_epochs:
                break
            sync(dev)
            t0 = time.perf_counter()
            total = torch.zeros((), device=dev)
            skipped = 0
            for _ in range(steps):
                centers = [sample_centers(generator, lmap, cnt)
                           for lmap, cnt in zip(level_maps, counts)]
                imgs, tgts = fractal_sample_batch(
                    train_images, train_masks, centers, patch_sizes,
                    patch_size)
                loss, ok = step(imgs, tgts, fractal_sample_indices(
                    generator, imgs.shape[0]))
                total += loss
                skipped += not ok
            sync(dev)
            t1 = time.perf_counter()
            # validation on (up to 200) whole images, FOV masks as truth
            n_val_samples = min(n_val, 200)
            if n_val_samples:
                vidx = torch.as_tensor(np.random.choice(
                    n_val, n_val_samples, replace=False), device=dev)
                vi, vm = val_images[vidx], val_masks[vidx]
                dice_t, probs = val_fn(vi, vm)
                dice = float(dice_t)  # syncs
            else:
                # Empty split: 0, as the JAX package (the reference would
                # crash on an empty np.stack).
                dice, probs = 0.0, None
            t2 = time.perf_counter()
            epoch_loss = float(total)

            lr = get_current_lr(optimizer)
            new_lr = scheduler.step(dice, lr)
            if new_lr != lr:
                set_current_lr(optimizer, new_lr)

            stop = False
            if dice > best_dice:
                best_dice = dice
                patience_counter = 0
                sds = (model.state_dict(), extractor.state_dict(),
                       optimizer.state_dict())
                if writer is None:
                    write_best(*sds)
                else:
                    writer.submit(write_best, *sds)
                print(f"New best dice score: {best_dice:.4f} - Saved model "
                      f"checkpoint")
            else:
                patience_counter += 1
                print(f"Dice score did not improve. Patience: "
                      f"{patience_counter}/{early_stopping_patience}")
                if patience_counter >= early_stopping_patience:
                    print(f"Early stopping triggered after {epoch} epochs. "
                          f"Best dice score: {best_dice:.4f}")
                    stop = True
            history.append({
                "epoch": epoch, "lr": new_lr, "loss": epoch_loss / steps,
                "dice": dice, "best_dice": best_dice,
                "skipped_steps": skipped, "train_seconds": t1 - t0,
                "val_seconds": t2 - t1, "train_end_seconds": t1 - t_start})
            if stop:
                break

            print(f"Epoch {epoch} - LR: {new_lr:.2e} - Loss: "
                  f"{epoch_loss / steps:.4g} - Dice: {dice:.4g} - Best Dice: "
                  f"{best_dice:.4g}")

            if visualize and epoch % 5 == 0 and n_val_samples:
                from jcfszxc_unet_tpu_torch.utils.vis import save_triptych

                sample_num = np.random.randint(0, n_val_samples)
                save_triptych(
                    vi[sample_num].cpu().numpy(),
                    probs[sample_num, ..., 0].cpu().numpy(),
                    vm[sample_num, ..., 0].cpu().numpy(),
                    f"visualizations/fractal_{epoch:03d}_{sample_num:03d}.png")
    finally:
        if writer is not None:
            writer.close()  # re-raises a failed write; files on disk
    return {"best_dice": best_dice, "history": history,
            "extractor": extractor}


def train_with_fractal_optimization(model: nn.Module, model_name: str,
                                    input_data: str =
                                    "./data/train_eye_dataset.h5",
                                    seed: int = 42, visualize: bool = True,
                                    **kwargs) -> float:
    """Load a preprocessed split and run :func:`fractal_train_arrays` on its
    images and FOV masks; returns the best validation Dice, like the JAX
    function of this name."""
    set_seed(seed)
    dataset = load_preprocessed_data(input_data)
    display_dataset_info(dataset)
    if visualize:
        visualize_samples(dataset, num_samples=3)
    return fractal_train_arrays(
        model, dataset["images"], dataset["masks"], model_name=model_name,
        seed=seed, visualize=visualize, **kwargs)["best_dice"]
