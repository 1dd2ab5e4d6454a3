"""Training engine, counterpart of ``jcfszxc_unet_tpu/train/trainer.py``
(the reference's ``train_model`` hot loop, train.py:201-353).

What differs in mechanism from the JAX package:

  * PyTorch runs eagerly: an epoch is a Python loop of steps, each of
    which samples centers on the device, gathers the patches, runs the
    train-mode forward and backward on stock ops, clips and steps RMSprop.
  * The NaN guard (trainer.py:98-110) reads ``isfinite(loss)`` on the
    host once per step, after the backward is queued: a device sync that
    the JAX package avoids with a branchless select.  A non-finite loss
    drops the gradients and skips the update, so parameters and optimizer
    state stay as they were, while
    the BatchNorm running statistics keep the update that the forward
    already made, as in the JAX package and the reference.
  * ``remat`` (JAX ``jax.checkpoint`` of the whole train-mode forward)
    is ``torch.utils.checkpoint`` of the whole forward, non-reentrant,
    with the RNG state preserved so that dropout draws the same masks
    again.  The recomputation updates clones of the BatchNorm buffers
    (:func:`frozen_running_stats`), so running statistics and
    ``num_batches_tracked`` move once per step, as in JAX.
  * Validation runs the eval-mode forward in chunks under
    ``torch.inference_mode()``: every DoubleConv conv goes through the
    ``conv3x3_affine_relu`` kernel with its BatchNorm folded in, and both
    Dice scores through the ``dice_sums`` kernel.  Inference mode skips
    the operators' autograd kernel, which ``no_grad`` would run in Python
    on every call.

Models take NCHW tensors in ``torch.channels_last``; batches stay NHWC
(the JAX layout) and are permuted into that form without a copy.

Data-parallel runs pass a ``world`` (``parallel/mesh.py``), and keep the
JAX mesh's global semantics (trainer.py:44-48, 72-73):

  * every rank draws the whole global batch from the same seeded
    generator and keeps its rows (``parallel.shard_rows``), so the global
    batch is the single process's bit for bit;
  * the train-mode forward runs under ``parallel.global_batch_norm``
    (statistics over the global batch) and the loss takes the global Dice
    (``train/losses.py``); after ``backward()`` the gradients are
    averaged over the ranks, which makes them the gradient of the global
    loss; the reported loss is the all-reduced mean of the ranks' losses,
    the global loss, and the NaN guard decides on it, so every rank skips
    together; clip and RMSprop then leave the parameters bit-identical on
    every rank;
  * validation forwards each rank's contiguous share of the patches (the
    shares differ by one patch at most where they do not divide; JAX pads
    the last chunk by wrapping instead) and gathers the probabilities, so
    the Dice is computed on every rank from the same values.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Iterable

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from jcfszxc_unet_tpu_torch.data.sampler import (
    augment_batch,
    extract_patches,
    sample_batch,
    sample_centers,
)
from jcfszxc_unet_tpu_torch.ops.kernels.dice_fused import dice_coeff_hard
from jcfszxc_unet_tpu_torch.parallel.mesh import (
    average_gradients,
    gather_rows,
    global_batch_norm,
    mean_over_ranks,
    row_bounds,
    shard_rows,
)
from jcfszxc_unet_tpu_torch.train.losses import combined_loss
from jcfszxc_unet_tpu_torch.train.optim import clip_and_step
from jcfszxc_unet_tpu_torch.train.state import TrainState
from jcfszxc_unet_tpu_torch.utils.profiling import annotate


def split_indices(n_samples: int, val_percent: float):
    """(val_idx, train_idx) by the host RNG protocol of train.py:79: a
    numpy shuffle right after the seed is set."""
    n_val = int(n_samples * val_percent)
    indices = np.arange(n_samples)
    np.random.shuffle(indices)
    return indices[:n_val], indices[n_val:]


def sync(device: torch.device) -> None:
    """Wait for ``device``'s queued work (a no-op on the CPU): the end of
    a host-clock measurement."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _nchw(batch: torch.Tensor, dtype) -> torch.Tensor:
    """(B, H, W, C) -> NCHW view in channels_last, cast to ``dtype``."""
    return batch.to(dtype).permute(0, 3, 1, 2)


@contextlib.contextmanager
def frozen_running_stats(model: nn.Module):
    """Inside, every BatchNorm that tracks running statistics updates
    clones of its ``running_mean``, ``running_var`` and
    ``num_batches_tracked``, which are dropped at the exit: the
    recomputation of a checkpointed forward normalizes by its batch
    statistics as the first pass did, without a second update."""
    saved = []
    for m in model.modules():
        if (isinstance(m, nn.modules.batchnorm._BatchNorm)
                and m.track_running_stats):
            bufs = {k: getattr(m, k) for k in (
                "running_mean", "running_var", "num_batches_tracked")}
            saved.append((m, bufs))
            for k, v in bufs.items():
                setattr(m, k, v.clone())
    try:
        yield
    finally:
        for m, bufs in saved:
            for k, v in bufs.items():
                setattr(m, k, v)


def make_batch_step_fn(*, n_classes: int, compute_dtype=torch.float32,
                       clip_norm: float = 1.0, remat: bool = False,
                       world=None) -> Callable:
    """The per-batch update ``(state, imgs, labs) -> (loss, ok)``:
    train-mode forward, 1/2 BCE + 1/2 Dice, backward, clip by global norm,
    RMSprop.  ``loss`` is a 0-d f32 tensor (0 when skipped); ``ok`` is
    False when the loss was not finite and the update was skipped.
    ``remat``: the forward's activations are recomputed in the backward
    instead of kept (see the module doc).  With a ``world``, ``imgs`` and
    ``labs`` are the global batch, of which this rank trains its rows,
    and ``loss`` is the global loss (see the module doc)."""

    def forward(model, x):
        if not remat:
            return model(x)
        return checkpoint(
            model, x, use_reentrant=False, preserve_rng_state=True,
            context_fn=lambda: (contextlib.nullcontext(),
                                frozen_running_stats(model)))

    def train_step(state: TrainState, imgs: torch.Tensor, labs: torch.Tensor):
        model, opt = state.model, state.optimizer
        model.train()
        imgs, labs = shard_rows(imgs, world), shard_rows(labs, world)
        state.step += 1
        opt.zero_grad(set_to_none=True)
        with global_batch_norm(model, world):
            with annotate("unet.train.forward"):
                logits = forward(model, _nchw(imgs, compute_dtype)).permute(
                    0, 2, 3, 1)
                loss, _, _ = combined_loss(logits, labs, n_classes,
                                           world=world)
            with annotate("unet.train.backward"):
                loss.backward()
                if world is not None:
                    average_gradients(model.parameters(), world)
                    loss = mean_over_ranks(loss, world)
        # Host sync: see module doc.  It comes after the backward has been
        # queued, so the device is not left idle while the host launches it.
        with annotate("unet.train.nan_guard"):
            with annotate("unet.sync"):
                finite = bool(torch.isfinite(loss))
            if not finite:
                opt.zero_grad(set_to_none=True)
                return torch.zeros((), device=loss.device), False
        with annotate("unet.train.optimizer"):
            clip_and_step(opt, clip_norm)
        return loss.detach().float(), True

    return train_step


def make_epoch_fn(*, n_classes: int, batch_size: int, patch_size: int,
                  steps: int, compute_dtype=torch.float32,
                  augment: bool = False, remat: bool = False,
                  world=None) -> Callable:
    """``(state, images, labels, sample_map, generator) -> {"epoch_loss",
    "skipped", "step_losses", "step_end_s"}``: ``steps`` steps on batches
    drawn from ``generator``.  ``epoch_loss`` is the sum of the kept
    losses (a 0-d tensor): skipped steps add nothing, the caller still
    divides by ``steps`` (train.py:303, 392).  ``step_losses`` is each
    step's loss, a (steps,) f32 tensor on the device (0 where the step
    was skipped), and ``step_end_s`` the host's ``time.perf_counter()``
    as each step returned; neither costs a sync.  ``augment`` adds a
    random dihedral-8 element per sample; ``remat`` and ``world`` are
    :func:`make_batch_step_fn`'s (``batch_size`` is the global batch,
    drawn whole on every rank).  Under a profiler each step is the span
    ``unet.train.step``, holding ``unet.train.sample``, ``.forward``,
    ``.backward``, ``.nan_guard`` (its ``unet.sync``) and ``.optimizer``."""
    batch_step = make_batch_step_fn(n_classes=n_classes,
                                    compute_dtype=compute_dtype, remat=remat,
                                    world=world)

    def epoch_fn(state, images, labels, sample_map, generator):
        total = torch.zeros((), device=images.device)
        skipped = 0
        losses, ends = [], []
        for _ in range(steps):
            with annotate("unet.train.step"):
                with annotate("unet.train.sample"):
                    imgs, labs = sample_batch(generator, images, labels,
                                              sample_map, batch_size,
                                              patch_size)
                    if augment:
                        imgs, labs = augment_batch(generator, imgs, labs)
                loss, ok = batch_step(state, imgs, labs)
                total += loss
                skipped += not ok
                losses.append(loss)
            ends.append(time.perf_counter())
        return {"epoch_loss": total, "skipped": skipped,
                "step_losses": (torch.stack(losses) if losses
                                else total.new_zeros((0,))),
                "step_end_s": ends}

    return epoch_fn


@torch.no_grad()
def precise_bn(model: nn.Module, batches: Iterable[torch.Tensor],
               compute_dtype=torch.float32, world=None) -> None:
    """Set every BatchNorm's running statistics to the arithmetic mean of
    the pure batch statistics of ``batches`` ((B, P, P, C) image patches),
    whatever statistics they held before.

    Each BN is reset and switched to a cumulative average
    (``momentum=None``) for the train-mode forwards, then given back its
    momentum and batch count: the same result as the JAX package's
    ``(mean_i S_i - (1 - m) base) / m``.  With a ``world``, each batch is
    the global one: this rank forwards its rows, with the statistics
    taken over the ranks."""
    bns = [m for m in model.modules()
           if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    if not bns:
        return
    saved = [(bn.momentum, bn.num_batches_tracked.clone()) for bn in bns]
    was_training = model.training
    for bn in bns:
        bn.reset_running_stats()
        bn.momentum = None
    model.train()
    try:
        with global_batch_norm(model, world):
            for imgs in batches:
                model(_nchw(shard_rows(imgs, world), compute_dtype))
    finally:
        for bn, (momentum, tracked) in zip(bns, saved):
            bn.momentum = momentum
            bn.num_batches_tracked.copy_(tracked)
        model.train(was_training)


def make_precise_bn_fn(*, batch_size: int, patch_size: int, k_batches: int,
                       compute_dtype=torch.float32, world=None) -> Callable:
    """``(model, images, sample_map, generator)``: :func:`precise_bn` over
    ``k_batches`` fresh training batches (CLI ``--precise-bn K``; off by
    default, as in the JAX package); with a ``world``, over the ranks."""

    def precise_bn_fn(model, images, sample_map, generator):
        def batches():
            for _ in range(k_batches):
                centers = sample_centers(generator, sample_map, batch_size)
                yield extract_patches(images, centers, patch_size)

        precise_bn(model, batches(), compute_dtype, world)

    return precise_bn_fn


def make_val_fn(model: nn.Module, *, chunk_size: int = 64,
                compute_dtype=torch.float32, world=None) -> Callable:
    """``(val_imgs (V, P, P, C), val_labs (V, P, P, 1)) -> (metrics,
    probs (V, P, P, 1) f32)``, with the metrics of train.py:348-367 as 0-d
    tensors, the fg/bg naming quirk included: ``dice`` == ``dice_bg`` is
    the Dice of ``p > 0.5`` against the labels, ``dice_fg`` that of
    ``p <= 0.5`` against ``1 - labels``, ``dice_avg`` their mean.  The
    model is put back in the mode it was in.  With a ``world``, each rank
    forwards its share of the V patches in chunks of ``chunk_size`` over
    the ranks' count (JAX shards each chunk over the mesh), and every
    rank returns the gathered probabilities and their metrics.  Under a
    profiler a call is the span ``unet.val``, with one ``unet.val.forward``
    per chunk and ``unet.val.dice`` inside it."""
    if world is not None:
        chunk_size = max(chunk_size // world.size, 1)

    def forward(chunk):
        with annotate("unet.val.forward"):
            return torch.sigmoid(model(_nchw(chunk, compute_dtype)).float()
                                 ).permute(0, 2, 3, 1)

    @torch.inference_mode()
    def val_fn(val_imgs: torch.Tensor, val_labs: torch.Tensor):
        with annotate("unet.val"):
            return val_pass(val_imgs, val_labs)

    def val_pass(val_imgs, val_labs):
        if val_imgs.shape[0] == 0:
            # Empty split: zeros, as the JAX package (the reference would
            # crash on an empty np.stack, train.py:334).
            zero = torch.zeros((), device=val_imgs.device)
            return ({"dice": zero, "dice_bg": zero, "dice_fg": zero,
                     "dice_avg": zero},
                    torch.zeros(val_labs.shape, device=val_labs.device))
        was_training = model.training
        model.eval()
        start, stop = row_bounds(val_imgs.shape[0], world)
        try:
            probs = torch.cat([
                forward(chunk)
                for chunk in val_imgs[start:stop].split(chunk_size)]
                or [val_labs.new_zeros((0,) + val_labs.shape[1:])])
        finally:
            model.train(was_training)
        probs = gather_rows(probs, val_imgs.shape[0], world)
        with annotate("unet.val.dice"):
            p = probs[..., 0].contiguous()
            t = val_labs[..., 0].float().contiguous()
            dice = dice_coeff_hard((p > 0.5).float(), t)
            dice_fg = dice_coeff_hard((p <= 0.5).float(), 1.0 - t)
            metrics = {"dice": dice, "dice_bg": dice, "dice_fg": dice_fg,
                       "dice_avg": (dice + dice_fg) / 2.0}
        return metrics, probs

    return val_fn


def build_val_patches(images: np.ndarray, labels: np.ndarray,
                      sample_map_val: np.ndarray, patch_size: int, *,
                      device):
    """The whole validation patch set, cut once on ``device`` (the
    reference cuts it every epoch on the host, train.py:317-331).
    images (N, H, W, C), labels (N, H, W, 1)."""
    images = torch.as_tensor(np.asarray(images, np.float32), device=device)
    labels = torch.as_tensor(np.asarray(labels, np.float32), device=device)
    return (extract_patches(images, sample_map_val, patch_size),
            extract_patches(labels, sample_map_val, patch_size))
