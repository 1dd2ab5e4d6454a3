"""Faults planted underneath the program's timed path, for the checks'
own tests and readings: each is a context manager that patches one
function of the port and restores it at the exit.

Evaluation: ``eval_half_batch`` (each forward chunk computes its first
half and gives the rest that half's mean map); ``eval_altered`` (the first
patch of each chunk comes out as 1 - p); ``eval_dice_altered`` (kernel 2's
per-image Dice comes out one image along); ``eval_auc_altered`` (the AUC
histograms take 1024 bins, not 8192).  Training: ``train_unchanged``
(the optimizer step does nothing, so the state is returned unchanged);
``train_half_batch`` (the loss is the mean over the first half of the
batch's rows); ``train_altered`` (one row of each batch has its labels
inverted where the batch is cut); ``train_val_dice_altered`` (the
validation pass's Dice is taken against the labels one patch along).  A run across chips has an exchange
to leave out; every cell here takes one chip."""

from __future__ import annotations

import contextlib
from unittest import mock

import torch


@contextlib.contextmanager
def eval_half_batch():
    from jcfszxc_unet_tpu_torch.eval.predictor import Predictor

    orig = Predictor._forward

    def forward(self, batch):
        half = max(batch.shape[0] // 2, 1)
        y = orig(self, batch[:half])
        rest = y.mean(0, keepdim=True).expand(
            (batch.shape[0] - half,) + y.shape[1:])
        return torch.cat([y, rest])

    with mock.patch.object(Predictor, "_forward", forward):
        yield


@contextlib.contextmanager
def eval_altered():
    from jcfszxc_unet_tpu_torch.eval.predictor import Predictor

    orig = Predictor._forward

    def forward(self, batch):
        y = orig(self, batch).clone()
        y[0] = 1.0 - y[0]
        return y

    with mock.patch.object(Predictor, "_forward", forward):
        yield


@contextlib.contextmanager
def eval_dice_altered():
    from jcfszxc_unet_tpu_torch.cli import evaluate

    orig = evaluate.binary_dice

    def dice(binary, target):
        return orig(binary, target).roll(1, 0)

    with mock.patch.object(evaluate, "binary_dice", dice):
        yield


@contextlib.contextmanager
def eval_auc_altered():
    from jcfszxc_unet_tpu_torch.cli import evaluate

    orig = evaluate.roc_auc

    def auc(scores, targets, mask=None, n_bins=8192):
        return orig(scores, targets, mask, n_bins=1024)

    with mock.patch.object(evaluate, "roc_auc", auc):
        yield


@contextlib.contextmanager
def train_unchanged():
    from jcfszxc_unet_tpu_torch.train import trainer

    with mock.patch.object(trainer, "clip_and_step",
                           lambda opt, clip_norm=1.0: None):
        yield


@contextlib.contextmanager
def train_half_batch():
    from jcfszxc_unet_tpu_torch.train import trainer

    orig = trainer.combined_loss

    def loss(logits, target, n_classes=1, alpha=0.5, world=None):
        half = max(logits.shape[0] // 2, 1)
        return orig(logits[:half], target[:half], n_classes, alpha,
                    world=world)

    with mock.patch.object(trainer, "combined_loss", loss):
        yield


@contextlib.contextmanager
def train_altered():
    from jcfszxc_unet_tpu_torch.train import trainer

    orig = trainer.sample_batch

    def sample(*args, **kwargs):
        imgs, labs = orig(*args, **kwargs)
        labs = labs.clone()
        labs[0] = 1.0 - labs[0]
        return imgs, labs

    with mock.patch.object(trainer, "sample_batch", sample):
        yield


@contextlib.contextmanager
def train_val_dice_altered():
    from jcfszxc_unet_tpu_torch.train import trainer

    orig = trainer.dice_coeff_hard

    def dice(probs, target):
        return orig(probs, target.roll(1, 0))

    with mock.patch.object(trainer, "dice_coeff_hard", dice):
        yield


EVAL = {"half_batch": eval_half_batch, "altered": eval_altered,
        "dice_altered": eval_dice_altered, "auc_altered": eval_auc_altered}
TRAIN = {"unchanged": train_unchanged, "half_batch": train_half_batch,
         "altered": train_altered, "val_dice_altered": train_val_dice_altered}
