"""Evaluation metrics, counterpart of ``jcfszxc_unet_tpu/eval/metrics.py``:
per-image hard Dice through the fused ``dice_sums`` kernel, histogram
ROC-AUC, the confusion counts and the FOV accuracy/sensitivity/specificity
companions."""

from __future__ import annotations

import torch

from jcfszxc_unet_tpu_torch.ops.kernels.dice_fused import (
    dice_from_sums,
    dice_sums,
)


def binary_dice(pred_binary: torch.Tensor, target: torch.Tensor
                ) -> torch.Tensor:
    """Per-image hard Dice of (N, H, W) maps, one ``dice_sums`` call for
    all N; equals the reference's per-image dice_coeff (evaluate.py:336-344).
    Returns (N,) float32."""
    return dice_from_sums(*dice_sums(pred_binary, target))


def roc_auc(scores: torch.Tensor, targets: torch.Tensor,
            mask: torch.Tensor | None = None, n_bins: int = 8192
            ) -> torch.Tensor:
    """Histogram ROC-AUC of ``scores`` in [0, 1] against binary ``targets``
    over the ``mask`` (FOV) pixels: scores binned into ``n_bins`` buckets,
    positive/negative histograms, trapezoid integration from the top bin.
    0.5 when there are no positives or no negatives."""
    scores = scores.float().reshape(-1).clamp(0.0, 1.0)
    pos = (targets.float().reshape(-1) > 0.5).float()
    if mask is None:
        weights = torch.ones_like(scores)
    else:
        weights = (mask.float().reshape(-1) > 0).float()
    bins = (scores * (n_bins - 1)).to(torch.int64).clamp(0, n_bins - 1)
    pos_hist = torch.zeros(n_bins, device=scores.device).index_add_(
        0, bins, weights * pos)
    neg_hist = torch.zeros(n_bins, device=scores.device).index_add_(
        0, bins, weights * (1 - pos))
    tp = torch.cumsum(pos_hist.flip(0), 0)
    fp = torch.cumsum(neg_hist.flip(0), 0)
    n_pos, n_neg = tp[-1], fp[-1]
    zero = torch.zeros(1, device=scores.device)
    tpr = torch.cat([zero, tp / n_pos.clamp(min=1.0)])
    fpr = torch.cat([zero, fp / n_neg.clamp(min=1.0)])
    auc = ((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) / 2.0).sum()
    return torch.where((n_pos > 0) & (n_neg > 0), auc, torch.full_like(auc, 0.5))


def confusion_counts(pred_binary, target, mask=None):
    """TP, FP, FN and TN pixel counts of a binary prediction against
    ``target > 0.5`` over the ``mask`` pixels (all pixels without one),
    as 0-d f32 tensors."""
    p = pred_binary.float()
    t = (target > 0.5).float()
    w = torch.ones_like(p) if mask is None else (mask > 0).float()
    return ((w * p * t).sum(), (w * p * (1 - t)).sum(),
            (w * (1 - p) * t).sum(), (w * (1 - p) * (1 - t)).sum())


def classification_metrics(pred_binary, target, mask=None):
    """Accuracy, sensitivity and specificity over the ``mask`` pixels;
    a metric whose denominator is 0 is 0."""
    tp, fp, fn, tn = confusion_counts(pred_binary, target, mask)

    def _safe(num, den):
        return torch.where(den > 0, num / den.clamp(min=1.0),
                           torch.zeros_like(num))

    return (_safe(tp + tn, tp + fp + fn + tn), _safe(tp, tp + fn),
            _safe(tn, tn + fp))
