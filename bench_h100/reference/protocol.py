"""The protocols the benchmark checks, in plain PyTorch and float32.

* the tiled evaluation of reference ``evaluate.py``: a grid of patch
  centres at stride patch/2 clipped to the image, the sigmoid of each
  patch's logits, count-averaged stitching, the FOV mask, hard Dice at a
  threshold and ROC-AUC over the FOV pixels;
* the train step of reference ``train.py``: 1/2 BCE-with-logits + 1/2
  soft Dice loss (``utils/dice_score.py``, its epsilon override and
  empty-mask guard included), the gradient clipped by global norm 1, then
  RMSprop with weight decay and momentum;
* the control's lower precision: :class:`QConv2d` and
  :class:`QConvTranspose2d` compute in FP8 (E4M3 operands, E5M2
  gradients, per-tensor scales) when their ``fp8`` flag is on.

Departures from the reference repository:

* ROC-AUC is the histogram form (8192 bins, trapezoids from the top bin)
  that the evaluated program uses; the reference repository calls
  scikit-learn's exact ``roc_auc_score``.  Histogram binning moves an AUC
  by ~1e-5 on these maps, far under any gap the check reads.
* The train pool's centres are drawn with ``torch.randint`` from a seeded
  generator on the card, as the program draws them, instead of numpy's
  ``random.choice``: the batch must be the one the program trained on.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

AUC_BINS = 8192
FP8 = torch.float8_e4m3fn
FP8_GRAD = torch.float8_e5m2


@contextlib.contextmanager
def plain_precision():
    """Inside, float32 matmuls and convolutions run without TF32; the
    settings before are restored at the exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ---------------------------------------------------------------- FP8 control

def _quantize(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to ``dtype`` under a per-tensor scale that maps its largest
    magnitude to the format's largest finite value, returned in x's dtype."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _FP8Operand(torch.autograd.Function):
    """Forward: the operand in E4M3.  Backward: the gradient passes
    straight through."""

    @staticmethod
    def forward(ctx, x):
        return _quantize(x, FP8)

    @staticmethod
    def backward(ctx, g):
        return g


class _FP8Grad(torch.autograd.Function):
    """Forward: identity.  Backward: the incoming gradient in E5M2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _quantize(g, FP8_GRAD)


def _fp8(x):
    return _FP8Operand.apply(x)


class QConv2d(nn.Conv2d):
    """``nn.Conv2d``; with ``fp8`` set, input and weight in E4M3 and the
    output's gradient in E5M2 (the FP8 training recipe)."""

    fp8 = False

    def forward(self, x):
        if not self.fp8:
            return super().forward(x)
        y = self._conv_forward(_fp8(x), _fp8(self.weight), self.bias)
        return _FP8Grad.apply(y)


class QConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` with the same ``fp8`` switch."""

    fp8 = False

    def forward(self, x):
        if not self.fp8:
            return super().forward(x)
        y = F.conv_transpose2d(_fp8(x), _fp8(self.weight), self.bias,
                               self.stride, self.padding,
                               self.output_padding, self.groups,
                               self.dilation)
        return _FP8Grad.apply(y)


class AsFloat(nn.Module):
    """The wrapped model on float32 input: the reference in a program's
    place, where the program hands it activations of its compute dtype."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, x):
        return self.model(x.float())


def set_fp8(model: nn.Module, on: bool) -> nn.Module:
    for m in model.modules():
        if isinstance(m, (QConv2d, QConvTranspose2d)):
            m.fp8 = on
    return model


# ------------------------------------------------------------ tiled evaluation

def grid_centers(n_images: int, h: int, w: int, half: int) -> np.ndarray:
    """(n_images * rows * cols, 3) int64 rows of (image, x, y): centres at
    arange(half, dim, half) clipped to [half, dim - half]."""
    xs = np.clip(np.arange(half, h, half), half, h - half)
    ys = np.clip(np.arange(half, w, half), half, w - half)
    return np.array([(i, x, y) for i in range(n_images) for x in xs
                     for y in ys], dtype=np.int64)


def cut_patches(images: torch.Tensor, centers, patch: int) -> torch.Tensor:
    """(B, P, P, C) patches of (N, H, W, C) images, one per centre."""
    half = patch // 2
    return torch.stack([images[i, x - half:x - half + patch,
                               y - half:y - half + patch]
                        for i, x, y in np.asarray(centers).tolist()])


@torch.no_grad()
def tiled_probabilities(model: nn.Module, images: torch.Tensor, patch: int,
                        chunk: int = 8) -> torch.Tensor:
    """Stitched (N, H, W) float32 probabilities of (N, H, W, C) images, the
    model in eval mode: sigmoid of each patch's logits, summed into the canvas and divided by
    the count of patches over each pixel."""
    model.eval()
    n, h, w, _ = images.shape
    half = patch // 2
    centers = grid_centers(n, h, w, half)
    canvas = torch.zeros((n, h, w), device=images.device)
    counts = torch.zeros((n, h, w), device=images.device)
    for start in range(0, len(centers), chunk):
        part = centers[start:start + chunk]
        x = cut_patches(images, part, patch).permute(0, 3, 1, 2).float()
        probs = torch.sigmoid(model(x).float())[:, 0]
        for k, (i, cx, cy) in enumerate(part.tolist()):
            canvas[i, cx - half:cx - half + patch,
                   cy - half:cy - half + patch] += probs[k]
            counts[i, cx - half:cx - half + patch,
                   cy - half:cy - half + patch] += 1.0
    return torch.where(counts > 0, canvas / counts.clamp(min=1.0),
                       torch.zeros_like(canvas))


def hard_dice(binary: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Per-image Dice (N,) of (N, H, W) maps: (2 sum(p t) + eps) /
    (sum p + sum t + eps), eps 1e-5, with sum p + sum t below eps
    replaced by 2 sum(p t) (reference ``dice_coeff``)."""
    eps = 1e-5
    p = binary.float().clamp(0.0, 1.0).flatten(1)
    t = target.float().flatten(1)
    inter = 2.0 * (p * t).sum(1)
    sets = p.sum(1) + t.sum(1)
    sets = torch.where(sets < eps, inter, sets)
    return (inter + eps) / (sets + eps)


def histogram_auc(scores: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor) -> float:
    """ROC-AUC of scores in [0, 1] against labels > 0.5 over the pixels of
    mask > 0, from histograms of AUC_BINS bins; 0.5 without positives or
    without negatives."""
    s = scores.double().flatten().clamp(0.0, 1.0)
    pos = labels.double().flatten() > 0.5
    inside = mask.double().flatten() > 0
    bins = (s.float() * (AUC_BINS - 1)).long().clamp(0, AUC_BINS - 1)
    ph = torch.bincount(bins[inside & pos], minlength=AUC_BINS).double()
    nh = torch.bincount(bins[inside & ~pos], minlength=AUC_BINS).double()
    tp = torch.cumsum(ph.flip(0), 0)
    fp = torch.cumsum(nh.flip(0), 0)
    if tp[-1] == 0 or fp[-1] == 0:
        return 0.5
    zero = torch.zeros(1, dtype=torch.float64, device=s.device)
    tpr = torch.cat([zero, tp / tp[-1]])
    fpr = torch.cat([zero, fp / fp[-1]])
    return float(((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1]) / 2).sum())


@torch.no_grad()
def evaluate_split(model: nn.Module, images: torch.Tensor,
                   masks: torch.Tensor, labels: torch.Tensor, patch: int,
                   threshold: float) -> dict:
    """The tiled protocol on one split: FOV-masked maps (N, H, W), per-image
    Dice of maps > threshold and per-image AUC."""
    maps = tiled_probabilities(model, images, patch) * masks
    dice = hard_dice((maps > threshold).float(), labels)
    auc = [histogram_auc(maps[i], labels[i], masks[i])
           for i in range(maps.shape[0])]
    return {"maps": maps, "dice": dice.tolist(), "auc": auc}


# ------------------------------------------------------------------ train step

def train_sample_map(masks: np.ndarray, half: int) -> np.ndarray:
    """(valid, 3) int64 rows of (image, x, y) over the FOV pixels whose
    patch lies inside the image, in row-major order."""
    _, h, w = masks.shape
    ii, xx, yy = np.nonzero(masks != 0)
    keep = (xx >= half) & (xx < h - half) & (yy >= half) & (yy < w - half)
    return np.stack([ii[keep], xx[keep], yy[keep]], axis=-1).astype(np.int64)


def soft_dice_loss(probs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1 - Dice over the whole batch of (B, H, W) probabilities, clamped to
    [1e-7, 1 - 1e-7] and then to [0, 1], epsilon 1e-5, empty-set guard."""
    p = probs.clamp(1e-7, 1.0 - 1e-7).clamp(0.0, 1.0)
    eps = 1e-5
    inter = 2.0 * (p * target).sum()
    sets = p.sum() + target.sum()
    sets = torch.where(sets < eps, inter, sets)
    return 1.0 - (inter + eps) / (sets + eps)


def combined_loss(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """1/2 BCE-with-logits (mean) + 1/2 soft Dice loss of the sigmoid, on
    (B, 1, H, W) logits and targets."""
    logits = logits.float()
    bce = F.binary_cross_entropy_with_logits(logits, target)
    dice = soft_dice_loss(torch.sigmoid(logits)[:, 0], target[:, 0])
    return 0.5 * bce + 0.5 * dice


class RMSprop:
    """torch's RMSprop update written out: g += wd p; v = a v + (1 - a) g^2;
    b = m b + g / (sqrt(v) + eps); p -= lr b."""

    def __init__(self, params, lr, alpha=0.99, eps=1e-8, weight_decay=1e-8,
                 momentum=0.999):
        self.params = list(params)
        self.lr, self.alpha, self.eps = lr, alpha, eps
        self.wd, self.momentum = weight_decay, momentum
        self.v = [torch.zeros_like(p) for p in self.params]
        self.buf = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads):
        for p, g, v, b in zip(self.params, grads, self.v, self.buf):
            g = g + self.wd * p
            v.mul_(self.alpha).addcmul_(g, g, value=1.0 - self.alpha)
            b.mul_(self.momentum).add_(g / (v.sqrt() + self.eps))
            p.sub_(self.lr * b)


def clip_by_global_norm(grads, max_norm: float = 1.0):
    """The gradients scaled by min(1, max_norm / (norm + 1e-6)), norm the
    global L2 norm (torch's ``clip_grad_norm_``)."""
    total = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
    coef = min(1.0, max_norm / (float(total) + 1e-6))
    return [g * coef for g in grads]


def train_step(model: nn.Module, opt: RMSprop, imgs: torch.Tensor,
               labs: torch.Tensor) -> float:
    """One step on (B, P, P, C) images and (B, P, P, 1) labels; returns the
    loss."""
    model.train()
    for p in opt.params:
        p.grad = None
    loss = combined_loss(model(imgs.permute(0, 3, 1, 2).float()),
                         labs.permute(0, 3, 1, 2).float())
    loss.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in opt.params]
    opt.step(clip_by_global_norm(grads))
    return float(loss.detach())


@torch.no_grad()
def val_pass(model: nn.Module, imgs: torch.Tensor, labs: torch.Tensor,
             chunk: int = 16):
    """Eval-mode probabilities (V, P, P) of the validation patches and the
    mean per-patch hard Dice of p > 0.5 against the labels."""
    was = model.training
    model.eval()
    probs = torch.cat([torch.sigmoid(model(
        x.permute(0, 3, 1, 2).float()).float())[:, 0]
        for x in imgs.split(chunk)])
    model.train(was)
    dice = hard_dice((probs > 0.5).float(), labs[..., 0]).mean()
    return probs, float(dice)


def leaf_gaps(got, want, keep=None, scale=None) -> list[float]:
    """|got_i - want_i| / max(scale_i, median(scale)) for the leaves where
    ``keep`` is true (all without it); ``scale`` is ``want`` unless
    given."""
    scale = want if scale is None else scale
    idx = [i for i in range(len(want)) if keep is None or keep[i]]
    med = float(np.median([scale[i] for i in idx])) if idx else 0.0
    return [abs(got[i] - want[i]) / max(scale[i], med, 1e-30) for i in idx]


def worst_leaf_gap(got, want, keep=None, scale=None) -> float:
    """The largest of :func:`leaf_gaps`."""
    gaps = leaf_gaps(got, want, keep, scale)
    return max(gaps) if gaps else math.nan


def median_leaf_gap(got, want, keep=None, scale=None) -> float:
    """The median of :func:`leaf_gaps`."""
    gaps = leaf_gaps(got, want, keep, scale)
    return float(np.median(gaps)) if gaps else math.nan
