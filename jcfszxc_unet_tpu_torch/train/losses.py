"""Loss and metric numerics of training, counterpart of
``jcfszxc_unet_tpu/train/losses.py`` on NHWC tensors.

The reference formulas, quirks included:
  * ``dice_coeff`` / ``multiclass_dice_coeff`` / ``dice_loss``
    (reference utils/dice_score.py:13-59): the [0, 1] input clamp, the
    epsilon hard-overridden to 1e-5, the empty-mask guard
    ``sets_sum < eps -> inter``;
  * ``bce_with_logits``: ``nn.BCEWithLogitsLoss`` (reference train.py:124);
  * ``soft_cross_entropy``: ``nn.CrossEntropyLoss`` with probability
    targets, taken when ``n_classes > 1`` (with one logit channel it is
    identically 0, as in the reference);
  * ``combined_loss``: 1/2 BCE + 1/2 Dice of the sigmoid, applied
    unconditionally (reference train.py:255-278).

The training loss needs a gradient and runs on stock ops; the validation
Dice goes through the ``dice_sums`` kernel (``ops/kernels/dice_fused``).

Data-parallel runs (``world``, ``parallel/mesh.py``) keep the JAX
package's global objective.  There the loss of a global batch B is
L = 1/2 BCE(B) + 1/2 Dice(B), one Dice over the whole batch
(``reduce_batch_first=True``, JAX ``train/losses.py:71``).  Rank r holds
the rows B_r of an equal split over W ranks and computes

    L_r = 1/2 BCE(B_r) + 1/2 Dice_global,

where Dice_global is the Dice of the three sums Σp·t, Σp, Σt (after the
clamp) summed over the ranks by ``parallel.all_reduce_sum``, the same
value on every rank.  The all-reduce's backward sums the incoming
gradients over the ranks, so the gradient of rank r's parameters holds W
copies of the global term: it is the gradient of Σ_r L_r through this
rank's rows.  Averaging the gradients over the ranks
(``parallel.average_gradients``) then gives the gradient of
Σ_r L_r / W = 1/2 mean_r BCE(B_r) + 1/2 Dice_global = L, the global loss,
and the all-reduced mean of the L_r is L itself.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dice_coeff(inputs: torch.Tensor, target: torch.Tensor,
               reduce_batch_first: bool = False,
               epsilon: float = 1e-6) -> torch.Tensor:
    """Soft Dice, mean-reduced: per sample over (-1, -2), or over
    (-1, -2, -3) when ``reduce_batch_first`` (3-D inputs only)."""
    assert inputs.shape == target.shape, (inputs.shape, target.shape)
    assert inputs.dim() == 3 or not reduce_batch_first

    inputs = inputs.clamp(0.0, 1.0)
    sum_dim = ((-1, -2) if inputs.dim() == 2 or not reduce_batch_first
               else (-1, -2, -3))
    inter = 2 * (inputs * target).sum(dim=sum_dim)
    sets_sum = inputs.sum(dim=sum_dim) + target.sum(dim=sum_dim)

    epsilon = 1e-5  # the reference overrides the argument (dice_score.py:32)
    sets_sum = torch.where(sets_sum < epsilon, inter, sets_sum)
    return ((inter + epsilon) / (sets_sum + epsilon)).mean()


def multiclass_dice_coeff(inputs: torch.Tensor, target: torch.Tensor,
                          reduce_batch_first: bool = False,
                          epsilon: float = 1e-5) -> torch.Tensor:
    """Flatten (B, C, ...) to (B*C, ...), then Dice (dice_score.py:41-50)."""
    return dice_coeff(inputs.reshape((-1,) + tuple(inputs.shape[2:])),
                      target.reshape((-1,) + tuple(target.shape[2:])),
                      reduce_batch_first, epsilon)


def global_dice_coeff(inputs: torch.Tensor, target: torch.Tensor,
                      world) -> torch.Tensor:
    """:func:`dice_coeff` with ``reduce_batch_first`` over the rows of
    every rank of ``world``: the three sums Σp·t, Σp, Σt over all
    elements go through one differentiable all-reduce before the
    formula."""
    from jcfszxc_unet_tpu_torch.parallel.mesh import all_reduce_sum

    assert inputs.shape == target.shape, (inputs.shape, target.shape)
    inputs = inputs.clamp(0.0, 1.0)
    sums = all_reduce_sum(torch.stack([
        (inputs * target).sum(), inputs.sum(), target.sum()]), world)
    inter = 2 * sums[0]
    sets_sum = sums[1] + sums[2]
    epsilon = 1e-5  # the reference's override (dice_score.py:32)
    sets_sum = torch.where(sets_sum < epsilon, inter, sets_sum)
    return (inter + epsilon) / (sets_sum + epsilon)


def dice_loss(inputs: torch.Tensor, target: torch.Tensor,
              multiclass: bool = False, world=None) -> torch.Tensor:
    """1 - Dice of probabilities clamped to [1e-7, 1 - 1e-7]
    (dice_score.py:53-59); with a ``world`` of several ranks, the Dice of
    the global batch (:func:`global_dice_coeff`)."""
    inputs = inputs.clamp(1e-7, 1.0 - 1e-7)
    if world is not None and world.size > 1:
        return 1.0 - global_dice_coeff(inputs, target, world)
    fn = multiclass_dice_coeff if multiclass else dice_coeff
    return 1.0 - fn(inputs, target, reduce_batch_first=True)


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """bf16 -> f32 for the loss math; f64 stays f64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def bce_with_logits(logits: torch.Tensor, target: torch.Tensor
                    ) -> torch.Tensor:
    """Mean binary cross-entropy on logits, in the stable form
    ``max(z, 0) - z*t + log1p(exp(-|z|))``."""
    logits = _at_least_f32(logits)
    target = target.to(logits.dtype)
    loss = (torch.clamp(logits, min=0.0) - logits * target
            + torch.log1p(torch.exp(-logits.abs())))
    return loss.mean()


def soft_cross_entropy(logits: torch.Tensor, target: torch.Tensor
                       ) -> torch.Tensor:
    """Cross-entropy with probability targets of the same shape, channel
    axis -1 (NHWC); mean over batch and positions."""
    logits = _at_least_f32(logits)
    logp = F.log_softmax(logits, dim=-1)
    return (-(target.to(logits.dtype) * logp).sum(dim=-1)).mean()


def combined_loss(logits: torch.Tensor, target: torch.Tensor,
                  n_classes: int = 1, alpha: float = 0.5, world=None):
    """The reference objective on NHWC logits (B, H, W, C) and targets of
    the same shape.  Returns (loss, bce, dice_loss).  With a ``world``,
    this rank's L_r of the module doc: the BCE of its rows, the Dice of
    the global batch."""
    logits = _at_least_f32(logits)
    target = target.to(logits.dtype)
    probs = torch.sigmoid(logits)
    if n_classes > 1:
        bce = soft_cross_entropy(logits, target)
    else:
        bce = bce_with_logits(logits, target)
    # train.py:270-274 squeezes the channel dim before the Dice.
    d = dice_loss(probs.squeeze(-1), target.squeeze(-1), world=world)
    return alpha * bce + (1.0 - alpha) * d, bce, d
