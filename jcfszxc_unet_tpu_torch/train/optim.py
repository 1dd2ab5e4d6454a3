"""Optimizer and learning-rate schedule, counterpart of
``jcfszxc_unet_tpu/train/optim.py`` (reference train.py:107-122, 296-301):

  * ``torch.optim.RMSprop(lr, alpha=0.99, eps=1e-8, weight_decay=1e-8,
    momentum=0.999)``;
  * gradients clipped by global norm 1.0 before the optimizer runs
    (:func:`clip_and_step`), the order of the JAX package's optax chain;
  * ``ReduceLROnPlateau(mode='max', factor=0.7, patience=5,
    threshold=0.01 relative, cooldown=2)``, a copy of the JAX package's
    host-side class, kept instead of torch's scheduler so that the order
    of its steps stays the same as the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import torch


def make_optimizer(params: Iterable[torch.nn.Parameter], learning_rate: float,
                   weight_decay: float = 1e-8, momentum: float = 0.999,
                   alpha: float = 0.99, eps: float = 1e-8
                   ) -> torch.optim.RMSprop:
    """RMSprop with the reference's settings (weight decay is folded into
    the gradient before the RMS scaling, as optax's chain does)."""
    return torch.optim.RMSprop(params, lr=learning_rate, alpha=alpha, eps=eps,
                               weight_decay=weight_decay, momentum=momentum)


def clip_and_step(optimizer: torch.optim.Optimizer,
                  clip_norm: Optional[float] = 1.0) -> None:
    """Clip all gradients of ``optimizer``'s parameters by global norm,
    then take one optimizer step.

    A parameter that took no gradient (``.grad`` None: TransFuseNet's
    unused ``output_OD`` head) gets a zero one first, so that its weight
    decay and its RMS and momentum state move as optax's chain moves them:
    torch's RMSprop skips a parameter without a gradient, optax steps
    every leaf."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if clip_norm is not None:
        torch.nn.utils.clip_grad_norm_(params, clip_norm)
    optimizer.step()


def get_current_lr(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_current_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


@dataclasses.dataclass
class ReduceLROnPlateau:
    """Host-side plateau scheduler with torch semantics for the config the
    reference uses (train.py:114-122): mode='max', relative threshold.

    An improvement counts only if metric > best * (1 + threshold); after
    ``patience`` non-improving epochs the LR is multiplied by ``factor``,
    followed by ``cooldown`` epochs during which bad epochs are ignored.
    """

    factor: float = 0.7
    patience: int = 5
    threshold: float = 0.01
    cooldown: int = 2
    min_lr: float = 0.0

    best: float = float("-inf")
    num_bad_epochs: int = 0
    cooldown_counter: int = 0

    def step(self, metric: float, lr: float) -> float:
        """Feed one epoch's metric; returns the (possibly reduced) LR.

        The order of torch's ReduceLROnPlateau.step: update best /
        num_bad_epochs first, then consume one cooldown epoch (which also
        zeroes the bad epochs), then test the patience.
        """
        metric = float(metric)
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            lr = max(lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return lr

    def _is_better(self, metric: float) -> bool:
        if self.best == float("-inf"):
            return True
        # torch threshold_mode='rel', mode='max'
        return metric > self.best * (1.0 + self.threshold)
