"""Train state, counterpart of ``jcfszxc_unet_tpu/train/state.py``.

The JAX package threads an explicit pytree (params, batch_stats,
opt_state, step) through a jitted step; here the model holds its
parameters and BatchNorm statistics, the optimizer its own state, and
the step updates both in place.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
