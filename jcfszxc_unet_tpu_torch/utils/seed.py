"""Seeding (reference utils/utils.py:18-43), counterpart of
``jcfszxc_unet_tpu/utils/seed.py``: seeds python, numpy and torch and
returns an explicit ``torch.Generator`` for whatever the caller draws."""

from __future__ import annotations

import logging
import random

import numpy as np
import torch


def set_seed(seed: int) -> torch.Generator:
    """Seed python, numpy and torch (all devices); return a CPU generator
    seeded with ``seed``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    logging.info(f"Random seed set to {seed}")
    return torch.Generator().manual_seed(seed)
