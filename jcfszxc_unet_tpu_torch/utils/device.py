"""Device selection for the port's entry points: the card by default, the
CPU only on request, and never a silent fall-back from one to the other."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, raising if it names CUDA and no CUDA
    device is usable."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available; pass "
            f"device='cpu' to run on the CPU")
    return dev
