"""Device selection for the port's entry points: the card by default, the
CPU only on request, and never a silent fall-back from one to the other;
and the rank count of ``--devices``."""

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


def resolve_device_count(devices: int, device="cuda") -> int:
    """The rank count of ``--devices``: 0 means every visible device of
    ``device``'s kind (the visible cards for CUDA; one for the CPU), as
    the JAX CLIs' 0 means every device; a card named by index is one
    device).  A CUDA count above the visible cards, or above 1 with a
    card named by index, exits with a message; on the CPU any count of
    ranks shares the host."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return devices or 1
    if devices == 0 and dev.index is not None:
        return 1
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = devices or max(visible, 1)
    if n > 1 and dev.index is not None:
        raise SystemExit(f"--devices {n} runs one rank per card: pass "
                         f"--device cuda, not {device}")
    if n > max(visible, 1):  # one rank: resolve_device says what is missing
        raise SystemExit(f"--devices {n} needs {n} CUDA devices; "
                         f"{visible} visible")
    return n
