"""Fused per-sample Dice statistics.

For (B, H, W) maps ``probs`` and ``target``, one sweep gives, in f32,
``(2 * sum(clamp(p, 0, 1) * t), sum(clamp(p, 0, 1)), sum(t))`` per sample.

Kernel: ``csrc/dice_sums.cu``, CUDA C++ for sm_90a, replacing the TPU
kernel ``dice_sums_pallas`` in ``jcfszxc_unet_tpu/ops/pallas/dice_fused.py``.
It is bound by bytes (two f32 reads per pixel).  Pass 1 reduces
(sample, chunk) tiles to partial sums, pass 2 adds each sample's partials
in a fixed order: no atomics, so the sums do not change from run to run.

:func:`dice_sums_torch` is the plain PyTorch version.  The wrapper takes
it only for tensors on the CPU; for a CUDA tensor it launches the kernel
or raises.
"""

from __future__ import annotations

import torch

from jcfszxc_unet_tpu_torch.ops.kernels import build

CHUNK = 8192  # pixels reduced by one block of pass 1

counter = build.LaunchCounter()


def dice_sums_torch(probs, target):
    """Plain version: per-sample (2*sum(p*t), sum(p), sum(t)), p clamped."""
    p = probs.float().clamp(0.0, 1.0)
    t = target.float()
    inter = 2.0 * (p * t).sum(dim=(-1, -2))
    return inter, p.sum(dim=(-1, -2)), t.sum(dim=(-1, -2))


def dice_sums(probs, target):
    """Per-sample Dice statistics of float32 (B, H, W) maps (contiguous).
    Returns three (B,) float32 tensors: (inter, pred_sum, target_sum)."""
    if probs.dim() != 3 or probs.shape != target.shape:
        raise ValueError(
            f"expected two (B,H,W) maps, got {tuple(probs.shape)} and "
            f"{tuple(target.shape)}")
    if probs.dtype != torch.float32 or target.dtype != torch.float32:
        raise TypeError(
            f"probs and target must be float32, got {probs.dtype} and "
            f"{target.dtype}")
    if not (probs.is_contiguous() and target.is_contiguous()):
        raise ValueError("probs and target must be contiguous")
    if probs.device != target.device:
        raise ValueError("probs and target lie on different devices")
    if probs.device.type == "cpu":
        return dice_sums_torch(probs, target)
    if probs.device.type != "cuda":
        raise ValueError(f"no kernel for device {probs.device}")
    lib = build.load_library()
    b, h, w = probs.shape
    hw = h * w
    inter, ps, ts = (torch.empty((b,), dtype=torch.float32,
                                 device=probs.device) for _ in range(3))
    if b == 0:
        return inter, ps, ts
    if hw == 0:
        return inter.zero_(), ps.zero_(), ts.zero_()
    n_chunks = -(-hw // CHUNK)
    partials = torch.empty((b, n_chunks, 3), dtype=torch.float32,
                           device=probs.device)
    with torch.cuda.device(probs.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.dice_sums_launch(
            probs.data_ptr(), target.data_ptr(), partials.data_ptr(),
            inter.data_ptr(), ps.data_ptr(), ts.data_ptr(),
            b, hw, CHUNK, n_chunks, stream)
    build.check(lib, code, "dice_sums")
    counter.launches += 1
    return inter, ps, ts


def dice_from_sums(inter, ps, ts, eps: float = 1e-5):
    """Per-sample Dice from the sums, with the reference's empty-mask guard
    (sets_sum below eps is replaced by inter)."""
    sets = ps + ts
    sets = torch.where(sets < eps, inter, sets)
    return (inter + eps) / (sets + eps)


def dice_coeff_hard(probs, target):
    """Mean per-sample Dice of (B, H, W) maps from the fused sums."""
    return dice_from_sums(*dice_sums(probs, target)).mean()
