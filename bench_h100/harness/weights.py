"""Weights of a configuration made from the run's seed on the device.

All parameters come from one ``torch.rand`` call on a generator on the
device: conv and transposed-conv weights and biases uniform in
+-1/sqrt(fan_in) (torch's default bounds), BatchNorm gamma in [0.5, 1.5)
and beta in +-0.35.  Then, as ``chip_smoke.py``'s ``build_model`` does,
each BatchNorm's running statistics are measured on one batch of two
patches of a synthetic DRIVE image through the plain reference in train
mode, so activations keep
their scale through the layers, and perturbed (mean moved by up to
0.17 std, variance scaled by 0.8-1.2), so the evaluated folds have work
to do.  A configuration may name a head that is rescaled, on the same
batch, to an output of mean 0 and a given std (``calibrate_head``).

The result is a state dict under the reference's names, which both the
program and the reference load."""

from __future__ import annotations

import math

import torch
from torch import nn

from harness.common import subseed
from harness.synth import synthetic_drive

# The calibration batch: two 256^2 patches from the centre of one synthetic
# DRIVE image, so that activations are scaled for the traffic's content.
CALIB_H, CALIB_W, CALIB_SIZE = 584, 565, 256


def _fan_in(w: torch.Tensor) -> int:
    return w.shape[1] * math.prod(w.shape[2:])


@torch.no_grad()
def make_state_dict(build, cfg: dict, seed: int, device) -> dict:
    with torch.device("meta"):
        model = build()
    model = model.to_empty(device=device)
    g = torch.Generator(device=device).manual_seed(subseed(seed, "weights"))
    params = dict(model.named_parameters())
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    n_bn = sum(bn.num_features for bn in bns)
    total = sum(p.numel() for p in params.values())
    u = torch.rand(total + 3 * n_bn, generator=g, device=device)
    off = 0
    bn_params = {id(bn.weight) for bn in bns} | {id(bn.bias) for bn in bns}
    convs = {}
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            convs[id(m.weight)] = m.weight
            if m.bias is not None:
                convs[id(m.bias)] = m.weight
    for name, p in params.items():
        v = u[off:off + p.numel()].view_as(p)
        off += p.numel()
        if id(p) in bn_params:
            is_gamma = name.endswith("weight")
            p.copy_(0.5 + v if is_gamma else 0.7 * (v - 0.5))
        else:
            bound = 1.0 / math.sqrt(_fan_in(convs[id(p)]))
            p.copy_((2.0 * v - 1.0) * bound)
    for bn in bns:
        bn.reset_running_stats()
        bn.momentum = 1.0  # running statistics := the batch's
    hooks = []
    head = cfg.get("calibrate_head")
    if head:
        def rescale(conv, args, y):
            mean = y.mean(dim=(0, 2, 3))
            std = y.std(dim=(0, 2, 3)) + 1e-6
            k = head["std"] / std
            conv.weight.mul_(k.view(-1, 1, 1, 1))
            conv.bias.sub_(mean).mul_(k)
        hooks.append(model.get_submodule(head["module"])
                     .register_forward_hook(rescale))
    images, _, _ = synthetic_drive(1, CALIB_H, CALIB_W, g, device)
    rows, cols = CALIB_H // 2, CALIB_W // 2
    half = CALIB_SIZE // 2
    calib = torch.stack([
        images[0, r - half:r + half, c - half:c + half]
        for r, c in ((rows, cols - half // 2), (rows, cols + half // 2))
    ]).permute(0, 3, 1, 2).contiguous()
    model.train()
    model(calib)
    for h in hooks:
        h.remove()
    for bn in bns:
        c = bn.num_features
        z = (u[off:off + c] * 2.0 - 1.0) * math.sqrt(3.0)
        bn.running_mean.add_(0.1 * z * bn.running_var.sqrt())
        bn.running_var.mul_(0.8 + 0.4 * u[off + c:off + 2 * c])
        bn.momentum = 0.1
        bn.num_batches_tracked.zero_()
        off += 3 * c
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
