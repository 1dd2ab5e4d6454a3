#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (sm_90a, i.e. an H100).

    python3 chip_smoke.py

Phases, each of which must pass:

1. build the CUDA kernels from ``jcfszxc_unet_tpu_torch/csrc`` (nvcc, ctypes);
2. eval path: full-width UNet (64 -> 1024 channels, random weights from a
   seed, BatchNorm statistics calibrated on a batch and then perturbed)
   evaluates 4 synthetic DRIVE-geometry images (584 x 565, 16 patches of
   512^2) through the tiled protocol in bf16, inference batch 32, to
   per-image Dice and AUC; the kernels' launch counts are read around it;
3. f32 end to end (TF32 off): the port's forward on one image's patches
   against a forward built only from the kernels' plain versions;
4. each kernel against its plain version at the eval path's shapes (the
   conv kernel also at the train path's validation shapes and at the edges
   of its wgmma plan, in bf16, and at the zoo's and whole-image shapes in
   both types), and its time beside the plain version's, a library call's
   and its bound, per layer for the conv kernel;
5. train path: full-width UNet with random weights trains on 8 synthetic
   DRIVE-geometry images through ``cli.train.train_arrays`` at the CLI
   defaults (patch 128, batch 32, bf16, lr 1e-6) with 25 % validation
   (2 images, 144 patches, 3 chunks of 64), 2 epochs of 10 steps; the
   launch counts are read around it; one train step and one val pass are
   profiled;
6. train val f32 (TF32 off): on the trained weights, the val metrics and
   probabilities through the kernels against a forward built from the
   plain versions;
7. probe path: ``scripts.imcol_conv_probe.run_probe`` at its defaults (B 64,
   128 x 128, 128 -> 64, bf16) with the launch count read around it, then
   the imcol kernel against its plain version there, in f32 at B 8 and on
   a ragged shape, timed beside the plain version, cuDNN and its bound;
8. zoo eval: the other 15 models of the zoo (ResUNet, SegNet,
   NestedUNet, AttentionUNet, R2UNet, R2AttentionUNet, BCDU_net_D3,
   BCDU_net_D1, MultiResUNet, DenseUNet, FRUNet, BARUNet, BIARUNet, MCUNet
   and TransFuseNet) at full width (seeded weights, BatchNorm calibrated
   and perturbed as for UNet, BatchNorm-free biased convs calibrated,
   logit heads where a model has one) evaluate the same 4 images through
   the tiled protocol in bf16, with the conv kernel's launches checked per
   body against each model's count, images/s, the device's idle share and
   peak allocated memory (TransFuseNet's attention over 4096 tokens, and
   the attention kernel that ran), the conv kernel's time per forward
   beside cuDNN's for the same conv list (each of its shapes, at the eval
   batch, also checked against the plain version; BCDU's ConvLSTM x-halves
   at twice the batch), and an f32 check (TF32 off) of each model's
   forward through the kernels on 2 patches of 128^2 against the same
   model's forward on a CPU copy;
9. eval protocols: the main path's UNet on the same images through the
   sliding window (patch 256, overlap 0.5), dihedral-8 TTA (tiled 512) and
   whole-image evaluation (padded to a multiple of 32), each with its
   launches, images/s, idle share and conv times (its conv list's shapes
   checked against the plain version as for the zoo), and each checked in
   f32 against the same protocol on a CPU copy (TTA on a 256^2 crop at
   patch 256, to keep the CPU side short);
10. serve (after the train path, on its trained UNet): a background
   checkpoint write (``train.checkpoint.AsyncCheckpointWriter``) holds the
   weights of its ``submit`` though a train step follows at once, and the
   host time one save blocks the loop is timed, synchronous against
   background; the trained weights go out as a port checkpoint, a
   state-dict ``.pth`` (``compat.torch_export``) and a whole-module
   ``.pth`` under the reference's class identity, each is read back
   through ``load_model_any`` and serves 2 synthetic DRIVE-geometry
   images (one uint8, one uint16 array) through ``cli.predict.predict_arrays``
   (tiled, patch 512, bf16), with identical maps from the three; the JAX
   ``.ckpt`` fixture in ``tests/torch_port_data`` is read by the port's
   msgpack reader and its f32 forward held against the JAX output within
   1e-3; ``cli.evaluate.evaluate_arrays`` runs on the model read from the
   module ``.pth``; and the sliding-window, whole-image and TTA modes of
   ``predict_arrays`` run in bf16 on both images and in f32 on a 256^2 crop
   against a CPU copy.  Launches are read around each.

Prints the kernels line, the GPU's name and power limit, and as the last
line ``{"ok": true, "device": {...}}``; exits non-zero, printing no result,
when a phase fails or no GPU is available.  Details go to
``chiprun_out/chip_smoke/report.json``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")

# NVIDIA H100 SXM data sheet, dense rates (at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12      # tensor cores
F32_FLOPS = 67e12        # CUDA cores, no tensor cores

N_IMAGES, IMG_H, IMG_W = 4, 584, 565
PATCH = 512
INFER_BATCH = 32

# Train path: the train CLI's defaults, cut to 8 images and 2 x 10 steps.
TRAIN_IMAGES, TRAIN_PATCH, TRAIN_BATCH, TRAIN_LR = 8, 128, 32, 1e-6
TRAIN_VAL, TRAIN_STEPS, TRAIN_EPOCHS, VAL_CHUNK = 0.25, 10, 2, 64

# Probe path: scripts/tpu_imcol_conv_probe.py's geometry.
PROBE = dict(b=64, h=128, w=128, cin=128, cout=64)

# (B, H, W, Cin, Cout, relu) at the edges of the conv kernel's wgmma plan:
# one tile, boxes spanning images, ragged W and H, Cin not a multiple of
# 64, Cout not a multiple of the tile width, ReLU off.
PLAN_EDGE_CASES = [
    (1, 8, 16, 64, 64, True), (4, 8, 8, 64, 64, True),
    (2, 37, 29, 64, 64, True), (2, 37, 29, 16, 64, True),
    (2, 37, 29, 72, 96, False), (2, 16, 16, 64, 96, True),
    (2, 8, 8, 64, 160, False), (2, 8, 8, 256, 320, True),
]

# The fifteen zoo models of the zoo_eval phase: registry name -> launches
# of the conv kernel per eval forward, by body (bf16 convs with Cin % 8 !=
# 0 on mma_sync: Cin = 3, and MultiResUNet's truncated widths).
ZOO = {
    "ResUNet.ResUNet": {"mma_sync": 2, "wgmma": 13},
    "SegNet.SegNet": {"mma_sync": 1, "wgmma": 25},
    "UNetPP.NestedUNet": {"mma_sync": 1, "wgmma": 29},
    "AttentionUNet.AttentionUNet": {"mma_sync": 1, "wgmma": 21},
    "R2UNet.R2UNet": {"wgmma": 58},
    "R2AttentionUNet.R2AttentionUNet": {"wgmma": 58},
    "BCDUNet.BCDU_net_D3": {"mma_sync": 1, "wgmma": 24},
    "BCDUNet.BCDU_net_D1": {"mma_sync": 1, "wgmma": 20},
    "MultiResUNet.MultiResUNet": {"mma_sync": 25, "wgmma": 12},
    "DenseUNet.DenseUNet": {"wgmma": 40},
    "FRUNet.FRUNet": {"mma_sync": 1, "wgmma": 43},
    "BARUNet.BARUNet": {"mma_sync": 1, "wgmma": 21},
    "BIARUNet.BIARUNet": {"mma_sync": 1, "wgmma": 21},
    "MCUNet.MCUNet": {"mma_sync": 1, "wgmma": 18},
    "RetinaLiteNet.TransFuseNet": {"mma_sync": 1, "wgmma": 5},
}
ZOO_F32_PATCHES, ZOO_F32_HW, ZOO_F32_TOL = 2, 128, 1e-3
# Models with biased convs (and transposed convs) that no BatchNorm
# follows: BCDU-Net's and TransFuseNet's, and FRUNet's five 1x1 heads.
# Drawn as torch draws by default, each such conv keeps a third of its
# input's variance and each ReLU half of that, so after BCDU's ~16 of them
# the output is little more than its last bias, and FRUNet's averaged
# heads vary little.  ``build_model`` calibrates these convs as it does
# the BatchNorms, and every model that has one runs with its pre-sigmoid
# (BCDU, TransFuseNet) or pre-softmax (BARUNet, BIARUNet, whose softmax
# over one channel is a constant) head, the train CLI's --logit-head, so
# that their probabilities vary and the f32 check sees the path.
ZOO_BN_FREE = ("BCDUNet.BCDU_net_D3", "BCDUNet.BCDU_net_D1", "FRUNet.FRUNet",
               "RetinaLiteNet.TransFuseNet")
# Peak allocated memory of one tiled bf16 evaluation (16 patches of 512^2
# in one chunk) that a model must stay under: TransFuseNet's attention
# over 64 x 64 = 4096 tokens would hold 2.1 GB of scores if it formed them.
ZOO_PEAK_BYTES = {"RetinaLiteNet.TransFuseNet": 2e9}

# Protocols of the eval_protocols phase.
SLIDING_PATCH, SLIDING_OVERLAP, SPATIAL_DIVISOR = 256, 0.5, 32
TTA_F32_CROP = 256

# (B, H, W, Cin, Cout, relu) the zoo's forwards give the conv kernel beyond
# UNet's shapes: Cout 32 and 1 under one 64-wide tile, Cin 96, 160, 192,
# 320, 384 and 768, ReLU off with a bias as the shift, Cin 3 with ReLU off;
# MultiResUNet's truncated widths on mma_sync (odd Cin, odd Cout), its Cin
# 8 (a 16-byte TMA box) and odd Cout on wgmma, BCDU-Net's Cout-2 head with
# ReLU and its ConvLSTM gate convs (Cout 4 x hidden) on the two steps
# stacked on the batch; TransFuseNet's Cin 24 and 48 (part of one 64-wide
# K step) to Cout 16 and 32, its 8 -> 8, 8 -> 16 and 16 -> 32, MCUNet's
# InceptionA 32 -> 64 and a BABasicBlock's second conv (ReLU off).
ZOO_CONV_CASES = [
    (2, 64, 64, 3, 32, True), (2, 64, 64, 32, 32, True),
    (2, 64, 64, 96, 32, True), (2, 64, 64, 160, 32, True),
    (2, 32, 32, 192, 64, True), (2, 32, 32, 320, 64, True),
    (2, 16, 16, 384, 128, True), (2, 16, 16, 768, 256, False),
    (2, 64, 64, 64, 1, False), (2, 64, 64, 3, 64, False),
    (2, 64, 64, 64, 64, False), (2, 16, 16, 1024, 512, True),
    (2, 64, 64, 3, 8, True), (2, 64, 64, 17, 26, True),
    (2, 64, 64, 51, 32, True), (2, 32, 32, 35, 53, True),
    (2, 32, 32, 105, 64, True), (2, 16, 16, 71, 106, True),
    (2, 16, 16, 212, 128, True), (2, 8, 8, 142, 213, True),
    (2, 8, 8, 426, 256, True), (2, 4, 4, 284, 427, True),
    (2, 64, 64, 8, 17, True), (2, 32, 32, 128, 17, True),
    (2, 64, 64, 64, 8, True), (2, 64, 64, 64, 2, True),
    (4, 64, 64, 64, 128, False), (4, 32, 32, 128, 256, False),
    (4, 16, 16, 256, 512, False), (2, 16, 16, 128, 512, False),
    (2, 64, 64, 24, 16, True), (2, 64, 64, 48, 32, True),
    (2, 64, 64, 8, 8, True), (2, 64, 64, 8, 16, True),
    (2, 64, 64, 16, 32, True), (2, 64, 64, 32, 64, True),
    (2, 32, 32, 128, 128, False),
]
# Whole-image maps (608 x 576 padded from 584 x 565) down UNet's levels
# and SegNet's bottom (19 x 18), batch 1.
WHOLE_IMAGE_CONV_CASES = [
    (1, 608 // d, 576 // d, cin, cout, True)
    for d, cin, cout in ((1, 3, 64), (1, 64, 64), (2, 64, 128), (4, 128, 256),
                         (8, 256, 512), (16, 512, 1024), (16, 1024, 1024),
                         (32, 512, 512))]

# The serve phase: images served per call (one uint8, one uint16), the
# crop of the f32 checks against a CPU copy (the sliding window at patch
# 128 on it), saves timed per mode, and the JAX .ckpt fixture with its
# JAX output (tests/test_torch_port_ckpt_interop.write_jax_fixture).
SERVE_IMAGES, SERVE_CROP, SERVE_CROP_SLIDING, SERVE_SAVE_REPS = 2, 256, 128, 3
JAX_FIXTURE = os.path.join(ROOT, "tests", "torch_port_data",
                           "transfusenet_jax.ckpt")
JAX_FIXTURE_OUT = os.path.join(ROOT, "tests", "torch_port_data",
                               "transfusenet_jax_out.npy")
FIXTURE_TOL = 1e-3

# (spatial size, Cin, Cout) of UNet's 18 3x3 convs in forward order.
UNET_CONVS = [
    (512, 3, 64), (512, 64, 64),           # inc
    (256, 64, 128), (256, 128, 128),       # down1
    (128, 128, 256), (128, 256, 256),      # down2
    (64, 256, 512), (64, 512, 512),        # down3
    (32, 512, 1024), (32, 1024, 1024),     # down4
    (64, 1024, 512), (64, 512, 512),       # up1
    (128, 512, 256), (128, 256, 256),      # up2
    (256, 256, 128), (256, 128, 128),      # up3
    (512, 128, 64), (512, 64, 64),         # up4
]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def synthetic_drive(n, h, w, seed):
    """DRIVE-geometry images in [0, 1] with a circular FOV mask and
    random-walk vessel labels that darken the green channel."""
    import numpy as np

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    fov = ((yy - h / 2) ** 2 + (xx - w / 2) ** 2
           <= (0.47 * min(h, w)) ** 2).astype(np.float32)
    images = np.empty((n, h, w, 3), np.float32)
    labels = np.zeros((n, h, w), np.float32)
    for i in range(n):
        for _ in range(12):  # vessel branches
            steps = rng.randint(-2, 3, size=(4000, 2)).cumsum(axis=0)
            pts = steps + [rng.randint(h), rng.randint(w)]
            ys = np.clip(pts[:, 0], 0, h - 2)
            xs = np.clip(pts[:, 1], 0, w - 2)
            for dy in (0, 1):
                for dx in (0, 1):
                    labels[i, ys + dy, xs + dx] = 1.0
        labels[i] *= fov
        base = 0.35 + 0.25 * rng.rand(h, w, 3).astype(np.float32)
        base[..., 1] -= 0.25 * labels[i]
        images[i] = np.clip(base * fov[..., None], 0.0, 1.0)
    masks = np.repeat(fov[None], n, axis=0)
    return images, masks, labels


def build_model(device, seed, name="UNet.UNet"):
    """Full-width model from a seeded generator; each BatchNorm's (2-D and
    1-D) running statistics are measured on one batch (so activations
    keep their scale through the layers) and then perturbed, with gamma
    and beta drawn at random, so the eval-mode fold has work to do (for a
    model with a BatchNorm1d the batch's second image is darker).  A
    model that takes ``logit_head`` gets it.  In the models of
    ``ZOO_BN_FREE``, on the same batch, each conv and transposed conv
    with a bias that is called as a module is rescaled to an output of
    mean 0 and std 1 per channel: the calibration a BatchNorm gets,
    folded into the conv's weight and bias."""
    import torch
    from torch import nn

    from jcfszxc_unet_tpu_torch.models import create_model, model_takes
    from jcfszxc_unet_tpu_torch.ops.layers import reset_parameters

    def unit_output(conv, inputs, y):
        mean, std = y.mean(dim=(0, 2, 3)), y.std(dim=(0, 2, 3)) + 1e-6
        out_dim = 1 if isinstance(conv, nn.ConvTranspose2d) else 0
        conv.weight.div_(std.view([-1 if d == out_dim else 1
                                   for d in range(4)]))
        conv.bias.sub_(mean).div_(std)
        return (y - mean[:, None, None]) / std[:, None, None]

    g = torch.Generator().manual_seed(seed)
    model = create_model(name, **({"logit_head": True}
                                  if model_takes(name, "logit_head") else {}))
    reset_parameters(model, g)
    hooks = [m.register_forward_hook(unit_output) for m in model.modules()
             if name in ZOO_BN_FREE
             and isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))
             and m.bias is not None]
    bns = [m for m in model.modules()
           if isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d))]
    with torch.no_grad():
        for bn in bns:
            bn.weight.copy_(0.5 + torch.rand(bn.num_features, generator=g))
            bn.bias.copy_(0.2 * torch.randn(bn.num_features, generator=g))
    model = model.to(device=device, memory_format=torch.channels_last)
    calib = torch.rand((2, 3, PATCH, PATCH), generator=g)
    if any(isinstance(bn, nn.BatchNorm1d) for bn in bns):
        # A BatchNorm1d normalizes pooled features, which two noise images
        # barely tell apart: the second one is made darker.
        calib[1] *= 0.5
    calib = calib.to(device=device, memory_format=torch.channels_last)
    for bn in bns:
        bn.momentum = 1.0  # running stats := this batch's statistics
    model.train()
    for m in model.modules():  # no random masks: the seed fixes the model
        if isinstance(m, (nn.Dropout, nn.Dropout2d)):
            m.eval()
    with torch.no_grad():
        model(calib)
    for hook in hooks:
        hook.remove()
    with torch.no_grad():
        for bn in bns:
            bn.momentum = 0.1
            c = bn.num_features
            bn.running_mean.add_(
                (0.1 * torch.randn(c, generator=g)).to(device)
                * bn.running_var.sqrt())
            bn.running_var.mul_((0.8 + 0.4 * torch.rand(c, generator=g))
                                .to(device))
    return model.eval()


def plain_unet_forward(model, x):
    """UNet eval forward built only from the kernels' plain versions and
    stock torch ops.  x: NCHW; returns logits."""
    import torch
    import torch.nn.functional as F

    from jcfszxc_unet_tpu_torch.ops.kernels.conv_fused import (
        conv3x3_affine_relu_torch,
    )
    from jcfszxc_unet_tpu_torch.ops.layers import pad_or_crop_to

    def double_conv(block, x):
        seq = block.double_conv
        for conv, bn in ((seq[0], seq[1]), (seq[3], seq[4])):
            scale, shift = bn.folded()
            w = conv.weight.to(x.dtype).permute(2, 3, 1, 0)
            x = conv3x3_affine_relu_torch(
                x.permute(0, 2, 3, 1), w, scale, shift).permute(0, 3, 1, 2)
        return x

    def up(block, x1, x2):
        t = block.up
        x1 = F.conv_transpose2d(x1, t.weight.to(x1.dtype),
                                t.bias.to(x1.dtype), stride=2)
        x1 = pad_or_crop_to(x1, x2.shape[2], x2.shape[3])
        return double_conv(block.conv, torch.cat([x2, x1], dim=1))

    x1 = double_conv(model.inc, x)
    x2 = double_conv(model.down1.maxpool_conv[1], F.max_pool2d(x1, 2))
    x3 = double_conv(model.down2.maxpool_conv[1], F.max_pool2d(x2, 2))
    x4 = double_conv(model.down3.maxpool_conv[1], F.max_pool2d(x3, 2))
    x5 = double_conv(model.down4.maxpool_conv[1], F.max_pool2d(x4, 2))
    y = up(model.up4, up(model.up3, up(model.up2, up(model.up1, x5, x4),
                                         x3), x2), x1)
    oc = model.outc.conv
    return F.conv2d(y, oc.weight.to(y.dtype), oc.bias.to(y.dtype))


def time_ms(fn, target_ms: float = 40.0, max_reps: int = 50):
    """Mean device time of ``fn`` by CUDA events over back-to-back calls,
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    reps = int(min(max_reps, max(3, math.ceil(target_ms / max(first, 1e-3)))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def conv_cost(b, h, w, cin, cout, itemsize):
    """(flops, bytes) of one fused conv: 2*M*N*K multiply-adds plus the
    3-op epilogue; x, w, scale, shift read once, out written once."""
    m = b * h * w
    flops = 2 * m * cout * 9 * cin + 3 * m * cout
    nbytes = (m * cin + 9 * cin * cout + m * cout) * itemsize + 2 * cout * 4
    return flops, nbytes


def bound_ms(flops, nbytes, peak_flops):
    return max(nbytes / HBM_BYTES_PER_S, flops / peak_flops) * 1e3


# Kernel 1 against its plain version: both accumulate in f32 and differ
# only in summation order and (bf16) one output rounding.
CONV_TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def conv_inputs(g, b, h, w, cin, cout, dtype):
    """Random x (B, H, W, Cin), w (3, 3, Cin, Cout) scaled to keep the
    output near unit size, and f32 scale and shift, on the card."""
    import torch

    x = torch.randn((b, h, w, cin), generator=g, device="cuda").to(dtype)
    wt = (torch.randn((3, 3, cin, cout), generator=g, device="cuda")
          / math.sqrt(9 * cin)).to(dtype)
    scale = 0.5 + torch.rand((cout,), generator=g, device="cuda")
    shift = 0.1 * torch.randn((cout,), generator=g, device="cuda")
    return x, wt, scale, shift


def conv_check(path, shape, relu, dtype, body, got, want):
    """One comparison of kernel 1's output with its plain version's, as a
    row: max abs error, max |plain| and whether it is within CONV_TOL."""
    import torch

    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ref = float(want.abs().max())
    name = str(dtype).split(".")[-1]
    return {"path": path, "shape": list(shape), "relu": relu, "dtype": name,
            "body": body, "max_abs_err": err, "max_abs_plain": ref,
            "ok": err <= CONV_TOL[name] * ref}


def conv_list(calls, dtype, path, seed=7, target_ms=20.0):
    """Kernel 1 over a list of fused conv calls, ``{(B, H, W, Cin, Cout,
    relu): count}`` (as :func:`record_convs` gives), on random inputs at
    each shape: its output through the K-major entry that
    ``ops/blocks.conv_bn_relu_fused`` calls, checked against the plain
    version, and its time beside the plain version's, cuDNN's ``F.conv2d``
    alone (channels_last input, TF32 off) and its bound.  Each shape is
    run once and weighted by its count.  Returns {"rows", "checks",
    "total"}."""
    import torch
    import torch.nn.functional as F

    from jcfszxc_unet_tpu_torch.ops.kernels import conv_fused
    from jcfszxc_unet_tpu_torch.ops.kernels.conv_fused import (
        conv3x3_affine_relu_kmajor,
        conv3x3_affine_relu_torch,
    )

    g = torch.Generator(device="cuda").manual_seed(seed)
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    rows, checks = [], []
    for (b, h, wd, cin, cout, relu), n in sorted(calls.items()):
        x, w, scale, shift = conv_inputs(g, b, h, wd, cin, cout, dtype)
        w_km = w.permute(3, 0, 1, 2).contiguous()
        body = conv_fused.plan_for(x, w_km).body
        checks.append(conv_check(
            path, [b, h, wd, cin, cout], relu, dtype, body,
            conv3x3_affine_relu_kmajor(x, w_km, scale, shift, relu).float(),
            conv3x3_affine_relu_torch(x, w, scale, shift, relu).float()))
        x_cl = x.permute(0, 3, 1, 2)  # NCHW view in channels_last
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        flops, nbytes = conv_cost(b, h, wd, cin, cout, x.element_size())
        ms = time_ms(lambda: conv3x3_affine_relu_kmajor(
            x, w_km, scale, shift, relu), target_ms)
        rows.append({
            "shape": [b, h, wd, cin, cout], "relu": relu, "count": n,
            "body": body, "ms": ms, "tflops": flops / ms / 1e9,
            "plain_ms": time_ms(lambda: conv3x3_affine_relu_torch(
                x, w, scale, shift, relu), target_ms),
            "library_ms": time_ms(lambda: F.conv2d(x_cl, w_oihw, padding=1),
                                  target_ms),
            "bound_ms": bound_ms(flops, nbytes, peak),
            "flops": flops, "bytes": nbytes,
            "max_abs_err": checks[-1]["max_abs_err"], "ok": checks[-1]["ok"],
        })
        del x, w, w_km, x_cl, w_oihw
    total = {key: sum(r["count"] * r[key] for r in rows)
             for key in ("ms", "plain_ms", "library_ms", "bound_ms", "flops",
                         "bytes")}
    total["n_convs"] = sum(calls.values())
    total["bound_by"] = ("operations" if total["flops"] / peak
                         > total["bytes"] / HBM_BYTES_PER_S else "bytes")
    total["checks_ok"] = sum(c["ok"] for c in checks)
    total["checks"] = len(checks)
    return {"rows": rows, "checks": checks, "total": total}


def phase_build(report):
    from jcfszxc_unet_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    build.load_library()
    dt = time.perf_counter() - t0
    report["build"] = {"seconds": dt, "cached": build.build_info["cached"],
                       "path": build.build_info["path"]}
    if "ptxas" in build.build_info:
        with open(os.path.join(OUT_DIR, "ptxas.log"), "w") as f:
            f.write(build.build_info["ptxas"])
    print(f"[build] kernels ready in {dt:.1f} s "
          f"(cached={build.build_info['cached']})", flush=True)


def phase_main_path(report, state):
    import numpy as np
    import torch

    from jcfszxc_unet_tpu_torch.cli.evaluate import evaluate_arrays
    from jcfszxc_unet_tpu_torch.ops.kernels import conv_fused, dice_fused

    dev = torch.device("cuda")
    model = build_model(dev, seed=0)
    images, masks, labels = synthetic_drive(N_IMAGES, IMG_H, IMG_W, seed=0)
    state.update(model=model, images=images, masks=masks, labels=labels)
    n_patches = grid_count(IMG_H, IMG_W, PATCH) * N_IMAGES
    n_chunks = math.ceil(n_patches / min(INFER_BATCH, n_patches))

    def run():
        return evaluate_arrays(
            model, images, masks, labels, patch_size=PATCH,
            inference_batch_size=INFER_BATCH, compute_dtype=torch.bfloat16,
            device=dev)

    torch.cuda.synchronize()
    conv_fused.counter.reset()
    dice_fused.counter.reset()
    res = run()
    torch.cuda.synchronize()
    launches = {"conv3x3_affine_relu": conv_fused.counter.launches,
                "dice_sums": dice_fused.counter.launches}
    bodies = dict(conv_fused.counter.bodies)
    state["launches"] = launches
    state["conv_bodies"] = {"eval": bodies}
    pm = res["pred_maps"]
    checks = {
        "pred_shape": pm.shape == (N_IMAGES, IMG_H, IMG_W),
        "pred_finite_in_0_1": bool(np.isfinite(pm).all()
                                   and pm.min() >= 0 and pm.max() <= 1),
        "dice_finite": all(np.isfinite(d) and 0 <= d <= 1
                           for d in res["dice"]),
        "auc_finite": all(np.isfinite(a) and 0 <= a <= 1 for a in res["auc"]),
        "conv_launches_18_per_chunk":
            launches["conv3x3_affine_relu"] == 18 * n_chunks,
        # every bf16 conv with Cin % 8 == 0 on wgmma; Cin = 3 on mma.sync
        "conv_bodies_17_wgmma_1_mma_sync_per_chunk":
            bodies == {"wgmma": 17 * n_chunks, "mma_sync": n_chunks},
        "dice_launched": launches["dice_sums"] >= 1,
    }
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    report["main_path"] = {
        "n_images": N_IMAGES, "image_hw": [IMG_H, IMG_W], "patch": PATCH,
        "n_patches": n_patches, "n_chunks": n_chunks, "dtype": "bfloat16",
        "launches": launches, "conv_bodies": bodies, "dice": res["dice"],
        "auc": res["auc"],
        "prob_mean": float(pm.mean()), "prob_std": float(pm.std()),
        "eval_seconds": dt, "images_per_s": N_IMAGES / dt, "checks": checks,
    }
    print(f"[main] {n_patches} patches in {n_chunks} chunk(s); launches "
          f"{launches}, conv bodies {bodies}; dice "
          f"{[round(d, 4) for d in res['dice']]}; "
          f"auc {[round(a, 4) for a in res['auc']]}", flush=True)
    print(f"[main] eval of {N_IMAGES} images: {dt:.3f} s = "
          f"{N_IMAGES / dt:.2f} images/s", flush=True)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"main-path checks failed: {bad}")
    profile_eval(report, run)
    profile_patch_gather(report, images)


def device_rows(fn, reps: int = 1):
    """Device-side events (kernels and copies) of ``reps`` calls of ``fn``
    under torch.profiler: [{"name", "count", "device_ms"}] per call,
    largest first.  Host-side operator rows and user-annotation ranges
    (such as ``Optimizer.step#RMSprop.step``) are left out, since their
    device time repeats that of the kernels they cover."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [{"name": ev.key[:120], "count": ev.count / reps,
             "device_ms": ev.self_device_time_total / 1e3 / reps}
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and not getattr(ev, "is_user_annotation", False)
            and ev.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r["device_ms"])


def profile_eval(report, run):
    """Device time by kernel over one evaluation, and the device's idle
    share against the untraced evaluation's wall time."""
    rows = device_rows(run)
    total = sum(r["device_ms"] for r in rows)
    wall_ms = report["main_path"]["eval_seconds"] * 1e3
    idle = max(0.0, 1.0 - total / wall_ms)
    report["profile"] = {"device_ms_total": total, "untraced_wall_ms": wall_ms,
                         "device_idle_share": idle, "top": rows[:25]}
    print(f"[profile] device busy {total:.2f} ms in one evaluation "
          f"(untraced wall {wall_ms:.1f} ms, idle share {idle:.3f}); top:",
          flush=True)
    for r in rows[:8]:
        print(f"    {r['device_ms']:9.3f} ms  x{r['count']:<4g} {r['name']}",
              flush=True)


def profile_patch_gather(report, images):
    """The eval path's patch cut (``extract_patches``: one advanced-index
    gather) beside a stack of per-patch slices, its earlier form, on the
    same pool and grid: device time (profiler) and host-clock time per
    call, each over 20 calls."""
    import torch

    from jcfszxc_unet_tpu_torch.data.sampler import (
        build_grid_sample_map,
        extract_patches,
    )

    pool = torch.as_tensor(images, device="cuda")
    centers = build_grid_sample_map(N_IMAGES, IMG_H, IMG_W, PATCH // 2)
    half = PATCH // 2

    def slice_stack():
        return torch.stack([
            pool[i, x - half:x - half + PATCH, y - half:y - half + PATCH]
            for i, x, y in centers.tolist()])

    def gather():
        return extract_patches(pool, centers, PATCH)

    equal = bool(torch.equal(gather(), slice_stack()))
    out = {"n_patches": len(centers), "dtype": str(pool.dtype),
           "equal": equal}
    for name, fn in (("gather", gather), ("slice_stack", slice_stack)):
        rows = device_rows(fn, reps=20)
        out[name] = {"device_ms": sum(r["device_ms"] for r in rows),
                     "host_ms": host_ms(fn, 20), "rows": rows[:6]}
    report["patch_gather"] = out
    print(f"[gather] {len(centers)} patches of {PATCH}^2 from {N_IMAGES} "
          f"images: gather {out['gather']['device_ms'] * 1e3:.1f} us device, "
          f"{out['gather']['host_ms'] * 1e3:.1f} us per call; slice stack "
          f"{out['slice_stack']['device_ms'] * 1e3:.1f} us device, "
          f"{out['slice_stack']['host_ms'] * 1e3:.1f} us per call; equal "
          f"{equal}", flush=True)
    if not equal:
        raise AssertionError("extract_patches differs from the slice stack")


def phase_f32_end_to_end(report, state):
    import numpy as np
    import torch

    from jcfszxc_unet_tpu_torch.data.sampler import (
        build_grid_sample_map,
        extract_patches,
    )
    from jcfszxc_unet_tpu_torch.eval.predictor import Predictor

    model = state["model"]
    img = torch.as_tensor(state["images"][:1], device="cuda")
    centers = build_grid_sample_map(1, IMG_H, IMG_W, PATCH // 2)
    patches = extract_patches(img, centers, PATCH)
    pred = Predictor(model, compute_dtype=torch.float32, patch_size=PATCH,
                     device="cuda")
    got = pred.predict_patches(patches)[..., 0]
    with torch.inference_mode():
        logits = plain_unet_forward(model, patches.permute(0, 3, 1, 2))
        want = torch.sigmoid(logits.float())[:, 0]
    diff = float((got - want).abs().max())
    report["f32_end_to_end"] = {"n_patches": int(patches.shape[0]),
                                "max_abs_dprob": diff, "tolerance": 1e-3,
                                "prob_std": float(want.std())}
    print(f"[f32] port vs plain forward on {patches.shape[0]} patches: "
          f"max |dprob| = {diff:.3e} (tolerance 1e-3)", flush=True)
    if not np.isfinite(diff) or diff > 1e-3:
        raise AssertionError(f"f32 end-to-end max |dprob| {diff} > 1e-3")


def phase_kernels(report, state):
    from collections import Counter

    import torch

    from jcfszxc_unet_tpu_torch.ops.kernels import conv_fused
    from jcfszxc_unet_tpu_torch.ops.kernels.conv_fused import (
        conv3x3_affine_relu,
        conv3x3_affine_relu_torch,
    )
    from jcfszxc_unet_tpu_torch.ops.kernels.dice_fused import (
        dice_sums,
        dice_sums_torch,
    )

    g = torch.Generator(device="cuda").manual_seed(1)
    dev = "cuda"

    # Correctness at batch 2 at UNet's eval shapes, plus ReLU off and a
    # ragged whole DRIVE image, in both types; then the train path's
    # validation shapes (a chunk of VAL_CHUNK patches at each conv's size
    # for patch TRAIN_PATCH, 128^2 down to 8^2, where a wgmma tile's box
    # spans two images at 8^2) in bf16, which that path runs (its f32 twin
    # is the train_val_f32 phase); then the edges of the wgmma plan in
    # bf16; then the zoo's and the whole-image shapes in both types.
    both = (torch.float32, torch.bfloat16)
    bf16 = (torch.bfloat16,)
    cases = [("eval", 2, hw, hw, cin, cout, True, both) for hw, cin, cout
             in sorted(set(UNET_CONVS))]
    cases += [("eval", 2, 64, 64, 64, 128, False, both),
              ("eval", 1, IMG_H, IMG_W, 3, 64, True, both)]
    down = PATCH // TRAIN_PATCH
    cases += [("train_val", VAL_CHUNK, hw // down, hw // down, cin, cout, True,
               bf16) for hw, cin, cout in sorted(set(UNET_CONVS))]
    cases += [("plan_edge", *shape, bf16) for shape in PLAN_EDGE_CASES]
    cases += [("zoo", *shape, both) for shape in ZOO_CONV_CASES]
    cases += [("whole_image", *shape, both)
              for shape in WHOLE_IMAGE_CONV_CASES]
    checks = []

    for path, b, h, wd, cin, cout, relu, dtypes in cases:
        for dtype in dtypes:
            x, w, scale, shift = conv_inputs(g, b, h, wd, cin, cout, dtype)
            runs = dict(conv_fused.counter.bodies)
            k = conv3x3_affine_relu(x, w, scale, shift, relu=relu).float()
            body = next(name for name, n in conv_fused.counter.bodies.items()
                        if n != runs.get(name, 0))
            checks.append(conv_check(
                path, [b, h, wd, cin, cout], relu, dtype, body, k,
                conv3x3_affine_relu_torch(x, w, scale, shift,
                                          relu=relu).float()))
            del x, w, k

    # Checks and times at the main path's shapes (batch = one chunk of
    # patches; the persistent wgmma blocks walk more tiles there than at
    # the eval cases' batch 2), in bf16 (the main path) and f32.
    b = min(INFER_BATCH, report["main_path"]["n_patches"])
    conv_times = {}
    for dtype in (torch.bfloat16, torch.float32):
        res = conv_list(Counter((b, hw, hw, cin, cout, True)
                                for hw, cin, cout in UNET_CONVS),
                        dtype, "eval_chunk", seed=1, target_ms=40.0)
        checks += res["checks"]
        by_shape = {tuple(r["shape"]): r for r in res["rows"]}
        rows = [{"hw": hw, "cin": cin, "cout": cout,
                 **by_shape[(b, hw, hw, cin, cout)]}
                for hw, cin, cout in UNET_CONVS]
        total = res["total"]
        name = str(dtype).split(".")[-1]
        conv_times[name] = {"batch": b, "rows": rows, "total": total}
        print(f"[conv] one {name} forward at batch {b} (18 convs): kernel "
              f"{total['ms']:.2f} ms ({total['flops'] / total['ms'] / 1e9:.1f}"
              f" TFLOP/s), plain {total['plain_ms']:.2f} ms, cuDNN conv "
              f"{total['library_ms']:.2f} ms, bound {total['bound_ms']:.3f} ms "
              f"({total['bound_by']})", flush=True)
        if dtype == torch.bfloat16:
            print("[conv] per layer, bf16: size Cin->Cout body ms TFLOP/s "
                  "bound_ms cuDNN_ms", flush=True)
            for r in rows:
                print(f"    {r['hw']:4d}^2 {r['cin']:5d}->{r['cout']:<5d} "
                      f"{r['body']:8s} {r['ms']:7.3f} {r['tflops']:6.1f} "
                      f"{r['bound_ms']:7.3f} {r['library_ms']:7.3f}",
                      flush=True)
            with open(os.path.join(OUT_DIR, "conv_layers.json"), "w") as f:
                json.dump({"gpu": gpu_name_and_power(), **conv_times[name]},
                          f, indent=1)
    total = conv_times["bfloat16"]["total"]
    for path in ("eval", "eval_chunk", "train_val", "plan_edge", "zoo",
                 "whole_image"):
        mine = [c for c in checks if c["path"] == path]
        err16 = max(c["max_abs_err"] / c["max_abs_plain"] for c in mine
                    if c["dtype"] == "bfloat16")
        print(f"[conv] kernel vs plain at the {path} shapes: "
              f"{sum(c['ok'] for c in mine)}/{len(mine)} shape/dtype cases "
              f"within 1e-4 (f32) / 1e-2 (bf16) of max|plain|; bf16 max "
              f"err / max|plain| {err16:.2e}", flush=True)
    failures = [c for c in checks if not c["ok"]]
    wrong_body = [c for c in checks if c["dtype"] == "bfloat16"
                  and c["shape"][3] % 8 == 0 and c["body"] != "wgmma"]
    if wrong_body:
        failures.append({"bf16 Cin % 8 == 0 off the wgmma body": wrong_body})

    # Dice: correctness on 20 x 584 x 565, times at the main path's shape.
    dice_rows = {}
    for n in (20, N_IMAGES):
        p = (torch.rand((n, IMG_H, IMG_W), generator=g, device=dev) * 1.2
             - 0.1)
        t = (torch.rand((n, IMG_H, IMG_W), generator=g, device=dev)
             > 0.9).float()
        got = dice_sums(p, t)
        want = dice_sums_torch(p, t)
        rel = max(float(((a - b_).abs() / b_.abs().clamp(min=1e-30)).max())
                  for a, b_ in zip(got, want))
        abs_err = max(float((a - b_).abs().max()) for a, b_ in zip(got, want))
        nbytes = 2 * p.numel() * 4 + 3 * n * 4
        flops = 5 * p.numel()
        dice_rows[n] = {
            "shape": [n, IMG_H, IMG_W], "max_rel_err": rel,
            "max_abs_err": abs_err,
            # device time (profiler): back-to-back calls are host-bound
            "ms": sum(r["device_ms"] for r in device_rows(
                lambda: dice_sums(p, t), reps=20)),
            "plain_ms": sum(r["device_ms"] for r in device_rows(
                lambda: dice_sums_torch(p, t), reps=20)),
            "call_ms": time_ms(lambda: dice_sums(p, t)),
            "bound_ms": bound_ms(flops, nbytes, F32_FLOPS),
            "bytes": nbytes, "flops": flops,
        }
        ok = rel <= 1e-5
        dice_rows[n]["ok"] = ok
        if not ok:
            failures.append({"dice": n, "max_rel_err": rel})
        print(f"[dice] {n}x{IMG_H}x{IMG_W}: rel err {rel:.2e} (tolerance "
              f"1e-5); kernel {dice_rows[n]['ms'] * 1e3:.1f} us, plain "
              f"{dice_rows[n]['plain_ms'] * 1e3:.1f} us, bound "
              f"{dice_rows[n]['bound_ms'] * 1e3:.1f} us", flush=True)

    report["conv_checks"] = checks
    report["conv_times"] = conv_times
    report["dice"] = {str(k): v for k, v in dice_rows.items()}
    if failures:
        raise AssertionError(f"kernel/plain mismatches: {failures}")

    main = dice_rows[N_IMAGES]
    launches = state["launches"]
    state["kernels"] = [
        {"name": "conv3x3_affine_relu", "route": "cuda",
         "source": "jcfszxc_unet_tpu_torch/csrc/conv3x3_affine_relu.cu",
         "replaces": "jcfszxc_unet_tpu/ops/pallas/conv_fused.py:81",
         "launches": launches["conv3x3_affine_relu"],
         "max_abs_err": max(c["max_abs_err"] for c in checks
                            if c["dtype"] == "bfloat16"),
         "ms": total["ms"], "plain_ms": total["plain_ms"],
         "bound_ms": total["bound_ms"], "bound_by": total["bound_by"],
         "library_ms": total["library_ms"]},
        {"name": "dice_sums", "route": "cuda",
         "source": "jcfszxc_unet_tpu_torch/csrc/dice_sums.cu",
         "replaces": "jcfszxc_unet_tpu/ops/pallas/dice_fused.py:37",
         "launches": launches["dice_sums"],
         "max_abs_err": main["max_abs_err"],
         "ms": main["ms"], "plain_ms": main["plain_ms"],
         "bound_ms": main["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
    ]


def record_convs(fn):
    """The fused conv calls that ``fn`` makes, as {(B, H, W, Cin, Cout,
    relu): count}, read at the blocks' entry point (counts untouched)."""
    from jcfszxc_unet_tpu_torch.ops import blocks

    calls = {}
    real = blocks.conv3x3_affine_relu_kmajor

    def recording(x, w_km, scale, shift, relu=True):
        key = (*x.shape, w_km.shape[0], bool(relu))
        calls[key] = calls.get(key, 0) + 1
        return real(x, w_km, scale, shift, relu)

    blocks.conv3x3_affine_relu_kmajor = recording
    try:
        fn()
    finally:
        blocks.conv3x3_affine_relu_kmajor = real
    return calls


# Kernel names of F.scaled_dot_product_attention's backends on the card, in
# the order they are tested: cuDNN's kernel name holds "flash" too, so it
# comes first.  The math backend runs plain matmuls.
SDPA_MARKS = (("cudnn_generated_fort_native_sdpa", "cudnn"),
              ("flash", "flash"), ("fmha", "efficient"),
              ("efficient", "efficient"))


def sdpa_backend(kernel_name):
    """The SDPA backend whose kernel is ``kernel_name``, or None."""
    name = kernel_name.lower()
    return next((backend for mark, backend in SDPA_MARKS if mark in name),
                None)


def timed_eval(run, n_images):
    """(seconds of one untraced run after the counted one, device busy ms
    and idle share of one profiled run, and the attention kernels in
    it)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rows = device_rows(run)
    busy = sum(r["device_ms"] for r in rows)
    kernel = sum(r["device_ms"] for r in rows if "conv_kernel" in r["name"])
    return {"eval_seconds": dt, "images_per_s": n_images / dt,
            "device_ms_total": busy, "conv_kernel_device_ms": kernel,
            "device_idle_share": max(0.0, 1.0 - busy / (dt * 1e3)),
            "top": rows[:12],
            "attention_kernels": {
                r["name"]: sdpa_backend(r["name"]) for r in rows
                if sdpa_backend(r["name"])}}


def launch_counts():
    from jcfszxc_unet_tpu_torch.ops.kernels import conv_fused, dice_fused

    return ({"conv3x3_affine_relu": conv_fused.counter.launches,
             "dice_sums": dice_fused.counter.launches},
            dict(conv_fused.counter.bodies))


def reset_counts():
    import torch

    from jcfszxc_unet_tpu_torch.ops.kernels import conv_fused, dice_fused

    torch.cuda.synchronize()
    conv_fused.counter.reset()
    dice_fused.counter.reset()


def f32_against_cpu_copy(model, fn, **predictor_kwargs):
    """max |dprob| between ``fn(predictor)`` on the card and on a CPU copy
    of ``model``, both f32 (on the CPU the wrappers take their plain
    versions), and the reference's std; ``predictor_kwargs`` go to both
    predictors."""
    import copy

    import torch

    from jcfszxc_unet_tpu_torch.eval.predictor import Predictor

    got = fn(Predictor(model, compute_dtype=torch.float32, device="cuda",
                       **predictor_kwargs))
    cpu = Predictor(copy.deepcopy(model).cpu(), compute_dtype=torch.float32,
                    device="cpu", **predictor_kwargs)
    want = fn(cpu)
    del cpu
    diff = float((got.cpu() - want).abs().max())
    return diff, float(want.std())


def phase_zoo_eval(report, state):
    import numpy as np
    import torch

    from jcfszxc_unet_tpu_torch.cli.evaluate import evaluate_arrays
    from jcfszxc_unet_tpu_torch.data.sampler import extract_patches

    dev = torch.device("cuda")
    images, masks, labels = state["images"], state["masks"], state["labels"]
    n_patches = grid_count(IMG_H, IMG_W, PATCH) * N_IMAGES
    n_chunks = math.ceil(n_patches / min(INFER_BATCH, n_patches))
    f32_centers = np.array([[0, IMG_H // 2, IMG_W // 2],
                            [1, IMG_H // 3, IMG_W // 3]][:ZOO_F32_PATCHES])
    f32_patches = extract_patches(torch.as_tensor(images[:2], device=dev),
                                  f32_centers, ZOO_F32_HW)
    out, failures = {}, []
    launches_sum = {"conv3x3_affine_relu": 0, "dice_sums": 0}
    conv_by_model = {}
    for k, (name, per_chunk) in enumerate(ZOO.items()):
        model = build_model(dev, seed=10 + k, name=name)

        def run():
            return evaluate_arrays(
                model, images, masks, labels, patch_size=PATCH,
                inference_batch_size=INFER_BATCH,
                compute_dtype=torch.bfloat16, device=dev)

        reset_counts()
        base_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = run()
        torch.cuda.synchronize()
        peak_bytes = torch.cuda.max_memory_allocated()
        launches, bodies = launch_counts()
        for key in launches_sum:
            launches_sum[key] += launches[key]
        conv_by_model[name] = bodies
        want_bodies = {b: n * n_chunks for b, n in per_chunk.items()}
        pm = res["pred_maps"]
        patches = extract_patches(torch.as_tensor(images[:1], device=dev),
                                  np.array([[0, IMG_H // 2, IMG_W // 2]]),
                                  PATCH)
        calls = record_convs(lambda: bf16_forward(model, patches))
        # one patch recorded; a call at batch k (ConvLSTM x-halves: 2) runs
        # at k times the chunk's batch
        convs = conv_list({(key[0] * min(INFER_BATCH, n_patches), *key[1:]): n
                           for key, n in calls.items()},
                          torch.bfloat16, "zoo_chunk")
        times = convs["total"]
        diff, std = f32_against_cpu_copy(
            model, lambda p: p.predict_patches(f32_patches.to(p.device)))
        row = {
            "launches": launches, "conv_bodies": bodies,
            "expected_conv_bodies": want_bodies,
            "dice": res["dice"], "auc": res["auc"],
            "prob_mean": float(pm.mean()), "prob_std": float(pm.std()),
            "conv_per_forward": convs,
            "f32_max_abs_dprob": diff, "f32_prob_std": std,
            "peak_allocated_bytes": peak_bytes,
            "peak_over_start_bytes": peak_bytes - base_bytes,
            **timed_eval(run, N_IMAGES),
        }
        row["checks"] = {
            "pred_finite_in_0_1": bool(np.isfinite(pm).all() and pm.min() >= 0
                                       and pm.max() <= 1),
            "dice_finite": all(np.isfinite(d) and 0 <= d <= 1
                               for d in res["dice"]),
            "auc_finite": all(np.isfinite(a) and 0 <= a <= 1
                              for a in res["auc"]),
            "conv_bodies_as_expected": bodies == want_bodies,
            "dice_launched": launches["dice_sums"] >= 1,
            "f32_within_1e-3": bool(np.isfinite(diff)
                                    and diff <= ZOO_F32_TOL),
            # a comparison that a nearly constant output would pass anyway
            "f32_prob_std_over_10x_tol": std >= 10 * ZOO_F32_TOL,
            "conv_list_kernel_vs_plain": times["checks_ok"] == times["checks"],
            "peak_allocated_under_limit":
                peak_bytes < ZOO_PEAK_BYTES.get(name, math.inf),
        }
        out[name] = row
        attention = row["attention_kernels"]
        bad = [c for c, ok in row["checks"].items() if not ok]
        if bad:
            failures.append({name: bad})
        print(f"[zoo] {name}: launches {launches}, conv bodies {bodies} "
              f"(expected {want_bodies}); dice "
              f"{[round(d, 4) for d in res['dice']]}, auc "
              f"{[round(a, 4) for a in res['auc']]}; "
              f"{row['images_per_s']:.2f} images/s, idle share "
              f"{row['device_idle_share']:.3f}; conv per 16-patch forward: "
              f"kernel {times['ms']:.2f} ms "
              f"({times['flops'] / times['ms'] / 1e9:.1f} TFLOP/s), cuDNN "
              f"{times['library_ms']:.2f} ms, bound {times['bound_ms']:.2f} "
              f"ms, kernel vs plain {times['checks_ok']}/{times['checks']} "
              f"shapes; f32 vs CPU max |dprob| {diff:.2e}, prob std "
              f"{std:.3e}; peak allocated {peak_bytes / 2**20:.0f} MiB "
              f"({(peak_bytes - base_bytes) / 2**20:.0f} MiB over the start)"
              + (f"; attention on {sorted(set(attention.values()))}"
                 if attention else "")
              + (f"; FAILED {bad}" if bad else ""), flush=True)
        del model, res
        torch.cuda.empty_cache()
    report["zoo_eval"] = out
    state["zoo_launches"] = launches_sum
    state["zoo_conv_launches"] = conv_by_model
    state["conv_bodies"]["zoo"] = {
        b: sum(m.get(b, 0) for m in conv_by_model.values())
        for b in ("wgmma", "mma_sync")}
    if failures:
        raise AssertionError(f"zoo checks failed: {failures}")


def bf16_forward(model, patches):
    """One bf16 eval forward of (B, P, P, C) patches through ``model``."""
    import torch

    with torch.inference_mode():
        return model(patches.permute(0, 3, 1, 2).to(torch.bfloat16))


def sliding_windows(h, w, patch, overlap):
    step = int(patch * (1 - overlap))
    return (len(range(0, h - patch + 1, step))
            * len(range(0, w - patch + 1, step)))


def phase_eval_protocols(report, state):
    import numpy as np
    import torch

    from jcfszxc_unet_tpu_torch.cli.evaluate import evaluate_arrays

    dev = torch.device("cuda")
    model = state["model"]
    images, masks, labels = state["images"], state["masks"], state["labels"]
    n_tiles = grid_count(IMG_H, IMG_W, PATCH) * N_IMAGES
    windows = sliding_windows(IMG_H, IMG_W, SLIDING_PATCH, SLIDING_OVERLAP)
    # (evaluate_arrays kwargs, UNet forwards per evaluation, f32 check)
    crop = (slice(0, 1), slice(IMG_H // 2 - TTA_F32_CROP // 2,
                               IMG_H // 2 + TTA_F32_CROP // 2),
            slice(IMG_W // 2 - TTA_F32_CROP // 2,
                  IMG_W // 2 + TTA_F32_CROP // 2))
    protocols = {
        "sliding_window": (
            dict(sliding_window=True, patch_size=SLIDING_PATCH,
                 overlap=SLIDING_OVERLAP),
            N_IMAGES * math.ceil(windows / INFER_BATCH),
            lambda p: p.predict_full_image(images[0], SLIDING_PATCH,
                                           SLIDING_OVERLAP, INFER_BATCH)),
        "tta": (
            dict(tta=True, patch_size=PATCH),
            8 * math.ceil(n_tiles / INFER_BATCH),
            lambda p: p.predict_images(images[crop], TTA_F32_CROP)),
        "spatial": (
            dict(spatial=True, patch_size=PATCH),
            math.ceil(N_IMAGES / INFER_BATCH),
            lambda p: p.predict_spatial(images[:1], SPATIAL_DIVISOR)),
    }
    out, failures = {}, []
    launches_sum = {"conv3x3_affine_relu": 0, "dice_sums": 0}
    bodies_sum = {"wgmma": 0, "mma_sync": 0}
    for name, (kwargs, forwards, f32_fn) in protocols.items():
        def run():
            return evaluate_arrays(
                model, images, masks, labels,
                inference_batch_size=INFER_BATCH,
                compute_dtype=torch.bfloat16, device=dev, **kwargs)

        reset_counts()
        res = run()
        torch.cuda.synchronize()
        launches, bodies = launch_counts()
        for key in launches_sum:
            launches_sum[key] += launches[key]
        for key in bodies_sum:
            bodies_sum[key] += bodies.get(key, 0)
        calls = record_convs(run)
        convs = conv_list(calls, torch.bfloat16, f"protocol_{name}")
        times = convs["total"]
        diff, std = f32_against_cpu_copy(model, f32_fn)
        pm = res["pred_maps"]
        row = {"kwargs": {k: v for k, v in kwargs.items()},
               "forwards": forwards, "launches": launches,
               "conv_bodies": bodies, "dice": res["dice"], "auc": res["auc"],
               "prob_mean": float(pm.mean()),
               "conv_per_evaluation": convs, "f32_max_abs_dprob": diff,
               "f32_prob_std": std, **timed_eval(run, N_IMAGES)}
        row["checks"] = {
            "pred_shape": pm.shape == (N_IMAGES, IMG_H, IMG_W),
            "pred_finite_in_0_1": bool(np.isfinite(pm).all() and pm.min() >= 0
                                       and pm.max() <= 1),
            "dice_finite": all(np.isfinite(d) and 0 <= d <= 1
                               for d in res["dice"]),
            "auc_finite": all(np.isfinite(a) and 0 <= a <= 1
                              for a in res["auc"]),
            "conv_launches_18_per_forward":
                launches["conv3x3_affine_relu"] == 18 * forwards,
            "conv_bodies_17_wgmma_1_mma_sync_per_forward": bodies == {
                "wgmma": 17 * forwards, "mma_sync": forwards},
            "dice_launched": launches["dice_sums"] >= 1,
            "f32_within_1e-3": bool(np.isfinite(diff) and diff <= 1e-3),
            "conv_list_kernel_vs_plain": times["checks_ok"] == times["checks"],
        }
        out[name] = row
        bad = [c for c, ok in row["checks"].items() if not ok]
        if bad:
            failures.append({name: bad})
        print(f"[protocol] {name}: {forwards} forwards, launches {launches}; "
              f"dice {[round(d, 4) for d in res['dice']]}; "
              f"{row['images_per_s']:.2f} images/s, idle share "
              f"{row['device_idle_share']:.3f}; conv per evaluation "
              f"({times['n_convs']} calls): kernel {times['ms']:.2f} ms, "
              f"cuDNN {times['library_ms']:.2f} ms, bound "
              f"{times['bound_ms']:.2f} ms, kernel vs plain "
              f"{times['checks_ok']}/{times['checks']} shapes; f32 vs CPU "
              f"max |dprob| {diff:.2e}" + (f"; FAILED {bad}" if bad else ""),
              flush=True)
    report["eval_protocols"] = out
    state["protocol_launches"] = launches_sum
    state["conv_bodies"]["protocols"] = bodies_sum
    if failures:
        raise AssertionError(f"protocol checks failed: {failures}")


def grid_count(h, w, patch):
    """Patches of the half-overlapping grid over one h x w image."""
    half = patch // 2
    return len(range(half, h, half)) * len(range(half, w, half))


def host_ms(fn, reps: int):
    """Mean host-clock time of ``fn`` over ``reps`` calls that end in a
    device sync, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def phase_train_path(report, state):
    import torch

    import numpy as np

    from jcfszxc_unet_tpu_torch.cli.train import split_indices, train_arrays
    from jcfszxc_unet_tpu_torch.data.sampler import build_grid_sample_map
    from jcfszxc_unet_tpu_torch.models import create_model
    from jcfszxc_unet_tpu_torch.ops.kernels import conv_fused, dice_fused
    from jcfszxc_unet_tpu_torch.ops.layers import reset_parameters
    from jcfszxc_unet_tpu_torch.train.checkpoint import load_model
    from jcfszxc_unet_tpu_torch.train.trainer import build_val_patches

    dev = torch.device("cuda")
    model = create_model("UNet.UNet")
    reset_parameters(model, torch.Generator().manual_seed(2))
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    images, masks, labels = synthetic_drive(TRAIN_IMAGES, IMG_H, IMG_W,
                                            seed=1)
    n_val = int(TRAIN_IMAGES * TRAIN_VAL)
    n_val_patches = n_val * grid_count(IMG_H, IMG_W, TRAIN_PATCH)
    n_chunks = math.ceil(n_val_patches / VAL_CHUNK)
    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(ckpt_dir, exist_ok=True)
    save_path = os.path.join(ckpt_dir, "best_model.pt")
    metrics_path = os.path.join(OUT_DIR, "train_metrics.jsonl")
    for path in (save_path, metrics_path):
        if os.path.exists(path):
            os.remove(path)

    torch.cuda.synchronize()
    conv_fused.counter.reset()
    dice_fused.counter.reset()
    t0 = time.perf_counter()
    res = train_arrays(
        model, images, masks, labels, steps=TRAIN_STEPS,
        batch_size=TRAIN_BATCH, learning_rate=TRAIN_LR,
        val_percent=TRAIN_VAL, patch_size=TRAIN_PATCH, seed=0,
        save_path=save_path, compute_dtype=torch.bfloat16,
        max_epochs=TRAIN_EPOCHS, visualize=False, metrics_file=metrics_path,
        device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"conv3x3_affine_relu": conv_fused.counter.launches,
                "dice_sums": dice_fused.counter.launches}
    bodies = dict(conv_fused.counter.bodies)
    state["train_launches"] = launches
    state["conv_bodies"]["train"] = bodies

    hist = res["history"]
    delta = max(float((p.detach().cpu() - before[k]).abs().max())
                for k, p in model.named_parameters())
    reloaded, _ = load_model(save_path, device=dev)  # strict=True
    reload_ok = isinstance(reloaded, torch.nn.Module)
    del reloaded
    os.remove(save_path)
    checks = {
        "epochs_run": len(hist) == TRAIN_EPOCHS,
        "losses_finite": all(math.isfinite(r["loss"]) for r in hist),
        "no_step_skipped": all(r["skipped_steps"] == 0 for r in hist),
        "params_changed": delta > 0.0,
        "val_dice_in_0_1": all(0.0 <= r["dice"] <= 1.0 for r in hist),
        "checkpoint_reloads_strict": reload_ok,
        "conv_launches_18_per_chunk_per_epoch":
            launches["conv3x3_affine_relu"] == 18 * n_chunks * TRAIN_EPOCHS,
        "conv_bodies_17_wgmma_1_mma_sync_per_chunk": bodies == {
            "wgmma": 17 * n_chunks * TRAIN_EPOCHS,
            "mma_sync": n_chunks * TRAIN_EPOCHS},
        "dice_launched_every_epoch":
            launches["dice_sums"] >= TRAIN_EPOCHS,
    }
    steady = hist[-1]
    step_ms = steady["train_seconds"] * 1e3 / TRAIN_STEPS
    report["train_path"] = {
        "n_images": TRAIN_IMAGES, "patch": TRAIN_PATCH, "batch": TRAIN_BATCH,
        "lr": TRAIN_LR, "val_percent": TRAIN_VAL, "steps": TRAIN_STEPS,
        "epochs": TRAIN_EPOCHS, "dtype": "bfloat16",
        "n_val_patches": n_val_patches, "n_val_chunks": n_chunks,
        "launches": launches, "conv_bodies": bodies, "history": hist,
        "max_abs_param_delta": delta,
        "wall_seconds": wall, "steady_patches_per_s":
            TRAIN_STEPS * TRAIN_BATCH / steady["train_seconds"],
        "steady_ms_per_step": step_ms,
        "steady_val_ms": steady["val_seconds"] * 1e3, "checks": checks,
    }
    print(f"[train] {TRAIN_EPOCHS} epochs x {TRAIN_STEPS} steps, batch "
          f"{TRAIN_BATCH}, patch {TRAIN_PATCH}, bf16; val {n_val_patches} "
          f"patches in {n_chunks} chunks; launches {launches}", flush=True)
    for r in hist:
        print(f"[train] epoch {r['epoch']}: loss {r['loss']:.5f}, val dice "
              f"{r['dice']:.4f}, skipped {r['skipped_steps']}, train "
              f"{r['train_seconds'] * 1e3:.1f} ms, val "
              f"{r['val_seconds'] * 1e3:.1f} ms", flush=True)
    print(f"[train] steady state (epoch {steady['epoch']}): "
          f"{report['train_path']['steady_patches_per_s']:.1f} patches/s, "
          f"{step_ms:.2f} ms per step, val pass "
          f"{steady['val_seconds'] * 1e3:.2f} ms; max |dparam| {delta:.3e}",
          flush=True)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"train-path checks failed: {bad}")
    # The val split train_arrays made (seed 0), cut once for the profile
    # and the f32 comparison.
    np.random.seed(0)
    val_idx, _ = split_indices(TRAIN_IMAGES, TRAIN_VAL)
    val = build_val_patches(
        images[val_idx], labels[val_idx, ..., None],
        build_grid_sample_map(n_val, IMG_H, IMG_W, TRAIN_PATCH // 2),
        TRAIN_PATCH, device=dev)
    state["train_model"], state["train_val"] = model, val
    profile_train(report, model, images, labels, val)


def save_reference_module(model, path):
    """``torch.save`` of a copy of ``model`` (the port's UNet) as a
    reference user's whole-module ``.pth`` holds it: an instance of a
    class ``UNetFamily.UNet.UNet``, registered in ``sys.modules`` for the
    pickling only."""
    import types

    import torch

    from jcfszxc_unet_tpu_torch.models import MODEL_REGISTRY

    cls = type("UNet", (MODEL_REGISTRY["UNet.UNet"],),
               {"__module__": "UNetFamily.UNet", "__qualname__": "UNet"})
    ref = cls()
    ref.load_state_dict(model.state_dict())
    mod = types.ModuleType("UNetFamily.UNet")
    mod.UNet = cls
    saved = {n: sys.modules.get(n) for n in ("UNetFamily", "UNetFamily.UNet")}
    sys.modules["UNetFamily"] = types.ModuleType("UNetFamily")
    sys.modules["UNetFamily.UNet"] = mod
    try:
        torch.save(ref.eval(), path)
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m


def phase_serve(report, state):
    import copy

    import numpy as np
    import torch

    from jcfszxc_unet_tpu_torch.cli.evaluate import evaluate_arrays
    from jcfszxc_unet_tpu_torch.cli.predict import predict_arrays
    from jcfszxc_unet_tpu_torch.compat.torch_export import (
        export_torch_state_dict,
    )
    from jcfszxc_unet_tpu_torch.eval.predictor import Predictor
    from jcfszxc_unet_tpu_torch.train import checkpoint as ckpt
    from jcfszxc_unet_tpu_torch.train.optim import make_optimizer
    from jcfszxc_unet_tpu_torch.train.state import TrainState
    from jcfszxc_unet_tpu_torch.train.trainer import make_batch_step_fn

    dev = torch.device("cuda")
    trained = state["train_model"]
    out_dir = os.path.join(ROOT, "build", "chip_smoke", "serve")
    os.makedirs(out_dir, exist_ok=True)
    launches_sum = {"conv3x3_affine_relu": 0, "dice_sums": 0}
    checks, out = {}, {}

    def counted(fn):
        """fn() with the kernels' launches read around it (and summed
        into the serve path's)."""
        reset_counts()
        res = fn()
        torch.cuda.synchronize()
        launches, bodies = launch_counts()
        for key in launches_sum:
            launches_sum[key] += launches[key]
        return res, launches, bodies

    def host_s(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    # 1. The background writer: the file holds the state at submit, though
    # a train step updates the parameters in place right after it.
    model = copy.deepcopy(trained).train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    g = torch.Generator(device=dev).manual_seed(4)
    imgs = torch.rand((TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH, 3), device=dev,
                      generator=g)
    labs = (torch.rand((TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH, 1),
                       device=dev, generator=g) > 0.8).float()
    step = make_batch_step_fn(n_classes=1, compute_dtype=torch.bfloat16)
    st = TrainState(model, make_optimizer(model.parameters(), 1e-3))
    snap_path = os.path.join(out_dir, "snapshot.pt")
    with ckpt.AsyncCheckpointWriter() as writer:
        writer.submit(ckpt.save_state, snap_path, "UNet.UNet", {},
                      model.state_dict())
        step(st, imgs, labs)
    saved = torch.load(snap_path, weights_only=True)["state_dict"]
    checks["writer_snapshot_bit_exact"] = sorted(saved) == sorted(before) \
        and all(torch.equal(saved[k], v.cpu()) for k, v in before.items())
    checks["writer_step_moved_parameters"] = any(
        not torch.equal(p.detach(), before[k])
        for k, p in model.named_parameters())
    del model, st, before, saved

    # The host time one best-checkpoint save blocks the loop.
    sync_ms, bg_ms, bg_done_ms = [], [], []
    for _ in range(SERVE_SAVE_REPS):
        _, dt = host_s(lambda: ckpt.save_model(snap_path, "UNet.UNet", {},
                                               trained))
        sync_ms.append(dt * 1e3)
    with ckpt.AsyncCheckpointWriter() as writer:
        for _ in range(SERVE_SAVE_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            writer.submit(ckpt.save_state, snap_path, "UNet.UNet", {},
                          trained.state_dict())
            t1 = time.perf_counter()
            writer.wait()
            bg_ms.append((t1 - t0) * 1e3)
            bg_done_ms.append((time.perf_counter() - t0) * 1e3)
    out["save_blocking_ms"] = {
        "sync": sync_ms, "background": bg_ms,
        "background_until_written": bg_done_ms,
        "bytes": os.path.getsize(snap_path)}
    print(f"[serve] one UNet save ({os.path.getsize(snap_path) / 1e6:.1f} "
          f"MB) blocks the loop: sync "
          f"{[round(v, 2) for v in sync_ms]} ms, background "
          f"{[round(v, 2) for v in bg_ms]} ms (written after "
          f"{[round(v, 2) for v in bg_done_ms]} ms); snapshot bit exact "
          f"{checks['writer_snapshot_bit_exact']}", flush=True)

    # 2. Every format on the card: the same weights, the same kernels, the
    # same maps.
    paths = {fmt: os.path.join(out_dir, name) for fmt, name in (
        ("port", "unet.pt"), ("pth_state_dict", "unet_state_dict.pth"),
        ("pth_module", "unet_module.pth"))}
    ckpt.save_model(paths["port"], "UNet.UNet", {}, trained)
    export_torch_state_dict(trained, paths["pth_state_dict"])
    save_reference_module(trained, paths["pth_module"])
    images, masks, labels = synthetic_drive(SERVE_IMAGES, IMG_H, IMG_W,
                                            seed=5)
    raws = [np.round(images[0] * 255).astype(np.uint8),
            np.round(images[1] * 65535).astype(np.uint16)]
    n_chunks = SERVE_IMAGES * math.ceil(grid_count(IMG_H, IMG_W, PATCH)
                                        / INFER_BATCH)
    want_sd = {k: v.detach() for k, v in trained.state_dict().items()}
    maps, models = {}, {}
    for fmt, path in paths.items():
        (m, cfg), load_s = host_s(lambda: ckpt.load_model_any(path, dev))
        sd = m.state_dict()
        pred = Predictor(m, compute_dtype=torch.bfloat16, patch_size=PATCH,
                         inference_batch_size=INFER_BATCH, device=dev)
        res, launches, bodies = counted(
            lambda: predict_arrays(pred, raws, "tiled", PATCH))
        _, dt = host_s(lambda: predict_arrays(pred, raws, "tiled", PATCH))
        maps[fmt] = np.stack(res)
        models[fmt] = m
        out[fmt] = {"bytes": os.path.getsize(path), "load_ms": load_s * 1e3,
                    "config": cfg, "launches": launches, "conv_bodies": bodies,
                    "images_per_s": SERVE_IMAGES / dt}
        checks[f"{fmt}_same_weights"] = cfg["model_name"] == "UNet.UNet" \
            and sorted(sd) == sorted(want_sd) \
            and all(torch.equal(sd[k], v) for k, v in want_sd.items())
        checks[f"{fmt}_conv_launches_18_per_chunk"] = \
            launches["conv3x3_affine_relu"] == 18 * n_chunks and bodies == {
                "wgmma": 17 * n_chunks, "mma_sync": n_chunks}
        print(f"[serve] {fmt}: load {load_s * 1e3:.1f} ms, tiled bf16 "
              f"{SERVE_IMAGES / dt:.2f} images/s, launches {launches}",
              flush=True)
    ref = maps["port"]
    checks["maps_shape_finite_in_0_1"] = bool(
        ref.shape == (SERVE_IMAGES, IMG_H, IMG_W) and np.isfinite(ref).all()
        and ref.min() >= 0 and ref.max() <= 1)
    out["max_abs_map_diff"] = {fmt: float(np.abs(m - ref).max())
                               for fmt, m in maps.items()}
    checks["three_formats_identical_maps"] = all(
        v == 0.0 for v in out["max_abs_map_diff"].values())
    out["prob_std"] = float(ref.std())
    for fmt in ("port", "pth_state_dict"):
        del models[fmt]
    model = models["pth_module"]

    # 3. A real JAX .ckpt, through the port's msgpack reader, in f32.
    (fm, fcfg), load_s = host_s(lambda: ckpt.load_model_any(JAX_FIXTURE, dev))
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)

    def fixture_forward():
        with torch.inference_mode():
            y = fm(torch.as_tensor(x, device=dev).permute(0, 3, 1, 2))
        return y.float().permute(0, 2, 3, 1).cpu().numpy()

    got, launches, _ = counted(fixture_forward)
    want = np.load(JAX_FIXTURE_OUT)
    diff = float(np.abs(got - want).max())
    out["jax_fixture"] = {"load_ms": load_s * 1e3, "config": fcfg,
                          "launches": launches, "max_abs_diff": diff,
                          "tolerance": FIXTURE_TOL,
                          "jax_output_std": float(want.std())}
    checks["jax_fixture_within_1e-3"] = bool(
        got.shape == want.shape and np.isfinite(diff) and diff <= FIXTURE_TOL)
    checks["jax_fixture_6_conv_launches"] = \
        launches["conv3x3_affine_relu"] == 6
    print(f"[serve] JAX .ckpt fixture: load {load_s * 1e3:.1f} ms, f32 max "
          f"|d| {diff:.2e} against the JAX output (tolerance {FIXTURE_TOL}), "
          f"launches {launches}", flush=True)
    del fm

    # 4. The eval CLI's protocol on the model read from the module .pth.
    res, launches, _ = counted(lambda: evaluate_arrays(
        model, images, masks, labels, patch_size=PATCH,
        inference_batch_size=INFER_BATCH, compute_dtype=torch.bfloat16,
        device=dev))
    out["evaluate_arrays"] = {"dice": res["dice"], "auc": res["auc"],
                              "launches": launches}
    checks["evaluate_dice_auc_finite"] = all(
        np.isfinite(v) and 0 <= v <= 1 for v in res["dice"] + res["auc"])
    checks["evaluate_one_dice_launch"] = launches["dice_sums"] == 1
    print(f"[serve] evaluate_arrays: dice "
          f"{[round(d, 4) for d in res['dice']]}, auc "
          f"{[round(a, 4) for a in res['auc']]}, launches {launches}",
          flush=True)

    # 5. The other modes, in bf16 on the two images, and in f32 on a crop
    # against a CPU copy.
    h0, w0 = IMG_H // 2 - SERVE_CROP // 2, IMG_W // 2 - SERVE_CROP // 2
    crop = raws[0][h0:h0 + SERVE_CROP, w0:w0 + SERVE_CROP]
    windows = sliding_windows(IMG_H, IMG_W, SLIDING_PATCH, SLIDING_OVERLAP)
    modes = {  # (Predictor kwargs, predict_arrays kwargs, forwards, crop's)
        "sliding": ({}, dict(mode="sliding", patch_size=SLIDING_PATCH,
                             overlap=SLIDING_OVERLAP),
                    SERVE_IMAGES * math.ceil(windows / INFER_BATCH),
                    dict(mode="sliding", patch_size=SERVE_CROP_SLIDING,
                         overlap=SLIDING_OVERLAP)),
        "spatial": ({}, dict(mode="spatial"), SERVE_IMAGES,
                    dict(mode="spatial")),
        "tiled_tta": ({"tta": True}, dict(mode="tiled", patch_size=PATCH),
                      8 * n_chunks,
                      dict(mode="tiled", patch_size=SERVE_CROP)),
    }
    for name, (pk, ak, forwards, crop_ak) in modes.items():
        pred = Predictor(model, compute_dtype=torch.bfloat16,
                         patch_size=PATCH, inference_batch_size=INFER_BATCH,
                         device=dev, **pk)
        res, launches, bodies = counted(lambda: predict_arrays(pred, raws,
                                                               **ak))
        _, dt = host_s(lambda: predict_arrays(pred, raws, **ak))
        res = np.stack(res)
        diff, std = f32_against_cpu_copy(
            model, lambda p: torch.as_tensor(np.stack(
                predict_arrays(p, [crop], **crop_ak))),
            patch_size=SERVE_CROP, inference_batch_size=INFER_BATCH, **pk)
        out[name] = {"forwards": forwards, "launches": launches,
                     "conv_bodies": bodies, "images_per_s": SERVE_IMAGES / dt,
                     "f32_max_abs_dprob": diff, "f32_prob_std": std}
        checks[f"{name}_maps_finite_in_0_1"] = bool(
            res.shape == (SERVE_IMAGES, IMG_H, IMG_W)
            and np.isfinite(res).all() and res.min() >= 0 and res.max() <= 1)
        checks[f"{name}_conv_launches_18_per_forward"] = \
            launches["conv3x3_affine_relu"] == 18 * forwards
        checks[f"{name}_f32_within_1e-3"] = bool(np.isfinite(diff)
                                                 and diff <= 1e-3)
        print(f"[serve] {name}: {forwards} forwards, launches {launches}, "
              f"{SERVE_IMAGES / dt:.2f} images/s; f32 on a {SERVE_CROP}^2 "
              f"crop vs CPU max |dprob| {diff:.2e} (std {std:.3e})",
              flush=True)

    out["launches"] = dict(launches_sum)
    out["checks"] = checks
    report["serve"] = out
    state["serve_launches"] = launches_sum
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"serve checks failed: {bad}")


def profile_train(report, model, images, labels, val):
    """Device time by kernel of one train step and of one val pass, and
    the device's idle share against each one's untraced wall time."""
    import numpy as np
    import torch

    from jcfszxc_unet_tpu_torch.data.sampler import (
        build_train_sample_map,
        sample_batch,
    )
    from jcfszxc_unet_tpu_torch.train.optim import make_optimizer
    from jcfszxc_unet_tpu_torch.train.state import TrainState
    from jcfszxc_unet_tpu_torch.train.trainer import (
        make_batch_step_fn,
        make_val_fn,
    )

    dev = torch.device("cuda")
    pool = torch.as_tensor(images, device=dev)
    labs = torch.as_tensor(labels[..., None], device=dev)
    smap = torch.as_tensor(build_train_sample_map(
        np.ones(labels.shape, np.float32), TRAIN_PATCH // 2),
        device=dev).long()
    g = torch.Generator(device=dev).manual_seed(3)
    imgs, labs_b = sample_batch(g, pool, labs, smap, TRAIN_BATCH, TRAIN_PATCH)
    st = TrainState(model, make_optimizer(model.parameters(), TRAIN_LR))
    step = make_batch_step_fn(n_classes=1, compute_dtype=torch.bfloat16)
    val_fn = make_val_fn(model, compute_dtype=torch.bfloat16)
    out = {}
    for name, fn, reps in (
            ("train_step", lambda: step(st, imgs, labs_b), 5),
            ("val_pass", lambda: val_fn(*val), 3)):
        wall = host_ms(fn, reps)
        rows = device_rows(fn, reps=reps)
        busy = sum(r["device_ms"] for r in rows)
        out[name] = {"untraced_wall_ms": wall, "device_ms_total": busy,
                     "device_idle_share": max(0.0, 1.0 - busy / wall),
                     "top": rows[:25]}
        print(f"[profile] {name}: device busy {busy:.2f} ms of {wall:.2f} ms "
              f"wall (idle share {out[name]['device_idle_share']:.3f}); top:",
              flush=True)
        for r in rows[:6]:
            print(f"    {r['device_ms']:9.3f} ms  x{r['count']:<5g} "
                  f"{r['name']}", flush=True)
    report["train_profile"] = out


def phase_train_val_f32(report, state):
    import numpy as np
    import torch

    from jcfszxc_unet_tpu_torch.ops.kernels.dice_fused import (
        dice_from_sums,
        dice_sums_torch,
    )
    from jcfszxc_unet_tpu_torch.train.trainer import make_val_fn

    model = state["train_model"]
    val_imgs, val_labs = state["train_val"]
    metrics, probs = make_val_fn(model, compute_dtype=torch.float32)(
        val_imgs, val_labs)
    model.eval()
    with torch.no_grad():
        want = torch.cat([
            torch.sigmoid(plain_unet_forward(
                model, chunk.permute(0, 3, 1, 2)).float()).permute(0, 2, 3, 1)
            for chunk in val_imgs.split(VAL_CHUNK)])
    model.train()
    p, t = want[..., 0], val_labs[..., 0]

    def plain_dice(pred, target):
        return float(dice_from_sums(*dice_sums_torch(pred, target)).mean())

    plain = {"dice": plain_dice((p > 0.5).float(), t),
             "dice_fg": plain_dice((p <= 0.5).float(), 1.0 - t)}
    dprob = float((probs - want).abs().max())
    ddice = {k: abs(float(metrics[k]) - v) for k, v in plain.items()}
    report["train_val_f32"] = {
        "n_patches": int(val_imgs.shape[0]), "max_abs_dprob": dprob,
        "prob_tolerance": 1e-3, "dice_abs_diff": ddice,
        "dice_tolerance": 1e-3, "kernel_path": {
            k: float(metrics[k]) for k in ("dice", "dice_fg", "dice_avg")},
        "plain_path": plain, "prob_std": float(want.std())}
    print(f"[train-f32] val through the kernels vs plain forward on "
          f"{val_imgs.shape[0]} patches: max |dprob| {dprob:.3e} (tolerance "
          f"1e-3), |ddice| {ddice['dice']:.3e}, |ddice_fg| "
          f"{ddice['dice_fg']:.3e} (tolerance 1e-3)", flush=True)
    if not (np.isfinite(dprob) and dprob <= 1e-3
            and all(v <= 1e-3 for v in ddice.values())):
        raise AssertionError(
            f"train val f32: max |dprob| {dprob}, |ddice| {ddice}")


def phase_probe(report, state):
    import torch
    import torch.nn.functional as F

    from jcfszxc_unet_tpu_torch.ops.kernels import conv_imcol
    from jcfszxc_unet_tpu_torch.ops.kernels.conv_imcol import (
        conv3x3_relu_imcol,
        conv3x3_relu_imcol_torch,
    )
    from jcfszxc_unet_tpu_torch.scripts.imcol_conv_probe import (
        event_ms,
        probe_inputs,
        run_probe,
    )

    torch.cuda.synchronize()
    conv_imcol.counter.reset()
    res = run_probe(**PROBE, n_long=20)
    torch.cuda.synchronize()
    launches = conv_imcol.counter.launches
    bodies = dict(conv_imcol.counter.bodies)

    # Correctness: the probe geometry in bf16 and (at B 8) f32, and a
    # ragged shape in both.  Both sides accumulate in f32 and differ in
    # summation order and (bf16) one output rounding.
    tol = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    g = dict(PROBE)
    cases = [(g["b"], torch.bfloat16), (8, torch.float32)]
    shapes = [(b, g["h"], g["w"], g["cin"], g["cout"], dt) for b, dt in cases]
    shapes += [(2, 37, 29, 64, 64, dt) for dt in tol]
    checks = []
    for b, h, w, cin, cout, dt in shapes:
        x, wt = probe_inputs(b, h, w, cin, cout, dtype=dt, seed=b + h)
        got = conv3x3_relu_imcol(x, wt).float()
        want = conv3x3_relu_imcol_torch(x, wt).float()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ref = float(want.abs().max())
        checks.append({"shape": [b, h, w, cin, cout],
                       "dtype": str(dt).split(".")[-1], "max_abs_err": err,
                       "max_abs_plain": ref, "ok": err <= tol[dt] * ref})
        del got, want, x, wt
    checks.append({"shape": res["shape"], "dtype": res["dtype"],
                   "max_abs_err": res["parity_max_abs"],
                   "max_abs_plain": res["max_abs_plain"],
                   "ok": res["parity_max_abs"] <= 1e-2 * res["max_abs_plain"]})

    # Times at the probe geometry, bf16.  The bound counts x, w and out
    # once (the padded copy is the wrapper's own traffic); the kernel
    # alone is bound by its padded x, wt and out and the same operations.
    x, wt = probe_inputs(**PROBE)
    b, h, w, cin, cout = (PROBE[k] for k in ("b", "h", "w", "cin", "cout"))
    flops = 2 * b * h * w * cout * 9 * cin
    nbytes = (x.numel() + wt.numel() + b * h * w * cout) * 2
    c8 = -(-cin // 8) * 8
    kernel_bytes = (b * (h + 2) * (w + 2) * c8 + 9 * c8 * cout
                    + b * h * w * cout) * 2
    x_cl = x.permute(0, 3, 1, 2)
    w_oihw = wt.permute(3, 2, 0, 1).contiguous()
    times = {
        "ms": res["imcol"]["ms"], "kernel_ms": res["kernel"]["ms"],
        "pad_ms": res["pad"]["ms"], "cudnn_relu_ms": res["cudnn"]["ms"],
        "nine_tap_ms": res["9tap"]["ms"],
        "plain_ms": event_ms(lambda: conv3x3_relu_imcol_torch(x, wt), 5),
        "library_ms": event_ms(lambda: F.conv2d(x_cl, w_oihw, padding=1), 20),
        "bound_ms": bound_ms(flops, nbytes, BF16_FLOPS),
        "bound_by": ("operations" if flops / BF16_FLOPS
                     > nbytes / HBM_BYTES_PER_S else "bytes"),
        "kernel_bound_ms": bound_ms(flops, kernel_bytes, BF16_FLOPS),
        "flops": flops, "bytes": nbytes, "kernel_bytes": kernel_bytes,
    }
    report["probe"] = {"launches": launches, "bodies": bodies, "run": res,
                       "checks": checks, "times": times}
    n_ok = sum(c["ok"] for c in checks)
    print(f"[probe] imcol kernel vs plain: {n_ok}/{len(checks)} cases within "
          f"1e-2 (bf16) / 1e-4 (f32) of max|plain|; launches on the probe "
          f"path {launches} ({bodies})", flush=True)
    print(f"[probe] B{b} {h}x{w} {cin}->{cout} bf16: wrapper "
          f"{times['ms']:.3f} ms (pad {times['pad_ms']:.3f} + kernel "
          f"{times['kernel_ms']:.3f}, {flops / times['kernel_ms'] / 1e9:.1f} "
          f"TFLOP/s), 9-tap kernel {times['nine_tap_ms']:.3f} ms, cuDNN conv "
          f"{times['library_ms']:.3f} ms (+ReLU {times['cudnn_relu_ms']:.3f}),"
          f" plain {times['plain_ms']:.3f} ms, bound {times['bound_ms']:.3f} "
          f"ms ({times['bound_by']}; kernel alone "
          f"{times['kernel_bound_ms']:.3f} ms)", flush=True)
    if n_ok != len(checks) or launches < 1 or bodies != {"wgmma": launches}:
        raise AssertionError(f"probe checks failed: {checks}, launches "
                             f"{launches} ({bodies})")
    state["kernels_probe"] = {
        "name": "conv3x3_relu_imcol", "route": "cuda",
        "source": "jcfszxc_unet_tpu_torch/csrc/conv3x3_relu_imcol.cu",
        "replaces": "scripts/tpu_imcol_conv_probe.py:52",
        "launches": launches, "launches_by_body": {"probe": bodies},
        "max_abs_err": max(c["max_abs_err"] for c in checks
                           if c["dtype"] == "bfloat16"),
        "ms": times["ms"], "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
        "library_ms": times["library_ms"]}


def kernels_line(state):
    """The kernels of every path, each with its launches summed over the
    paths that ran it (and split by path)."""
    rows = [dict(k) for k in state["kernels"]]
    for row in rows:
        by_path = {"eval": row["launches"],
                   "train": state["train_launches"][row["name"]],
                   "zoo": state["zoo_launches"][row["name"]],
                   "protocols": state["protocol_launches"][row["name"]],
                   "serve": state["serve_launches"][row["name"]]}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        if row["name"] == "conv3x3_affine_relu":
            row["launches_by_body"] = state["conv_bodies"]
            row["launches_by_model"] = state["zoo_conv_launches"]
    probe = dict(state["kernels_probe"])
    probe["launches_by_path"] = {"probe": probe["launches"]}
    return rows + [probe]


def main() -> None:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    try:
        import jcfszxc_unet_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port's package is not importable from {ROOT}: {e}")
    os.makedirs(OUT_DIR, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "tf32": False}
    state = {}
    t_start = time.perf_counter()
    failed = []
    needs = {"train_val_f32": "train_path", "serve": "train_path"}
    for name, phase in (("build", phase_build),
                        ("main_path", phase_main_path),
                        ("f32_end_to_end", phase_f32_end_to_end),
                        ("kernels", phase_kernels),
                        ("zoo_eval", phase_zoo_eval),
                        ("eval_protocols", phase_eval_protocols),
                        ("train_path", phase_train_path),
                        ("serve", phase_serve),
                        ("train_val_f32", phase_train_val_f32),
                        ("probe", phase_probe)):
        if needs.get(name) in failed:
            failed.append(name)
            continue
        t_phase = time.perf_counter()
        try:
            if name == "build":
                phase(report)
            else:
                phase(report, state)
        except Exception:  # report every phase, then fail as a whole
            traceback.print_exc()
            failed.append(name)
            if name in ("build", "main_path"):
                break
        finally:
            report.setdefault("phase_seconds", {})[name] = (
                time.perf_counter() - t_phase)
    report["failed_phases"] = failed
    report["seconds"] = time.perf_counter() - t_start
    try:
        report["gpu"] = gpu_name_and_power()
    except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
        failed.append("nvidia-smi")
        print(f"nvidia-smi: {e}", file=sys.stderr)
    with open(os.path.join(OUT_DIR, "report.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    if failed:
        fail(f"phases failed: {failed}")
    print(json.dumps({"kernels": kernels_line(state)}))
    print(report["gpu"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
