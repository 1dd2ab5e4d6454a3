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
   of its wgmma plan, in bf16, one of them a deep layer at batch 2 on a
   cluster whose last group holds a tile past the batch, and at the zoo's
   and whole-image shapes in both types), and its time beside the plain
   version's, a library call's
   and its bound, per layer and per body for the conv kernel; the conv
   kernel's mma_sync body (bf16, Cin % 8 != 0) on its own lists (the
   stems, MultiResUNet's 25 odd-width convs plain and s2d at 16 x 512^2),
   beside cuDNN and the route of padding Cin to 8 with a copy and running
   the wgmma body; the narrow body (bf16, Cin % 8 == 0, the widths of
   conv_plan.NARROW_SHAPES) on the zoo's narrow list (eight models' 55 calls at 16 x
   512^2 down to 64^2), each shape checked against the plain version, run
   twice (bit-identical) and timed beside cuDNN; the wgmma body's times
   split by schedule (ping-pong,
   with the operands swapped or not, and cooperative, each with its
   cluster; ``[conv] by body`` lines); every f32 call on the f32_box body,
   and two calls on the same inputs bit-identical in f32 and in bf16
   (every body and schedule, UNet's deep layers among them);
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
   against a CPU copy.  Launches are read around each;
11. fractal (after train_val_f32): ``train.fractal.fractal_train_arrays``
   (what ``cli.train_demo`` runs) trains full-width UNet (seeded,
   calibrated BatchNorm) with the fractal extractor on the train path's 8
   images at the train-demo defaults (batch 32 over levels [8, 16, 8] of
   128, 84 and 56 pixel windows resized to 128, bf16, lr 1e-6), FOV masks
   as targets, 25 % validation on 2 whole 584 x 565 images, 2 epochs of 10
   steps; the launches are read around it (19 conv launches and one Dice
   launch per validation pass).  Then the same run with synchronous
   checkpoints, whose epoch 2 gives the step time with no write in flight;
   in both, the time from the end of epoch 1's steps to the end of epoch
   2's (validation and epoch 1's save included); ``box_dimension`` on the card against the CPU; the
   validation's conv list through kernel 1 against the plain version and
   cuDNN, and kernel 2 at its shape; the f32 validation through the
   kernels against the plain versions (probabilities and Dice within
   1e-3, the probabilities' std over 1e-2); one step and one validation
   pass profiled; the peak memory; and whether this machine has the host
   readers (PIL, h5py, joblib);
12. s2d (after fractal): NestedUNet, MultiResUNet and FRUNet, built and
   calibrated as in zoo_eval and switched to space-to-depth execution
   (``models.with_kwargs``), evaluate the eval path's 4 images in bf16
   with their launches checked per body (the plain mode's counts), images/s,
   idle share and peak memory (one profiled evaluation each), kernel 1 on
   each model's s2d conv list, cuDNN and the bound (every shape checked
   against the plain version), each beside zoo_eval's plain run of the
   same model, and f32 checks of the s2d forward against the plain
   forward of the same weights and against a CPU copy; then
   ``train_arrays`` for 2 epochs of 3 steps of FRUNet with ``s2d`` and of
   UNet with ``remat``; ms per train step and peak memory of FRUNet and
   MultiResUNet plain and s2d and of UNet without and with remat (batch
   32, 128^2, bf16); one f32 UNet step with remat against one without
   (deterministic cuDNN, within 1e-5, each BN counted once); and
   ``--resume`` from the JAX ``--latest-path`` fixture in
   ``tests/torch_port_data``: the restored RMSprop state equal to the
   file's, two steps on the card, and ``train_arrays(resume_from=...)``;
13. export (after s2d): ``eval.export.export_checkpoint`` at its defaults
   (batch 32, patch 512, bf16) on a port checkpoint of the seeded,
   calibrated full-width UNet, with the export's seconds and the
   artifact's bytes; the artifact loaded by ``load_exported`` in a fresh
   process (``python3 chip_smoke.py --export-child DIR``) that imports
   only torch and the port, run on 32 patches of 512^2 (8 synthetic
   DRIVE-geometry images) with 18 kernel-1 launches per call, its
   probabilities within 1e-3 of the eager ``Predictor``'s and its
   images/s beside the eager forward's (timed in that process, in
   turns); in f32 with TF32 off on 2 patches of 128^2, the program within
   1e-5 of the eager forward and within 1e-3 of the forward built from
   the plain versions; SegNet, TransFuseNet and FRUNet and NestedUNet in
   s2d mode exported at batch 2 of 128^2 in f32, each within 1e-5 of its
   eager forward with its launch count, and each s2d model's eager
   forward after its export equal to the one before it (the selector's
   cache stays real); and the host microseconds per conv call of UNet's
   18 through the ``jcfszxc_unet`` operator and through the direct
   launch (``scripts/op_dispatch_cost.py``);
14. multi_device (after probe): 2 ranks of the port's data-parallel
   path, spawned by ``parallel.spawn``, on ``cuda:0`` over gloo, passed by
   name and printed (NCCL refuses two ranks on one card; with two cards
   visible, NCCL and one card a rank), against the port in this process:
   full-width UNet (seed 2) for 3 f32 steps (TF32 off) at global batch
   32, 128^2, on seeded batches of the train path's images (losses within
   1e-4 relative, step-1 BN running statistics within rtol 1e-4 / atol
   1e-6, parameters within rtol 1e-3 / atol 5e-5, the ranks' parameters
   bit-identical); the main path's UNet and images through the tiled
   protocol with the patch grid split over the ranks, f32 (within 1e-5)
   and bf16 (per-image Dice within 1e-3); ``train_arrays`` in bf16 for 2
   epochs of 5 steps with validation (rank 0 alone writes the checkpoint,
   which loads strict; the last validation pass's gathered probabilities
   bit-identical on every rank and within MULTI_VAL_DPROB of the port's
   validation in one process with the trained weights; the val Dice equal
   on every rank).  The kernels' launches are read in the ranks.  The
   step times it prints are a path check, not a speed;
15. spatial_sharded (after multi_device): the whole-image forward with
   each padded image's rows sharded over 2 ranks (``parallel/spatial.py``,
   a halo exchange around every spatially coupled op), spawned as in
   multi_device: the full-width UNet on the main path's first 2 images
   (584 x 565, padded to 640 x 576, 320 rows a rank) through
   ``evaluate_arrays(spatial=True, world=...)`` in f32 (max |dprob|
   within 1e-5 of this process's ``predict_spatial`` of the same images,
   padded the same way) and bf16 (per-image Dice within 1e-3), and
   TransFuseNet (the attention over every rank's tokens, the transposed
   convs) in f32 within 1e-5; kernel 1 held against its plain version at
   the slab shapes of this path (322 rows at full resolution: 320 and a
   halo row on each side) through ``conv_list``; launches read in each
   rank (18 conv launches a rank a forward, the Dice on rank 0 alone);
   ms per image with 1 rank (this process) and 2 ranks, the collectives
   per forward and their host ms, and the peak allocated memory per rank
   against one process;
16. orbax (after serve): the JAX package's ``save_orbax`` of the JAX
   fixture's weights (``tests/torch_port_data/transfusenet_jax_orbax``:
   OCDBT with zstd) read by ``train.checkpoint.restore_orbax`` through the
   port's own OCDBT, zarr and zstd readers (the host C library built here
   with ``cc``), into TransFuseNet by ``compat.from_jax`` (``strict``), its
   f32 forward within 1e-5 of the JAX output with 6 kernel-1 launches; the
   zstd decoder's MB/s on the fixture's frames (a call a frame, and one
   call over them concatenated); the train path's UNet
   (f32 state dict, a bf16 copy, a None leaf, the step) written by
   ``save_orbax`` and restored in a fresh process (``python3 chip_smoke.py
   --orbax-child DIR``, torch and the port only) into
   ``cli.evaluate.evaluate_arrays`` of the main path's 4 images in bf16: 18
   kernel-1 launches and one ``dice_sums`` there, the Dice equal to this
   process's and max |dprob| 0; the save's seconds and bytes and the
   restore's seconds.

Prints the kernels line, the GPU's name and power limit, and as the last
line ``{"ok": true, "device": {...}}``; exits non-zero, printing no result,
when a phase fails or no GPU is available.  Details go to
``chiprun_out/chip_smoke/report.json``.

``python3 chip_smoke.py --pool-gaps N`` runs only zoo_eval's f32 check of
SegNet against a CPU copy, for N weight seeds from the zoo's, and prints
each flipped pooling window's gap over its map's largest |value| (the
measure that ``check_pool_windows`` bounds by POOL_TIE_REL) as one JSON
line, without failing on them.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
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

# Fractal path: the train-demo CLI's defaults (batch 32, patch 128, bf16,
# lr 1e-6) on the train path's geometry, 25 % validation (2 whole images),
# 2 epochs cut from 100 steps to 10.
FRACTAL_EPOCHS, FRACTAL_STEPS = 2, 10
FRACTAL_TOL = 1e-3  # f32 validation through the kernels vs plain versions
FRACTAL_STD_FLOOR = 1e-2  # as zoo_eval's: the f32 check must be able to fail

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
# A deep layer (64^2's 512 -> 512 with one row more) at batch 2 on the
# wgmma body's clustered plan (pairs of CTAs along the pixel tiles): its
# pixel-tile count is odd, so in the last tile group the second CTA of the
# pair holds a tile past the batch and loads, for its peer, its half of
# the shared weights.
CLUSTER_EDGE_CASE = (2, 65, 64, 512, 512, True)

# The fifteen zoo models of the zoo_eval phase: registry name -> launches
# of the conv kernel per eval forward, by body (bf16 convs with Cin % 8 !=
# 0 on mma_sync: Cin = 3, and MultiResUNet's truncated widths; the narrow
# ones, conv_plan.NARROW_SHAPES, on narrow: the 55 calls of
# conv_body_lists.NARROW_MODELS).
ZOO = {
    "ResUNet.ResUNet": {"mma_sync": 2, "wgmma": 13},
    "SegNet.SegNet": {"mma_sync": 1, "wgmma": 24, "narrow": 1},
    "UNetPP.NestedUNet": {"mma_sync": 1, "wgmma": 19, "narrow": 10},
    "AttentionUNet.AttentionUNet": {"mma_sync": 1, "wgmma": 21},
    "R2UNet.R2UNet": {"wgmma": 58},
    "R2AttentionUNet.R2AttentionUNet": {"wgmma": 58},
    "BCDUNet.BCDU_net_D3": {"mma_sync": 1, "wgmma": 21, "narrow": 3},
    "BCDUNet.BCDU_net_D1": {"mma_sync": 1, "wgmma": 17, "narrow": 3},
    "MultiResUNet.MultiResUNet": {"mma_sync": 25, "wgmma": 5, "narrow": 7},
    "DenseUNet.DenseUNet": {"wgmma": 40},
    "FRUNet.FRUNet": {"mma_sync": 1, "wgmma": 24, "narrow": 19},
    "BARUNet.BARUNet": {"mma_sync": 1, "wgmma": 21},
    "BIARUNet.BIARUNet": {"mma_sync": 1, "wgmma": 21},
    "MCUNet.MCUNet": {"mma_sync": 1, "wgmma": 11, "narrow": 7},
    "RetinaLiteNet.TransFuseNet": {"mma_sync": 1, "narrow": 5},
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
# Models whose output head, a biased 1x1 conv before the reference's own
# sigmoid (which the evaluation's sigmoid squashes again into (0.5,
# 0.73)), leaves the f32 probabilities' std at ~2e-2, within 2.2x of
# zoo_eval's 1e-2 floor: ``build_model`` calibrates the head's output to
# mean 0 and std ZOO_HEAD_STD per channel on its calibration batch.
ZOO_HEADS = {"UNetPP.NestedUNet": "final", "ResUNet.ResUNet": "output_layer.0"}
ZOO_HEAD_STD = 4.0
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

# The s2d phase: the three models with a space-to-depth mode -> launches
# of the conv kernel per eval forward by body (the plain mode's launches:
# an s2d 3x3 is a 3x3 on 4x the channels, FRUNet's FeatureFuse one launch
# either way; none of the s2d widths takes the narrow body, so its plain
# mode's narrow launches run on wgmma there); train_arrays steps per epoch of its s2d and remat runs; the JAX
# --latest-path fixture it resumes from
# (tests/test_torch_port_remat_resume.write_jax_latest_fixture).
S2D_MODELS = {
    "UNetPP.NestedUNet": {"mma_sync": 1, "wgmma": 29},
    "MultiResUNet.MultiResUNet": {"mma_sync": 25, "wgmma": 12},
    "FRUNet.FRUNet": {"mma_sync": 1, "wgmma": 43},
}
# Since the counts equal the plain mode's, the conv shapes show that a
# model ran in s2d space: per model, (H, W, Cin, Cout) of convs that only
# s2d mode makes on a PATCH^2 input (the first conv on the packed
# 3-channel input; FRUNet's and NestedUNet's 32-wide row as 128 -> 128).
S2D_ONLY_SHAPES = {
    "UNetPP.NestedUNet": [(PATCH // 2, PATCH // 2, 12, 128),
                          (PATCH // 2, PATCH // 2, 128, 128)],
    "MultiResUNet.MultiResUNet": [(PATCH // 2, PATCH // 2, 12, 32)],
    "FRUNet.FRUNet": [(PATCH // 2, PATCH // 2, 12, 128),
                      (PATCH // 2, PATCH // 2, 128, 128)],
}
S2D_TRAIN_STEPS = 3

# MultiResUNet's bf16 convs with Cin % 8 != 0 (the mma_sync body's) at an
# eval chunk, plain and s2d, as the kernels phase times them
# (jcfszxc_unet_tpu_torch/scripts/conv_body_lists.py); zoo_eval and s2d
# hold the model's recorded lists to them.
MULTIRES = "MultiResUNet.MultiResUNet"

# The multi_device phase: ranks, the process group's timeout, the bound on
# the whole job, the f32 steps and the bf16 train_arrays run (epochs x
# steps, the train path's geometry), the seed of the f32 batches' centers,
# and the bound on the bf16 run's validation probabilities against one
# process on the same chunk shapes (expected equal; well below the spread
# of the probabilities, so a rank's missing or misplaced share shows).
MULTI_RANKS, MULTI_TIMEOUT_S, MULTI_JOIN_S = 2, 60.0, 240.0
MULTI_F32_STEPS, MULTI_EPOCHS, MULTI_STEPS, MULTI_SEED = 3, 2, 5, 5
MULTI_VAL_DPROB = 1e-4

# The spatial_sharded phase: the main path's first SPATIAL_IMAGES images
# (584 x 565, padded to 640 x 576 for MULTI_RANKS ranks: 320 rows a rank)
# through the whole-image forward with the rows sharded over MULTI_RANKS
# ranks, each evaluation run SPATIAL_REPEATS times (the last one timed),
# and TransFuseNet (logit head, calibrated as in zoo_eval) in f32; held
# against this process within the multi_device phase's tolerances.
SPATIAL_IMAGES, SPATIAL_REPEATS = 2, 2
SPATIAL_TFN = "RetinaLiteNet.TransFuseNet"
SPATIAL_F32_DPROB, SPATIAL_BF16_DDICE = 1e-5, 1e-3

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
JAX_LATEST = os.path.join(ROOT, "tests", "torch_port_data",
                          "transfusenet_jax_latest.ckpt")

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
    folded into the conv's weight and bias.  In the models of ``ZOO_HEADS``
    the output head is calibrated the same way to a std of
    ``ZOO_HEAD_STD``."""
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

    def head_output(conv, inputs, y):
        y = unit_output(conv, inputs, y)
        conv.weight.mul_(ZOO_HEAD_STD)
        conv.bias.mul_(ZOO_HEAD_STD)
        return y * ZOO_HEAD_STD

    g = torch.Generator().manual_seed(seed)
    model = create_model(name, **({"logit_head": True}
                                  if model_takes(name, "logit_head") else {}))
    reset_parameters(model, g)
    hooks = [m.register_forward_hook(unit_output) for m in model.modules()
             if name in ZOO_BN_FREE
             and isinstance(m, (nn.Conv2d, nn.ConvTranspose2d))
             and m.bias is not None]
    if name in ZOO_HEADS:
        hooks.append(model.get_submodule(ZOO_HEADS[name])
                     .register_forward_hook(head_output))
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

    from jcfszxc_unet_tpu_torch.ops.kernels import conv_fused, conv_plan
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
        plan = conv_fused.plan_for(x, w_km)
        body = plan.body
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
            "body": body, "schedule": conv_plan.schedule(plan),
            "tile": [plan.bm, plan.bn], "ms": ms, "tflops": flops / ms / 1e9,
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
    schedules = dict(conv_fused.counter.schedules)
    state["launches"] = launches
    state["conv_bodies"] = {"eval": bodies}
    state["conv_schedules"] = {"eval": schedules}
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
        "launches": launches, "conv_bodies": bodies,
        "conv_schedules": schedules, "dice": res["dice"], "auc": res["auc"],
        "prob_mean": float(pm.mean()), "prob_std": float(pm.std()),
        "eval_seconds": dt, "images_per_s": N_IMAGES / dt, "checks": checks,
    }
    print(f"[main] {n_patches} patches in {n_chunks} chunk(s); launches "
          f"{launches}, conv bodies {bodies} ({schedules}); dice "
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
    reset_counts()
    got = pred.predict_patches(patches)[..., 0]
    _, bodies = launch_counts()
    with torch.inference_mode():
        logits = plain_unet_forward(model, patches.permute(0, 3, 1, 2))
        want = torch.sigmoid(logits.float())[:, 0]
    diff = float((got - want).abs().max())
    report["f32_end_to_end"] = {"n_patches": int(patches.shape[0]),
                                "max_abs_dprob": diff, "tolerance": 1e-3,
                                "prob_std": float(want.std()),
                                "conv_bodies": bodies}
    print(f"[f32] port vs plain forward on {patches.shape[0]} patches: "
          f"max |dprob| = {diff:.3e} (tolerance 1e-3); conv bodies "
          f"{bodies}", flush=True)
    if not np.isfinite(diff) or diff > 1e-3:
        raise AssertionError(f"f32 end-to-end max |dprob| {diff} > 1e-3")
    # one forward of one chunk: UNet's 18 convs, every one on f32_box
    if bodies != {"f32_box": 18}:
        raise AssertionError(f"f32 forward's conv bodies {bodies}, "
                             f"expected {{'f32_box': 18}}")


def phase_kernels(report, state):
    from collections import Counter

    import torch

    from jcfszxc_unet_tpu_torch.ops.kernels import conv_fused, conv_plan
    from jcfszxc_unet_tpu_torch.ops.kernels.conv_fused import (
        conv3x3_affine_relu,
        conv3x3_affine_relu_torch,
    )
    from jcfszxc_unet_tpu_torch.ops.kernels.dice_fused import (
        dice_sums,
        dice_sums_torch,
    )
    from jcfszxc_unet_tpu_torch.scripts import conv_body_lists

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
    cases += [("cluster_edge", *CLUSTER_EDGE_CASE, bf16)]
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
        print(f"[conv] per layer, {name}: size Cin->Cout body/schedule "
              f"BMxBN ms TFLOP/s bound_ms cuDNN_ms plain_ms", flush=True)
        for r in rows:
            kind = "/".join(k for k in (r["body"], r["schedule"]) if k)
            print(f"    {r['hw']:4d}^2 {r['cin']:5d}->{r['cout']:<5d} "
                  f"{kind:18s} {r['tile'][0]:3d}x{r['tile'][1]:<3d} "
                  f"{r['ms']:7.3f} {r['tflops']:6.1f} "
                  f"{r['bound_ms']:7.3f} {r['library_ms']:7.3f} "
                  f"{r['plain_ms']:7.3f}", flush=True)
    with open(os.path.join(OUT_DIR, "conv_layers.json"), "w") as f:
        json.dump({"gpu": gpu_name_and_power(), **conv_times}, f, indent=1)
    total = conv_times["bfloat16"]["total"]
    report["f32_repeatable"] = repeatable(g, b, torch.float32)
    report["bf16_repeatable"] = repeatable(g, b, torch.bfloat16)
    state["conv_by_body"] = conv_by_body(conv_times, state["conv_bodies"],
                                         state["conv_schedules"])
    state["mma_sync_lists"] = mma_sync_lists(checks)
    state["narrow_list"] = narrow_list(
        checks, state["conv_bodies"]["eval"].get("narrow", 0))
    state["conv_by_body"]["narrow"] = state["narrow_list"]["by_body"]
    report["conv_by_body"] = state["conv_by_body"]
    for body, row in state["conv_by_body"].items():
        parts = [(body, row)] + [(f"{body}/{name}", sub) for name, sub
                                 in row.get("schedules", {}).items()]
        for name, r in parts:
            print(f"[conv] by body: {name} ({row['dtype']}): {r['convs']} "
                  f"of UNet's convs, kernel {r['ms']:.3f} ms, cuDNN "
                  f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms; "
                  f"{r['launches_main_path']} launches on the main path",
                  flush=True)
    report["mma_sync_lists"] = state["mma_sync_lists"]
    report["narrow_list"] = state["narrow_list"]
    for path in ("eval", "eval_chunk", "train_val", "plan_edge",
                 "cluster_edge", "zoo",
                 "whole_image", *(f"mma_sync_{name}" for name in
                                  conv_body_lists.LISTS), "narrow"):
        mine = [c for c in checks if c["path"] == path]
        err16 = max(c["max_abs_err"] / c["max_abs_plain"] for c in mine
                    if c["dtype"] == "bfloat16")
        print(f"[conv] kernel vs plain at the {path} shapes: "
              f"{sum(c['ok'] for c in mine)}/{len(mine)} shape/dtype cases "
              f"within 1e-4 (f32) / 1e-2 (bf16) of max|plain|; bf16 max "
              f"err / max|plain| {err16:.2e}", flush=True)
    failures = [c for c in checks if not c["ok"]]
    b_, h_, w_, cin_, cout_, _ = CLUSTER_EDGE_CASE
    edge = conv_plan.plan_conv(b_, h_, w_, cin_, cout_, torch.bfloat16, True,
                               conv_plan.sm_count(torch.device(dev)))
    tiles_m = edge.tiles[0] * edge.tiles[1] * edge.tiles[2]
    if edge.cluster != 2 or tiles_m % 2 == 0:
        failures.append({"cluster_edge's plan has no pixel tile past the "
                         "batch": [edge.cluster, tiles_m]})
    wrong_body = [c for c in checks if c["body"] != (
        "f32_box" if c["dtype"] == "float32"
        else "mma_sync" if c["shape"][3] % 8
        else "narrow" if conv_plan.takes_narrow(*c["shape"][3:5])
        else "wgmma")]
    if wrong_body:
        failures.append({"f32 off the f32_box body, bf16 Cin % 8 != 0 off "
                         "the mma_sync body, bf16 Cin % 8 == 0 off the "
                         "narrow body (conv_plan.NARROW_SHAPES) or the "
                         "wgmma body (the rest)": wrong_body})
    for name in ("f32", "bf16"):
        unequal = [r for r in report[f"{name}_repeatable"]
                   if not r["identical"]]
        if unequal:
            failures.append({f"{name} kernel 1 not bit-identical across two "
                             f"calls": unequal})
    narrow = state["narrow_list"]
    if narrow["bodies"] != ["narrow"] or narrow["identical"] != narrow[
            "checks"]:
        failures.append({"narrow list off the narrow body or not "
                         "bit-identical across two calls": [
                             narrow["bodies"], narrow["identical"]]})

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


# Shapes (B taken from the main path) at which two calls of kernel 1 on
# the same inputs must give identical outputs.  f32: UNet's stem, its
# widest map, its deepest conv, and MultiResUNet's first odd-width conv.
# bf16: UNet's stem (mma_sync), its Cout <= 128 convs on maps at least
# 128 wide (ping-pong, operands swapped: strips, TMA stores), its four
# Cout-256 convs at 128^2 (three shapes) and its six Cout >= 512 convs
# (five shapes: the deep layers, cooperative, on their planned clusters),
# a 64^2 one (swapped boxes), Cin 256 into Cout 128 at 64^2 (ping-pong 128
# x 128, TMA stores) and an odd Cout (ping-pong, register stores).
REPEAT_SHAPES = {
    "float32": [(512, 3, 64), (512, 64, 64), (32, 1024, 1024),
                (512, 17, 26)],
    "bfloat16": [(512, 3, 64), (512, 64, 64), (256, 64, 128),
                 (512, 128, 64), (128, 128, 256), (128, 256, 256),
                 (128, 512, 256), (64, 256, 512), (64, 512, 512),
                 (64, 1024, 512), (32, 512, 1024), (32, 1024, 1024),
                 (64, 128, 128), (64, 256, 128), (128, 64, 17)],
}


def repeatable(g, b, dtype):
    """Kernel 1 (one accumulation order per output, no atomics, on every
    body and schedule) twice on the same inputs of ``dtype`` at
    REPEAT_SHAPES, batch ``b``: whether the two outputs are
    bit-identical."""
    import torch

    from jcfszxc_unet_tpu_torch.ops.kernels.conv_fused import (
        conv3x3_affine_relu,
    )

    name = str(dtype).split(".")[-1]
    rows = []
    for hw, cin, cout in REPEAT_SHAPES[name]:
        x, w, scale, shift = conv_inputs(g, b, hw, hw, cin, cout, dtype)
        first = conv3x3_affine_relu(x, w, scale, shift)
        second = conv3x3_affine_relu(x, w, scale, shift)
        torch.cuda.synchronize()
        rows.append({"shape": [b, hw, hw, cin, cout],
                     "identical": bool(torch.equal(first, second)),
                     "max_abs_diff": float((first.float()
                                            - second.float()).abs().max())})
        del x, w, first, second
    print(f"[conv] {name} kernel 1 twice on the same inputs: "
          f"{sum(r['identical'] for r in rows)}/{len(rows)} shapes "
          f"bit-identical", flush=True)
    return rows


def conv_by_body(conv_times, bodies, schedules):
    """Kernel 1 on UNet's eval-chunk lists split by body (bf16: ``wgmma``
    and ``mma_sync``; f32: ``f32_box``) and, for ``wgmma``, by schedule
    (``pingpong``, ``cooperative``): convs, ms, bound, plain and cuDNN ms
    per 16-patch forward (cuDNN with TF32 off), and the launches on the
    main path."""
    keys = ("ms", "bound_ms", "library_ms", "plain_ms")
    out = {}
    for dtype, t in conv_times.items():
        for r in t["rows"]:
            row = out.setdefault(r["body"], {
                "dtype": dtype, "convs": 0, **{k: 0.0 for k in keys},
                "launches_main_path": bodies["eval"].get(r["body"], 0)})
            row["convs"] += 1
            for key in keys:
                row[key] += r[key]
            if r["schedule"] is None:
                continue
            name = f"{r['body']}/{r['schedule']}"
            sub = row.setdefault("schedules", {}).setdefault(
                r["schedule"], {
                    "convs": 0, **{k: 0.0 for k in keys},
                    "launches_main_path": schedules["eval"].get(name, 0)})
            sub["convs"] += 1
            for key in keys:
                sub[key] += r[key]
    return out


def mma_sync_lists(checks):
    """Kernel 1's ``mma_sync`` body on its own lists
    (``scripts/conv_body_lists.LISTS``: the stems, MultiResUNet's 25
    odd-width convs plain and s2d at 16 x 512^2) through ``conv_list``,
    each shape also checked against the plain version (appended to
    ``checks``); beside each, the route of padding Cin to a multiple of 8
    with a copy of x and running the ``wgmma`` body on the copies (copy ms,
    kernel ms on the copies, checked too).  Returns totals per list."""
    import torch

    from jcfszxc_unet_tpu_torch.ops.kernels.conv_fused import (
        conv3x3_affine_relu_torch,
    )
    from jcfszxc_unet_tpu_torch.scripts import conv_body_lists as cbl

    out = {}
    for name, calls in cbl.LISTS.items():
        res = conv_list(calls, torch.bfloat16, f"mma_sync_{name}", seed=3)
        checks += res["checks"]
        g = torch.Generator(device="cuda").manual_seed(4)
        pad = {"pad_ms": 0.0, "pad8_wgmma_ms": 0.0, "bodies": set()}
        for (b, h, wd, cin, cout, relu), n in calls.items():
            x, w, scale, shift = conv_inputs(g, b, h, wd, cin, cout,
                                             torch.bfloat16)
            row, got = cbl.pad8_route(x, w.permute(3, 0, 1, 2).contiguous(),
                                      scale, shift, relu)
            checks.append(conv_check(
                f"pad8_{name}", [b, h, wd, cin + (-cin % 8), cout], relu,
                torch.bfloat16, row["pad8_body"], got,
                conv3x3_affine_relu_torch(x, w, scale, shift, relu).float()))
            pad["pad_ms"] += n * row["pad_ms"]
            pad["pad8_wgmma_ms"] += n * row["pad8_wgmma_ms"]
            pad["bodies"].add(row["pad8_body"])
            del x, w, got
        t = res["total"]
        out[name] = {**t, "pad_ms": pad["pad_ms"],
                     "pad8_wgmma_ms": pad["pad8_wgmma_ms"],
                     "pad8_bodies": sorted(pad["bodies"]),
                     "rows": res["rows"]}
        print(f"[conv] mma_sync list {name} ({t['n_convs']} convs): kernel "
              f"{t['ms']:.3f} ms ({t['flops'] / t['ms'] / 1e9:.1f} TFLOP/s), "
              f"plain {t['plain_ms']:.3f} ms, cuDNN {t['library_ms']:.3f} ms, "
              f"bound {t['bound_ms']:.3f} ms ({t['bound_by']}); pad Cin to 8 "
              f"with a copy {pad['pad_ms']:.3f} ms + kernel 1 on the copies "
              f"({sorted(pad['bodies'])}) {pad['pad8_wgmma_ms']:.3f} ms = "
              f"{pad['pad_ms'] + pad['pad8_wgmma_ms']:.3f} ms; kernel vs "
              f"plain {t['checks_ok']}/{t['checks']} shapes", flush=True)
    return out


def narrow_list(checks, launches_main_path):
    """Kernel 1 on the zoo's narrow list (``scripts/conv_body_lists.NARROW``:
    eight models' 55 calls at 16 x 512^2 down to 64^2, the narrow body's)
    through ``conv_list``, each shape checked against the plain version
    (appended to ``checks``) and run twice on the same inputs (whether the
    two outputs are bit-identical), with per-model totals.  Returns the
    list's totals, its ``by_body`` row (with ``launches_main_path``, the
    body's count from the main path's run) and the rows."""
    import torch

    from jcfszxc_unet_tpu_torch.ops.kernels.conv_fused import (
        conv3x3_affine_relu_kmajor,
    )
    from jcfszxc_unet_tpu_torch.scripts import conv_body_lists as cbl

    res = conv_list(cbl.NARROW, torch.bfloat16, "narrow", seed=5)
    checks += res["checks"]
    g = torch.Generator(device="cuda").manual_seed(6)
    identical = 0
    for b, h, wd, cin, cout, relu in cbl.NARROW:
        x, w, scale, shift = conv_inputs(g, b, h, wd, cin, cout,
                                         torch.bfloat16)
        w_km = w.permute(3, 0, 1, 2).contiguous()
        first = conv3x3_affine_relu_kmajor(x, w_km, scale, shift, relu)
        second = conv3x3_affine_relu_kmajor(x, w_km, scale, shift, relu)
        torch.cuda.synchronize()
        identical += bool(torch.equal(first, second))
        del x, w, w_km, first, second
    t = res["total"]
    models = cbl.by_model(res["rows"], ("ms", "library_ms", "bound_ms"))
    keys = ("ms", "bound_ms", "library_ms", "plain_ms")
    out = {**t, "identical": identical,
           "bodies": sorted({r["body"] for r in res["rows"]}),
           "models": models, "rows": res["rows"],
           "by_body": {"dtype": "bfloat16", "list": "zoo narrow list",
                       "convs": t["n_convs"], **{k: t[k] for k in keys},
                       "launches_main_path": launches_main_path}}
    print(f"[conv] narrow list ({t['n_convs']} convs, {len(cbl.NARROW)} "
          f"shapes, bodies {out['bodies']}): kernel {t['ms']:.3f} ms "
          f"({t['flops'] / t['ms'] / 1e9:.1f} TFLOP/s), plain "
          f"{t['plain_ms']:.3f} ms, cuDNN {t['library_ms']:.3f} ms, bound "
          f"{t['bound_ms']:.3f} ms ({t['bound_by']}); kernel vs plain "
          f"{t['checks_ok']}/{t['checks']} shapes; twice bit-identical "
          f"{identical}/{len(cbl.NARROW)}", flush=True)
    for r in res["rows"]:
        print(f"    {r['shape']} relu={int(r['relu'])} x{r['count']}: "
              f"{r['ms']:.4f} ms, cuDNN {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms", flush=True)
    for model, m in models.items():
        print(f"[conv] narrow list, {model}: kernel {m['ms']:.3f} ms, cuDNN "
              f"{m['library_ms']:.3f} ms, bound {m['bound_ms']:.3f} ms",
              flush=True)
    return out


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
    """The three kernels' launches since :func:`reset_counts`, and kernel
    1's by body."""
    from jcfszxc_unet_tpu_torch.ops.kernels import conv_fused
    from jcfszxc_unet_tpu_torch.parallel import jobs

    return jobs.launch_counts(), dict(conv_fused.counter.bodies)


def reset_counts():
    import torch

    from jcfszxc_unet_tpu_torch.parallel import jobs

    torch.cuda.synchronize()
    jobs.reset_counts()


# SegNet's pooling windows in an f32 check against a CPU copy
# (shared_pool_windows): a window where the CPU copy's first maximum is
# not the card's passes only as a tie, its value at the card's choice
# within POOL_TIE_REL of the pooled map's largest |value| (the f32 conv
# check's tolerance, CONV_TOL, taken of the map that pools) below that
# maximum in the CPU copy, or within POOL_TIE_ABS of it near zero; at
# most POOL_MAX_FLIPPED windows may flip in one comparison.  The gap is
# taken against the map and not the window: a value that rounding moves
# across zero before the ReLU is a tie (1e-8 against 0), though it lies
# millions of ulps from the window's maximum.  On 2 patches of 128^2
# (about a million windows) the f32 forwards of 8 weight seeds flipped 0
# to 2 windows each, with gaps of at most 7.2e-7 of the map (``--pool-gaps
# 8`` on an H100), where a choice that no rounding explains is off by
# ~1e-2 of it or more.
POOL_TIE_REL = CONV_TOL["float32"]
POOL_TIE_ABS = 1e-12
POOL_MAX_FLIPPED = 8


def _pool_windows(x):
    """x (N, C, H, W) -> its 2x2 windows (N, H/2, W/2, 4, C), positions in
    (row, column) order as ``ops.layers.max_pool2d_with_indices`` takes
    them."""
    from jcfszxc_unet_tpu_torch.ops.layers import nhwc

    n, c, h, w = x.shape
    xw = nhwc(x).reshape(n, h // 2, 2, w // 2, 2, c)
    return xw.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4, c)


@contextlib.contextmanager
def shared_pool_windows():
    """SegNet unpools each 2x2 window to its first maximum, so two f32
    forwards whose convs sum in different orders can pick different
    positions where a window's top two values lie a few ulps apart, and
    the output then moves by ~1e-2 whatever the kernel: on 2 patches of
    128^2 a window or two flips in some runs under either f32 body of
    kernel 1.  Inside this block the first forward
    (the card's) records each window's choice and the next one (the CPU
    copy's) takes it, counting in ``["flipped"]`` the windows whose own
    choice differed and in ``["untied"]`` those of them whose value at
    the card's choice lies more than POOL_TIE_REL of the map's largest
    |value| (and POOL_TIE_ABS) below the CPU copy's maximum
    (``["gaps_rel"]``: each flipped window's gap over that largest
    |value|), so that the comparison measures the arithmetic and
    :func:`check_pool_windows` fails on a choice that no rounding
    explains."""
    import torch

    from jcfszxc_unet_tpu_torch.models import SegNet as segnet

    real = segnet.max_pool2d_with_indices
    log = {"recorded": [], "replay": None, "flipped": 0, "untied": 0,
           "gaps_rel": []}

    def pool(x):
        pooled, onehot = real(x)
        if log["replay"] is None:
            log["recorded"].append(onehot.cpu())
            return pooled, onehot
        theirs = log["recorded"][log["replay"]].to(onehot.device)
        log["replay"] += 1
        flipped = (theirs != onehot).any(dim=3)
        if bool(flipped.any()):
            xw = _pool_windows(x)
            top = xw.amax(dim=3)[flipped]
            chosen = (xw * theirs).sum(dim=3)[flipped]  # one marked value
            scale = float(x.abs().max())
            gaps = (top - chosen).tolist()
            log["gaps_rel"] += [g / scale for g in gaps]
            log["untied"] += sum(g > POOL_TIE_REL * scale + POOL_TIE_ABS
                                 for g in gaps)
        log["flipped"] += int(flipped.sum())
        return pooled, theirs

    segnet.max_pool2d_with_indices = pool
    try:
        yield log
    finally:
        segnet.max_pool2d_with_indices = real


def check_pool_windows(log):
    """Raise unless every window that :func:`shared_pool_windows` gave the
    CPU copy against its own choice was a tie, and at most
    POOL_MAX_FLIPPED of them."""
    if log["untied"] or log["flipped"] > POOL_MAX_FLIPPED:
        raise AssertionError(
            f"pooling windows: {log['flipped']} flipped (at most "
            f"{POOL_MAX_FLIPPED}), {log['untied']} of them not ties within "
            f"{POOL_TIE_REL} of the map (gaps over its largest |value|: "
            f"{sorted(log['gaps_rel'])[-8:]})")


def f32_against_cpu_copy(model, fn, **predictor_kwargs):
    """max |dprob| between ``fn(predictor)`` on the card and on a CPU copy
    of ``model``, both f32 (on the CPU the wrappers take their plain
    versions), with SegNet's pooling windows shared
    (:func:`shared_pool_windows`), and the reference's std;
    ``predictor_kwargs`` go to both predictors."""
    diff, std, windows = f32_pair(model, fn, **predictor_kwargs)
    check_pool_windows(windows)
    return diff, std


def f32_pair(model, fn, **predictor_kwargs):
    """:func:`f32_against_cpu_copy`'s comparison, returning also the log
    of :func:`shared_pool_windows` unchecked."""
    import copy

    import torch

    from jcfszxc_unet_tpu_torch.eval.predictor import Predictor

    with shared_pool_windows() as windows:
        got = fn(Predictor(model, compute_dtype=torch.float32, device="cuda",
                           **predictor_kwargs))
        cpu = Predictor(copy.deepcopy(model).cpu(),
                        compute_dtype=torch.float32, device="cpu",
                        **predictor_kwargs)
        windows["replay"] = 0
        want = fn(cpu)
    diff = float((got.cpu() - want).abs().max())
    if windows["recorded"]:  # the CPU copy once more with its own choices
        own = float((got.cpu() - fn(cpu)).abs().max())
        gaps = windows["gaps_rel"]
        print(f"[f32] pooling windows: {windows['flipped']} of the CPU "
              f"copy's chose another first maximum ({windows['untied']} "
              f"not ties within {POOL_TIE_REL} of the map; largest gap "
              f"{max(gaps, default=0):.2e} of it); max |dprob| {diff:.2e} "
              f"with the card's choices, {own:.2e} with its own", flush=True)
    del cpu
    return diff, float(want.std()), windows


def pool_gaps(n_seeds):
    """``--pool-gaps N``: zoo_eval's f32 check of SegNet (2 patches of
    128^2 from the main path's images) for weight seeds 11 (zoo_eval's)
    .. 10 + N; one JSON line of each seed's flipped windows and their gaps
    over the map's largest |value|."""
    import numpy as np
    import torch

    from jcfszxc_unet_tpu_torch.data.sampler import extract_patches

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    images, _, _ = synthetic_drive(N_IMAGES, IMG_H, IMG_W, seed=0)
    centers = np.array([[0, IMG_H // 2, IMG_W // 2],
                        [1, IMG_H // 3, IMG_W // 3]][:ZOO_F32_PATCHES])
    patches = extract_patches(torch.as_tensor(images[:2], device=dev),
                              centers, ZOO_F32_HW)
    seed0 = 10 + list(ZOO).index("SegNet.SegNet")
    runs = []
    for seed in range(seed0, seed0 + n_seeds):
        model = build_model(dev, seed=seed, name="SegNet.SegNet")
        diff, _, log = f32_pair(
            model, lambda p: p.predict_patches(patches.to(p.device)))
        runs.append({"seed": seed, "flipped": log["flipped"],
                     "untied": log["untied"], "gaps_rel": log["gaps_rel"],
                     "max_abs_dprob": diff})
        del model
    gaps = [g for r in runs for g in r["gaps_rel"]]
    print(json.dumps({"pool_gaps": runs, "tie_rel": POOL_TIE_REL,
                      "max_flipped": max(r["flipped"] for r in runs),
                      "max_gap_rel": max(gaps, default=0.0),
                      "gpu": gpu_name_and_power()}))


def phase_zoo_eval(report, state):
    import numpy as np
    import torch

    from jcfszxc_unet_tpu_torch.cli.evaluate import evaluate_arrays
    from jcfszxc_unet_tpu_torch.data.sampler import extract_patches
    from jcfszxc_unet_tpu_torch.scripts.conv_body_lists import (
        MULTIRES as MULTIRES_CONVS,
    )

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
        calls = {(key[0] * min(INFER_BATCH, n_patches), *key[1:]): n
                 for key, n in calls.items()}
        convs = conv_list(calls, torch.bfloat16, "zoo_chunk")
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
            # the kernels phase timed the mma_sync body on this list
            "mma_sync_list_as_timed": name != MULTIRES or {
                k: n for k, n in calls.items() if k[3] % 8} == MULTIRES_CONVS,
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
        for b in ("wgmma", "mma_sync", "narrow")}
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


# The orbax phase: the JAX package's save_orbax of the .ckpt fixture
# (tests/test_torch_port_orbax.write_jax_orbax_fixture: OCDBT, zstd) and its
# step; its f32 forward against the JAX output within the .ckpt path's
# tolerance; the decoder timed over at least ORBAX_DECODE_S seconds; the
# port's save_orbax of the trained UNet restored in a fresh process that
# may import none of ORBAX_BLOCKED.
ORBAX_FIXTURE = os.path.join(ROOT, "tests", "torch_port_data",
                             "transfusenet_jax_orbax")
ORBAX_FIXTURE_STEP, ORBAX_FIXTURE_TOL, ORBAX_DECODE_S = 7, 1e-5, 0.5
ORBAX_DIR = os.path.join(ROOT, "build", "chip_smoke_orbax")
ORBAX_BLOCKED = ("jax", "jaxlib", "flax", "jcfszxc_unet_tpu", "orbax",
                 "tensorstore", "zstandard")


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def orbax_child(workdir: str) -> None:
    """``python3 chip_smoke.py --orbax-child DIR``: in this fresh process
    (torch and the port only), ``restore_orbax`` of ``DIR/unet_orbax`` onto
    the card, its ``state_dict`` loaded ``strict=True`` into a new UNet,
    ``evaluate_arrays`` of ``DIR/{images,masks,labels}.npy`` in bf16 with
    the launches read around it; saves the maps and prints one JSON line."""
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from jcfszxc_unet_tpu_torch.cli.evaluate import evaluate_arrays
    from jcfszxc_unet_tpu_torch.models import create_model
    from jcfszxc_unet_tpu_torch.train.checkpoint import restore_orbax

    torch.zeros(1, device="cuda")  # CUDA initialised outside the timing
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree = restore_orbax(os.path.join(workdir, "unet_orbax"), device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    sd, sd16 = tree["state_dict"], tree["state_dict_bf16"]
    model = create_model("UNet.UNet").to("cuda")
    model.load_state_dict(sd, strict=True)
    model = model.to(memory_format=torch.channels_last).eval()
    arrays = [np.load(os.path.join(workdir, f"{n}.npy"))
              for n in ("images", "masks", "labels")]
    reset_counts()
    res = evaluate_arrays(model, *arrays, patch_size=PATCH,
                          inference_batch_size=INFER_BATCH,
                          compute_dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    launches, bodies = launch_counts()
    np.save(os.path.join(workdir, "probs.npy"), res["pred_maps"])
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ORBAX_BLOCKED)
    print(json.dumps({
        "restore_s": restore_s, "launches": launches, "bodies": bodies,
        "dice": res["dice"], "step": tree["step"],
        "none_leaf": tree["scheduler"] is None,
        "leaves_on_card": all(t.is_cuda for t in [*sd.values(),
                                                  *sd16.values()]),
        "bf16_leaves_equal": sorted(sd16) == sorted(
            k for k, v in sd.items() if v.is_floating_point())
        and all(torch.equal(v, sd[k].bfloat16()) for k, v in sd16.items()),
        "modules_not_allowed": loaded,
        "device": torch.cuda.get_device_name(0)}), flush=True)


def phase_orbax(report, state):
    """Orbax directories: the JAX fixture through the port's OCDBT, zarr
    and zstd readers into TransFuseNet (kernel 1), the decoder's rate, and
    the trained full-width UNet saved by the port and restored in a fresh
    process into ``evaluate_arrays`` (kernel 1 and ``dice_sums``)."""
    import numpy as np
    import torch

    from jcfszxc_unet_tpu_torch.cli.evaluate import evaluate_arrays
    from jcfszxc_unet_tpu_torch.compat import zstd
    from jcfszxc_unet_tpu_torch.compat.from_jax import state_dict_from_jax
    from jcfszxc_unet_tpu_torch.compat.host_build import load_host_library
    from jcfszxc_unet_tpu_torch.compat.ocdbt import OcdbtStore
    from jcfszxc_unet_tpu_torch.compat.torch_import import (
        model_from_state_dict,
    )
    from jcfszxc_unet_tpu_torch.models import create_model
    from jcfszxc_unet_tpu_torch.train import checkpoint as ckpt

    dev = torch.device("cuda")
    out = {"checks": {}}
    checks = out["checks"]
    launches_sum = {"conv3x3_affine_relu": 0, "dice_sums": 0,
                    "conv3x3_relu_imcol": 0}

    def add(launches):
        for key in launches_sum:
            launches_sum[key] += launches[key]

    shutil.rmtree(ORBAX_DIR, ignore_errors=True)
    os.makedirs(ORBAX_DIR)
    try:
        # 1. The JAX fixture: OCDBT, zarr and zstd on this machine.
        t0 = time.perf_counter()
        load_host_library()
        out["host_library_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tree = ckpt.restore_orbax(ORBAX_FIXTURE, device="cpu")
        out["fixture_restore_ms"] = (time.perf_counter() - t0) * 1e3
        checks["fixture_step"] = tree["step"] == ORBAX_FIXTURE_STEP
        fm = model_from_state_dict(
            "RetinaLiteNet.TransFuseNet",
            state_dict_from_jax("RetinaLiteNet.TransFuseNet", tree),
            {"logit_head": True}, dev)
        fm = fm.to(memory_format=torch.channels_last).eval()
        x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
        reset_counts()
        with torch.inference_mode():
            y = fm(torch.as_tensor(x, device=dev).permute(0, 3, 1, 2))
        torch.cuda.synchronize()
        launches, _ = launch_counts()
        add(launches)
        got = y.float().permute(0, 2, 3, 1).cpu().numpy()
        want = np.load(JAX_FIXTURE_OUT)
        diff = float(np.abs(got - want).max())
        out["fixture"] = {"launches": launches, "max_abs_diff": diff,
                          "tolerance": ORBAX_FIXTURE_TOL,
                          "jax_output_std": float(want.std())}
        checks["fixture_within_1e-5"] = bool(
            got.shape == want.shape and np.isfinite(diff)
            and diff <= ORBAX_FIXTURE_TOL and want.std() > 1e-2)
        checks["fixture_6_conv_launches"] = \
            launches["conv3x3_affine_relu"] == 6
        print(f"[orbax] JAX fixture: restore "
              f"{out['fixture_restore_ms']:.1f} ms (host library "
              f"{out['host_library_s']:.2f} s), f32 max |d| {diff:.2e} "
              f"against the JAX output, launches {launches}", flush=True)
        del fm, y

        # The decoder's rate on the fixture's frames (host, one thread):
        # one call a frame, as the reader makes them, and one call over
        # the frames concatenated (a valid zstd stream), which leaves out
        # the cost of a call.
        store = OcdbtStore(ORBAX_FIXTURE)
        frames = [bytes(store.read(k)) for k in store.list()
                  if not k.endswith(".zarray")]
        joined = b"".join(frames)
        decoded = sum(len(zstd.decompress(f)) for f in frames)
        checks["zstd_joined_frames"] = len(zstd.decompress(joined)) == decoded

        def rate(calls):
            reps, t0 = 0, time.perf_counter()
            while time.perf_counter() - t0 < ORBAX_DECODE_S:
                for f in calls:
                    zstd.decompress(f)
                reps += 1
            return decoded * reps / (time.perf_counter() - t0) / 1e6

        out["zstd"] = {"frames": len(frames), "compressed_bytes": len(joined),
                       "decoded_bytes": decoded,
                       "mb_per_s": rate(frames),
                       "mb_per_s_one_call": rate([joined])}
        print(f"[orbax] zstd decoder: {len(frames)} frames, {len(joined)} "
              f"-> {decoded} bytes, {out['zstd']['mb_per_s']:.1f} MB/s "
              f"decoded a call a frame, "
              f"{out['zstd']['mb_per_s_one_call']:.1f} MB/s in one call",
              flush=True)

        # 2. Full width: the trained UNet saved by the port, restored in a
        # fresh process.
        sd = {k: v.detach() for k, v in
              state["train_model"].state_dict().items()}
        tree = {"state_dict": sd,
                "state_dict_bf16": {k: v.bfloat16() for k, v in sd.items()
                                    if v.is_floating_point()},
                "scheduler": None, "step": TRAIN_EPOCHS * TRAIN_STEPS}
        path = os.path.join(ORBAX_DIR, "unet_orbax")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_orbax(path, tree)
        out["save_s"] = time.perf_counter() - t0
        out["bytes"] = dir_bytes(path)
        for name in ("images", "masks", "labels"):
            np.save(os.path.join(ORBAX_DIR, f"{name}.npy"), state[name])
        model = create_model("UNet.UNet").to(dev)
        model.load_state_dict(sd, strict=True)
        res = evaluate_arrays(model, state["images"], state["masks"],
                              state["labels"], patch_size=PATCH,
                              inference_batch_size=INFER_BATCH,
                              compute_dtype=torch.bfloat16, device=dev)
        del model
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--orbax-child",
             ORBAX_DIR], capture_output=True, text=True, timeout=300,
            cwd=ROOT)
        out["child_seconds"] = time.perf_counter() - t0
        if child.returncode != 0:
            raise RuntimeError(f"orbax child failed:\n{child.stderr[-4000:]}")
        res_c = json.loads(child.stdout.strip().splitlines()[-1])
        out["child"] = res_c
        add(res_c["launches"])
        maps = np.load(os.path.join(ORBAX_DIR, "probs.npy"))
        out["max_abs_dprob"] = float(np.abs(maps - res["pred_maps"]).max())
        out["dice"] = res["dice"]
        checks["child_without_jax_or_orbax"] = \
            res_c["modules_not_allowed"] == []
        checks["child_leaves_on_card"] = res_c["leaves_on_card"]
        checks["child_step_none_and_bf16_leaves"] = (
            res_c["step"] == TRAIN_EPOCHS * TRAIN_STEPS and res_c["none_leaf"]
            and res_c["bf16_leaves_equal"])
        checks["child_18_conv_1_dice_launches"] = res_c["launches"] == {
            "conv3x3_affine_relu": 18, "dice_sums": 1,
            "conv3x3_relu_imcol": 0}
        checks["child_dice_equal"] = res_c["dice"] == res["dice"]
        checks["child_maps_equal"] = out["max_abs_dprob"] == 0.0
        print(f"[orbax] full-width UNet: save_orbax {out['save_s']:.3f} s, "
              f"{out['bytes']} bytes; restore in a fresh process "
              f"{res_c['restore_s']:.3f} s (child {out['child_seconds']:.1f} "
              f"s); dice {[round(d, 4) for d in res_c['dice']]} (parent "
              f"{[round(d, 4) for d in res['dice']]}), max |dprob| "
              f"{out['max_abs_dprob']:.1e}, child launches "
              f"{res_c['launches']}", flush=True)
    finally:
        shutil.rmtree(ORBAX_DIR, ignore_errors=True)
    out["launches"] = dict(launches_sum)
    report["orbax"] = out
    state["orbax_launches"] = launches_sum
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"orbax checks failed: {bad}")


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
    reset_counts()
    metrics, probs = make_val_fn(model, compute_dtype=torch.float32)(
        val_imgs, val_labs)
    _, bodies = launch_counts()
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
        "plain_path": plain, "prob_std": float(want.std()),
        "conv_bodies": bodies}
    n_chunks = math.ceil(val_imgs.shape[0] / VAL_CHUNK)
    print(f"[train-f32] val through the kernels vs plain forward on "
          f"{val_imgs.shape[0]} patches: max |dprob| {dprob:.3e} (tolerance "
          f"1e-3), |ddice| {ddice['dice']:.3e}, |ddice_fg| "
          f"{ddice['dice_fg']:.3e} (tolerance 1e-3); conv bodies {bodies}",
          flush=True)
    if not (np.isfinite(dprob) and dprob <= 1e-3
            and all(v <= 1e-3 for v in ddice.values())):
        raise AssertionError(
            f"train val f32: max |dprob| {dprob}, |ddice| {ddice}")
    if bodies != {"f32_box": 18 * n_chunks}:
        raise AssertionError(f"train val f32 conv bodies {bodies}, expected "
                             f"{{'f32_box': {18 * n_chunks}}}")


def plain_extractor_forward(ext, x):
    """The fractal extractor's eval forward built only from kernel 1's
    plain version and stock torch ops.  x: NCHW; returns NCHW."""
    import torch
    import torch.nn.functional as F

    from jcfszxc_unet_tpu_torch.ops.kernels.conv_fused import (
        conv3x3_affine_relu_torch,
    )

    def conv(c, x):
        return F.conv2d(x, c.weight.to(x.dtype), c.bias.to(x.dtype),
                        padding=c.padding, dilation=c.dilation)

    c1, d1 = ext.fractal_conv1, ext.ms_conv_d1
    w = torch.cat([c1.weight, d1.weight]).to(x.dtype).permute(2, 3, 1, 0)
    shift = torch.cat([c1.bias, d1.bias]).float()
    y = conv3x3_affine_relu_torch(
        x.permute(0, 2, 3, 1), w.contiguous(), torch.ones_like(shift),
        shift).permute(0, 3, 1, 2)
    feats = [y[:, 16:]] + [torch.relu(conv(getattr(ext, f"ms_conv_d{s}"), x))
                           for s in (2, 4, 8)]
    f = conv(ext.fractal_conv2, y[:, :16])
    return conv(ext.fusion_conv, torch.cat(feats + [f], dim=1)) + x


def phase_fractal(report, state):
    """The fractal trainer (``train.fractal.fractal_train_arrays``, what
    ``cli.train_demo`` runs) on full-width UNet plus the extractor, FOV
    masks as targets, whole-image validation through both kernels."""
    import importlib.util

    import numpy as np
    import torch

    from jcfszxc_unet_tpu_torch.ops.kernels.dice_fused import (
        dice_from_sums,
        dice_sums,
        dice_sums_torch,
    )
    from jcfszxc_unet_tpu_torch.data.sampler import sample_centers
    from jcfszxc_unet_tpu_torch.train.checkpoint import (
        load_extra,
        load_model_any,
    )
    from jcfszxc_unet_tpu_torch.train.fractal import (
        VAL_CHUNK,
        box_dimension,
        build_fractal_sample_maps,
        fractal_sample_batch,
        fractal_sample_indices,
        fractal_train_arrays,
        level_sample_counts,
        make_fractal_step_fn,
        make_fractal_val_fn,
    )
    from jcfszxc_unet_tpu_torch.train.optim import make_optimizer
    from jcfszxc_unet_tpu_torch.train.trainer import split_indices
    from jcfszxc_unet_tpu_torch.utils.profiling import trace

    dev = torch.device("cuda")
    model = build_model(dev, seed=4)  # calibrated BN, seeded
    images, masks, _ = synthetic_drive(TRAIN_IMAGES, IMG_H, IMG_W, seed=5)
    n_val = int(TRAIN_IMAGES * TRAIN_VAL)
    n_chunks = math.ceil(n_val / VAL_CHUNK)
    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(ckpt_dir, exist_ok=True)
    save_path = os.path.join(ckpt_dir, "fractal_best.pt")
    bundle_path = os.path.join(ckpt_dir, "fractal_bundle.pt")
    for path in (save_path, bundle_path, save_path + ".sync",
                 bundle_path + ".sync"):
        if os.path.exists(path):
            os.remove(path)

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = fractal_train_arrays(
        model, images, masks, model_name="UNet.UNet", steps=FRACTAL_STEPS,
        batch_size=TRAIN_BATCH, learning_rate=TRAIN_LR, val_percent=TRAIN_VAL,
        patch_size=TRAIN_PATCH, seed=0, compute_dtype=torch.bfloat16,
        max_epochs=FRACTAL_EPOCHS, visualize=False, save_path=save_path,
        bundle_path=bundle_path, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, bodies = launch_counts()
    peak_run = torch.cuda.max_memory_allocated()
    state["fractal_launches"] = launches
    state["conv_bodies"]["fractal"] = bodies
    hist, ext = res["history"], res["extractor"]

    # The same run with synchronous checkpoint writes (--sync-checkpoints):
    # its epoch-2 steps have no background write of epoch 1's checkpoints
    # in flight, so they give the step metric.
    t0 = time.perf_counter()
    sync_res = fractal_train_arrays(
        build_model(dev, seed=4), images, masks, model_name="UNet.UNet",
        steps=FRACTAL_STEPS, batch_size=TRAIN_BATCH,
        learning_rate=TRAIN_LR, val_percent=TRAIN_VAL,
        patch_size=TRAIN_PATCH, seed=0, compute_dtype=torch.bfloat16,
        max_epochs=FRACTAL_EPOCHS, visualize=False,
        save_path=save_path + ".sync", bundle_path=bundle_path + ".sync",
        async_checkpoints=False, device=dev)
    sync_wall = time.perf_counter() - t0
    sync_hist = sync_res["history"]
    del sync_res

    # The validation images of the run's split (seed 0), on the card.
    np.random.seed(0)
    val_idx, train_idx = split_indices(TRAIN_IMAGES, TRAIN_VAL)
    vi = torch.as_tensor(images[val_idx], device=dev)
    vm = torch.as_tensor(masks[val_idx, ..., None], device=dev)
    val_bf16 = make_fractal_val_fn(model, ext, compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _, probs_bf16 = val_bf16(vi, vm)
    torch.cuda.synchronize()
    peak_val = torch.cuda.max_memory_allocated() - base

    # box_dimension on the card against the CPU's, on masks and maps
    maps = torch.cat([vm[..., 0], probs_bf16[..., 0]])
    bd_gpu = box_dimension(maps).cpu()
    bd_cpu = box_dimension(maps.cpu())
    bd_diff = float((bd_gpu - bd_cpu).abs().max())

    # Kernel 1 on the validation's conv list (checked against the plain
    # version, timed beside cuDNN), kernel 2 at the validation's shape.
    convs = conv_list(record_convs(lambda: val_bf16(vi, vm)), torch.bfloat16,
                      "fractal_val")
    times = convs["total"]
    g = torch.Generator(device=dev).manual_seed(8)
    p = torch.rand((n_val, IMG_H, IMG_W), generator=g, device=dev)
    t = (torch.rand((n_val, IMG_H, IMG_W), generator=g, device=dev)
         > 0.5).float()
    dice_err = max(float(((a - b).abs() / b.abs().clamp(min=1e-30)).max())
                   for a, b in zip(dice_sums(p, t), dice_sums_torch(p, t)))

    # f32: the validation through the kernels against the plain versions
    dice_k, probs_k = make_fractal_val_fn(
        model, ext, compute_dtype=torch.float32)(vi, vm)
    model.eval()
    ext.eval()
    with torch.no_grad():
        x = vi.permute(0, 3, 1, 2)
        want = torch.sigmoid(plain_unet_forward(
            model, plain_extractor_forward(ext, x)).float()
        ).permute(0, 2, 3, 1)
    model.train()
    ext.train()
    dice_plain = float(dice_from_sums(*dice_sums_torch(
        (want[..., 0] > 0.5).float(), vm[..., 0])).mean())
    dprob = float((probs_k - want).abs().max())
    ddice = abs(float(dice_k) - dice_plain)
    std = float(want.std())

    # where the time goes: one fractal step and one bf16 validation pass
    sizes, maps_np = build_fractal_sample_maps(masks[train_idx], TRAIN_PATCH)
    lmaps = [torch.as_tensor(m, device=dev).long() for m in maps_np]
    pool = torch.as_tensor(images[train_idx], device=dev)
    tpool = torch.as_tensor(masks[train_idx, ..., None], device=dev)
    counts = level_sample_counts(TRAIN_BATCH)
    opt = make_optimizer(list(model.parameters()) + list(ext.parameters()),
                         TRAIN_LR)
    step = make_fractal_step_fn(model, ext, opt,
                                compute_dtype=torch.bfloat16)
    gs = torch.Generator(device=dev).manual_seed(9)

    def one_step():
        imgs, tgts = fractal_sample_batch(
            pool, tpool, [sample_centers(gs, m, c)
                          for m, c in zip(lmaps, counts)], sizes, TRAIN_PATCH)
        return step(imgs, tgts, fractal_sample_indices(gs, TRAIN_BATCH))

    prof = {}
    for name, fn, reps in (("step", one_step, 5),
                           ("val_pass", lambda: val_bf16(vi, vm), 3)):
        wall_ms = host_ms(fn, reps)
        rows = device_rows(fn, reps=reps)
        busy = sum(r["device_ms"] for r in rows)
        prof[name] = {"untraced_wall_ms": wall_ms, "device_ms_total": busy,
                      "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
                      "top": rows[:25]}

    # utils.profiling.trace (what --profile-dir runs) on the card: its
    # Chrome trace holds the step's kernels
    trace_dir = os.path.join(ckpt_dir, "fractal_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    with trace(trace_dir):
        one_step()
        torch.cuda.synchronize()
    (trace_file,) = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, trace_file)) as f:
        events = json.load(f)["traceEvents"]
    trace_kernels = sum(e.get("cat") == "kernel" for e in events)

    readers = {m: importlib.util.find_spec(m) is not None
               for m in ("PIL", "h5py", "joblib")}
    # The step metric comes from an epoch with no write in flight; the
    # checkpoint's cost end to end, from the time between the end of epoch
    # 1's steps and the end of epoch 2's (validation, epoch 1's save and
    # epoch 2's steps) in each run.
    steady = sync_hist[-1]
    step_ms = steady["train_seconds"] * 1e3 / FRACTAL_STEPS
    step_ms_write = hist[-1]["train_seconds"] * 1e3 / FRACTAL_STEPS

    def window_ms(h):
        return (h[-1]["train_end_seconds"] - h[-2]["train_end_seconds"]) * 1e3

    window = {"background": window_ms(hist), "sync": window_ms(sync_hist),
              "epoch1_saved": hist[0]["best_dice"] > 0.0}
    reloaded = None
    if res["best_dice"] > 0.0:
        reloaded, _ = load_model_any(save_path, dev)
        extra = load_extra(bundle_path)
    checks = {
        "epochs_run": len(hist) == FRACTAL_EPOCHS,
        "losses_finite": all(math.isfinite(r["loss"]) for r in hist),
        "no_step_skipped": all(r["skipped_steps"] == 0 for r in hist),
        "val_dice_finite": all(math.isfinite(r["dice"])
                               and 0.0 <= r["dice"] <= 1.0 for r in hist),
        "box_dimension_card_equals_cpu": bd_diff <= 1e-6,
        "checkpoints_reload": res["best_dice"] == 0.0 or (
            isinstance(reloaded, torch.nn.Module)
            and set(extra) == {"extractor", "optimizer"}),
        "conv_launches_19_per_chunk_per_epoch":
            launches["conv3x3_affine_relu"]
            == 19 * n_chunks * FRACTAL_EPOCHS,
        # the extractor's stacked 3 -> 32 and UNet's 3 -> 64 on mma.sync
        "conv_bodies_17_wgmma_2_mma_sync_per_chunk": bodies == {
            "wgmma": 17 * n_chunks * FRACTAL_EPOCHS,
            "mma_sync": 2 * n_chunks * FRACTAL_EPOCHS},
        "dice_launched_once_per_val_pass":
            launches["dice_sums"] == FRACTAL_EPOCHS,
        "conv_list_kernel_vs_plain": times["checks_ok"] == times["checks"],
        "dice_kernel_vs_plain": dice_err <= 1e-5,  # as in phase_kernels
        "f32_probs_within_tol": math.isfinite(dprob) and dprob <= FRACTAL_TOL,
        "f32_dice_within_tol": ddice <= FRACTAL_TOL,
        "f32_std_over_floor": std >= FRACTAL_STD_FLOOR,
        "profiling_trace_has_kernels": trace_kernels > 0,
    }
    train_ms = (report.get("train_path", {}).get("steady_ms_per_step"))
    report["fractal"] = {
        "model": "UNet.UNet", "n_images": TRAIN_IMAGES, "n_val": n_val,
        "image_hw": [IMG_H, IMG_W], "patch": TRAIN_PATCH,
        "batch": TRAIN_BATCH, "levels": counts, "level_patches": sizes,
        "lr": TRAIN_LR, "steps": FRACTAL_STEPS, "epochs": FRACTAL_EPOCHS,
        "dtype": "bfloat16", "val_chunk": VAL_CHUNK,
        "launches": launches, "conv_bodies": bodies, "history": hist,
        "best_dice": res["best_dice"], "wall_seconds": wall,
        "wall_seconds_sync_checkpoints": sync_wall,
        "steady_ms_per_step": step_ms,
        "ms_per_step_background_write_in_flight": step_ms_write,
        "epoch1_steps_end_to_epoch2_steps_end_ms": window,
        "history_sync_checkpoints": sync_hist,
        "train_path_ms_per_step": train_ms,
        "steady_val_ms": steady["val_seconds"] * 1e3,
        "launches_per_val_pass": {"conv3x3_affine_relu": 19 * n_chunks,
                                  "dice_sums": 1},
        "peak_allocated_bytes_run": peak_run,
        "peak_allocated_bytes_val_pass_over_start": peak_val,
        "box_dimension_max_abs_diff": bd_diff,
        "conv_per_val_pass": convs, "dice_max_rel_err": dice_err,
        "f32": {"max_abs_dprob": dprob, "dice_kernels": float(dice_k),
                "dice_plain": dice_plain, "dice_abs_diff": ddice,
                "prob_std": std, "tolerance": FRACTAL_TOL,
                "std_floor": FRACTAL_STD_FLOOR},
        "profile": prof, "trace_kernel_events": trace_kernels,
        "host_readers": readers, "checks": checks,
    }
    print(f"[fractal] UNet + extractor, {FRACTAL_EPOCHS} epochs x "
          f"{FRACTAL_STEPS} steps, batch {TRAIN_BATCH} (levels {counts} at "
          f"{sizes}), patch {TRAIN_PATCH}, bf16; val {n_val} whole "
          f"{IMG_H}x{IMG_W} images; launches {launches}, bodies {bodies}",
          flush=True)
    for r in hist:
        print(f"[fractal] epoch {r['epoch']}: loss {r['loss']:.5f}, val dice "
              f"{r['dice']:.4f}, skipped {r['skipped_steps']}, train "
              f"{r['train_seconds'] * 1e3:.1f} ms, val "
              f"{r['val_seconds'] * 1e3:.1f} ms", flush=True)
    print(f"[fractal] end of epoch 1's steps to end of epoch 2's (val, "
          f"epoch 1's save, epoch 2's steps): {window['sync']:.2f} ms with "
          f"synchronous checkpoints, {window['background']:.2f} ms with "
          f"background writes (epoch 1's val "
          f"{sync_hist[0]['val_seconds'] * 1e3:.2f} / "
          f"{hist[0]['val_seconds'] * 1e3:.2f} ms); whole run "
          f"{sync_wall:.3f} / {wall:.3f} s (the background run goes first)",
          flush=True)
    print(f"[fractal] steady: {step_ms:.2f} ms per fractal step with no "
          f"write in flight ({step_ms_write:.2f} while the background writer "
          f"saves epoch 1's checkpoints; train_path step: "
          f"{'n/a' if train_ms is None else f'{train_ms:.2f}'} ms), "
          f"val pass {steady['val_seconds'] * 1e3:.2f} ms; launches per val "
          f"pass: conv {19 * n_chunks}, dice 1; peak allocated "
          f"{peak_run / 2**30:.2f} GiB in the run, val pass "
          f"{peak_val / 2**20:.1f} MiB over its start", flush=True)
    for name, row in prof.items():
        print(f"[fractal] profile {name}: device busy "
              f"{row['device_ms_total']:.2f} ms of "
              f"{row['untraced_wall_ms']:.2f} ms wall (idle share "
              f"{row['device_idle_share']:.3f}); top:", flush=True)
        for r in row["top"][:5]:
            print(f"    {r['device_ms']:9.3f} ms  x{r['count']:<5g} "
                  f"{r['name']}", flush=True)
    print(f"[fractal] val conv list ({times['n_convs']} calls): kernel "
          f"{times['ms']:.2f} ms, plain {times['plain_ms']:.2f} ms, cuDNN "
          f"{times['library_ms']:.2f} ms, bound {times['bound_ms']:.2f} ms, "
          f"kernel vs plain {times['checks_ok']}/{times['checks']} shapes; "
          f"dice vs plain max rel {dice_err:.2e}; box_dimension card vs CPU "
          f"{bd_diff:.2e}", flush=True)
    print(f"[fractal] f32 val through the kernels vs plain: max |dprob| "
          f"{dprob:.3e}, |ddice| {ddice:.3e} (tolerance {FRACTAL_TOL}), prob "
          f"std {std:.4f} (floor {FRACTAL_STD_FLOOR}); utils.profiling.trace "
          f"of one step: {trace_kernels} kernel events; host readers on this "
          f"machine: {readers}", flush=True)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"fractal checks failed: {bad}")


def step_ms_and_peak(model, batch, remat=False, n_warm=1, n_timed=4):
    """ms per bf16 train step (host clock to a device sync, ``n_timed``
    steps after ``n_warm``) and peak allocated bytes over the timed steps
    of ``model`` on one fixed (imgs, labs) batch, and the allocated bytes
    at their start."""
    import torch

    from jcfszxc_unet_tpu_torch.train.optim import make_optimizer
    from jcfszxc_unet_tpu_torch.train.state import TrainState
    from jcfszxc_unet_tpu_torch.train.trainer import make_batch_step_fn

    state = TrainState(model.train(), make_optimizer(model.parameters(),
                                                     TRAIN_LR))
    step = make_batch_step_fn(n_classes=model.n_classes, remat=remat,
                              compute_dtype=torch.bfloat16)
    for _ in range(n_warm):
        step(state, *batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    for _ in range(n_timed):
        loss, ok = step(state, *batch)
        if not ok:
            raise AssertionError("a timed train step was skipped")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n_timed
    return ms, torch.cuda.max_memory_allocated(), base


def phase_s2d(report, state):
    """Space-to-depth execution (``s2d``) of NestedUNet, MultiResUNet and
    FRUNet through the entry points (evaluation, ``train_arrays``), the
    ``--remat`` step and ``--resume`` from a JAX ``.ckpt``."""
    import copy

    import numpy as np
    import torch

    from jcfszxc_unet_tpu_torch.cli.evaluate import evaluate_arrays
    from jcfszxc_unet_tpu_torch.cli.train import train_arrays
    from jcfszxc_unet_tpu_torch.compat.from_jax import state_dict_from_jax
    from jcfszxc_unet_tpu_torch.data.sampler import extract_patches
    from jcfszxc_unet_tpu_torch.eval.predictor import Predictor
    from jcfszxc_unet_tpu_torch.models import create_model, with_kwargs
    from jcfszxc_unet_tpu_torch.ops.layers import reset_parameters
    from jcfszxc_unet_tpu_torch.scripts.conv_body_lists import (
        MULTIRES_S2D as MULTIRES_S2D_CONVS,
    )
    from jcfszxc_unet_tpu_torch.train import checkpoint as ckpt
    from jcfszxc_unet_tpu_torch.train.optim import make_optimizer
    from jcfszxc_unet_tpu_torch.train.state import TrainState
    from jcfszxc_unet_tpu_torch.train.trainer import make_batch_step_fn

    dev = torch.device("cuda")
    images, masks, labels = state["images"], state["masks"], state["labels"]
    n_patches = grid_count(IMG_H, IMG_W, PATCH) * N_IMAGES
    batch = min(INFER_BATCH, n_patches)
    launches_sum = {"conv3x3_affine_relu": 0, "dice_sums": 0}
    conv_by_model, out, failures = {}, {"eval": {}}, []

    def counted(fn):
        """fn() on the s2d path, its launches read around it and summed."""
        reset_counts()
        res = fn()
        torch.cuda.synchronize()
        launches, bodies = launch_counts()
        for key in launches_sum:
            launches_sum[key] += launches[key]
        return res, launches, bodies

    f32_patches = extract_patches(
        torch.as_tensor(images[:2], device=dev),
        np.array([[0, IMG_H // 2, IMG_W // 2], [1, IMG_H // 3, IMG_W // 3]]),
        ZOO_F32_HW)
    one_patch = extract_patches(torch.as_tensor(images[:1], device=dev),
                                np.array([[0, IMG_H // 2, IMG_W // 2]]),
                                PATCH)

    # 1. Evaluation of the three models in s2d mode, against their plain
    # mode on the same weights.
    for k, name in enumerate(S2D_MODELS):
        plain = build_model(dev, seed=40 + k, name=name)
        model = with_kwargs(plain, name, {"s2d": True}).eval()

        def run(m):
            return evaluate_arrays(m, images, masks, labels,
                                   patch_size=PATCH,
                                   inference_batch_size=INFER_BATCH,
                                   compute_dtype=torch.bfloat16, device=dev)

        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        res, launches, bodies = counted(lambda: run(model))
        peak = torch.cuda.max_memory_allocated()
        conv_by_model[name + " (s2d eval)"] = bodies
        timed = timed_eval(lambda: run(model), N_IMAGES)
        calls = record_convs(lambda: bf16_forward(model, one_patch))
        shapes = {key[1:5] for key in calls}
        plain_shapes = {key[1:5] for key in record_convs(
            lambda: bf16_forward(plain, one_patch))}
        s2d_shapes_seen = (shapes != plain_shapes and all(
            sh in shapes and sh not in plain_shapes
            for sh in S2D_ONLY_SHAPES[name]))
        calls = {(key[0] * batch, *key[1:]): n for key, n in calls.items()}
        convs = conv_list(calls, torch.bfloat16, "s2d_chunk", target_ms=10.0)
        # the plain mode's numbers: zoo_eval's run of the same model
        zoo = report["zoo_eval"][name]
        t, tp = convs["total"], zoo["conv_per_forward"]["total"]
        got = Predictor(model, compute_dtype=torch.float32,
                        device=dev).predict_patches(f32_patches)
        want = Predictor(plain, compute_dtype=torch.float32,
                         device=dev).predict_patches(f32_patches)
        d_plain = float((got - want).abs().max())
        d_cpu, std = f32_against_cpu_copy(
            model, lambda p: p.predict_patches(f32_patches.to(p.device)))
        want_bodies = {b: n * math.ceil(n_patches / batch)
                       for b, n in S2D_MODELS[name].items()}
        pm = res["pred_maps"]
        peak_plain = zoo["peak_allocated_bytes"]
        row = {
            "launches": launches, "conv_bodies": bodies,
            "expected_conv_bodies": want_bodies, "dice": res["dice"],
            **timed, "images_per_s_plain": zoo["images_per_s"],
            "peak_allocated_bytes": peak,
            "peak_over_start_bytes": peak - base,
            "peak_allocated_bytes_plain": peak_plain,
            "conv_per_forward": convs,
            "f32_max_abs_dprob_vs_plain_mode": d_plain,
            "f32_max_abs_dprob_vs_cpu": d_cpu, "f32_prob_std": std,
        }
        row["checks"] = {
            "pred_finite_in_0_1": bool(np.isfinite(pm).all() and pm.min() >= 0
                                       and pm.max() <= 1),
            "conv_bodies_as_expected": bodies == want_bodies,
            "s2d_only_conv_shapes_seen": s2d_shapes_seen,
            "dice_launched": launches["dice_sums"] >= 1,
            "s2d_conv_list_kernel_vs_plain": t["checks_ok"] == t["checks"],
            # the kernels phase timed the mma_sync body on this list
            "mma_sync_list_as_timed": name != MULTIRES or {
                k: n for k, n in calls.items() if k[3] % 8}
            == MULTIRES_S2D_CONVS,
            "f32_vs_plain_mode_within_1e-3": d_plain <= ZOO_F32_TOL,
            "f32_vs_cpu_within_1e-3": d_cpu <= ZOO_F32_TOL,
            "f32_prob_std_over_10x_tol": std >= 10 * ZOO_F32_TOL,
        }
        out["eval"][name] = row
        bad = [c for c, ok in row["checks"].items() if not ok]
        if bad:
            failures.append({name: bad})
        print(f"[s2d] {name} s2d eval: launches {launches}, bodies {bodies} "
              f"(expected {want_bodies}); {row['images_per_s']:.2f} images/s"
              f" (plain mode in zoo_eval {row['images_per_s_plain']:.2f}); "
              f"device busy {row['device_ms_total']:.2f} ms, idle share "
              f"{row['device_idle_share']:.3f}, top "
              f"{[(r['name'][:40], round(r['device_ms'], 2)) for r in row['top'][:4]]}; peak "
              f"{peak / 2**20:.0f} MiB (plain {peak_plain / 2**20:.0f}); "
              f"kernel 1 per 16-patch forward: s2d list {t['ms']:.2f} ms "
              f"({t['flops'] / t['ms'] / 1e9:.1f} TFLOP/s), plain list "
              f"{tp['ms']:.2f} ms, cuDNN on the s2d list "
              f"{t['library_ms']:.2f} ms, bound {t['bound_ms']:.2f} ms "
              f"(s2d ops) / {tp['bound_ms']:.2f} ms (plain ops); kernel vs "
              f"plain {t['checks_ok']}/{t['checks']} shapes; f32 vs plain "
              f"mode {d_plain:.2e}, vs CPU {d_cpu:.2e}, std {std:.3e}"
              + (f"; FAILED {bad}" if bad else ""), flush=True)
        del plain, model, res
        torch.cuda.empty_cache()

    # 2. Training: two short epochs of train_arrays with s2d (FRUNet) and
    # with remat (UNet), then the step's ms and peak memory each way.
    t_images, t_masks, t_labels = synthetic_drive(TRAIN_IMAGES, IMG_H, IMG_W,
                                                  seed=5)
    os.makedirs(os.path.join(ROOT, "build", "chip_smoke"), exist_ok=True)
    runs = {}
    for name, kwargs, remat in (("FRUNet.FRUNet", {"s2d": True}, False),
                                ("UNet.UNet", {}, True)):
        model = create_model(name, **kwargs)
        reset_parameters(model, torch.Generator().manual_seed(6))
        res, launches, bodies = counted(lambda: train_arrays(
            model, t_images, t_masks, t_labels, model_name=name,
            model_kwargs=kwargs, steps=S2D_TRAIN_STEPS,
            batch_size=TRAIN_BATCH, learning_rate=TRAIN_LR,
            val_percent=TRAIN_VAL, patch_size=TRAIN_PATCH, seed=0,
            save_path=os.path.join(ROOT, "build", "chip_smoke", "s2d.pt"),
            compute_dtype=torch.bfloat16, max_epochs=TRAIN_EPOCHS,
            visualize=False, remat=remat, device=dev))
        hist = res["history"]
        key = f"{name} ({'remat' if remat else 's2d'} train_arrays)"
        conv_by_model[key] = bodies
        runs[key] = {"history": hist, "launches": launches}
        ok = (len(hist) == TRAIN_EPOCHS
              and all(math.isfinite(r["loss"]) for r in hist)
              and all(r["skipped_steps"] == 0 for r in hist)
              and launches["dice_sums"] >= TRAIN_EPOCHS)
        if not ok:
            failures.append({key: hist})
        print(f"[s2d] train_arrays {key}: losses "
              f"{[round(r['loss'], 5) for r in hist]}, skipped "
              f"{[r['skipped_steps'] for r in hist]}, launches {launches}",
              flush=True)
        del model
    g = torch.Generator(device=dev).manual_seed(8)
    imgs = torch.rand((TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH, 3),
                      generator=g, device=dev)
    labs = (torch.rand((TRAIN_BATCH, TRAIN_PATCH, TRAIN_PATCH, 1),
                       generator=g, device=dev) > 0.8).float()
    steps = {}
    for name, kwargs, remat in (
            ("FRUNet.FRUNet", {}, False), ("FRUNet.FRUNet", {"s2d": True},
                                           False),
            ("MultiResUNet.MultiResUNet", {}, False),
            ("MultiResUNet.MultiResUNet", {"s2d": True}, False),
            ("UNet.UNet", {}, False), ("UNet.UNet", {}, True)):
        model = create_model(name, **kwargs)
        reset_parameters(model, torch.Generator().manual_seed(9))
        model = model.to(device=dev, memory_format=torch.channels_last)
        ms, peak, base = step_ms_and_peak(model, (imgs, labs), remat=remat)
        mode = "remat" if remat else ("s2d" if kwargs else "plain")
        steps[f"{name} {mode}"] = {"ms_per_step": ms, "peak_bytes": peak,
                                   "peak_over_start_bytes": peak - base}
        del model
        torch.cuda.empty_cache()
    for key, r in steps.items():
        print(f"[s2d] train step {key} (batch {TRAIN_BATCH}, "
              f"{TRAIN_PATCH}^2, bf16): {r['ms_per_step']:.2f} ms, peak "
              f"{r['peak_bytes'] / 2**30:.3f} GiB "
              f"({r['peak_over_start_bytes'] / 2**30:.3f} over the start)",
              flush=True)

    # One f32 step with and without remat from the same UNet: parameters,
    # BN statistics and batch counts agree (BN updated once per step).
    # RMSprop's first step moves each weight by lr * 10 * sign(grad), so
    # cuDNN runs deterministic algorithms here: a weight whose gradient is
    # near 0 would otherwise take either sign in the two runs.
    base_model = create_model("UNet.UNet")
    reset_parameters(base_model, torch.Generator().manual_seed(10))
    after = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (False, True):
            m = copy.deepcopy(base_model).to(
                device=dev, memory_format=torch.channels_last)
            st = TrainState(m.train(), make_optimizer(m.parameters(), 1e-4))
            loss, ok = make_batch_step_fn(n_classes=1, remat=remat)(
                st, imgs[:8], labs[:8])
            if not ok:
                raise AssertionError("the f32 remat comparison step skipped")
            after.append({k: v.detach().clone()
                          for k, v in m.state_dict().items()})
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    remat_diff = max(float((after[0][k].double() - after[1][k].double())
                           .abs().max()) for k in after[0])
    tracked = {int(v) for k, v in after[1].items()
               if k.endswith("num_batches_tracked")}
    if remat_diff > 1e-5 or tracked != {1}:
        failures.append({"remat_vs_plain": [remat_diff, sorted(tracked)]})
    print(f"[s2d] remat f32 step vs plain step: max |d state| "
          f"{remat_diff:.2e} (tolerance 1e-5), num_batches_tracked "
          f"{sorted(tracked)}", flush=True)
    del base_model, after

    # 3. --resume from a JAX --latest-path file: the optimizer state the
    # trainer restores against the file's, then two steps on the card.
    model, config = ckpt.load_model_any(JAX_LATEST, dev)
    name = config["model_name"]
    opt = make_optimizer(model.parameters(), TRAIN_LR)
    extra = ckpt.resume_state(JAX_LATEST, name, model, opt)
    opt.load_state_dict(extra["optimizer"])
    raw = ckpt.read_jax_ckpt(JAX_LATEST)
    opt_state = ckpt.load_extra(JAX_LATEST)["opt_state"]
    inner = opt_state["inner_state"]
    want = {f: state_dict_from_jax(name, {
        "params": next(e[f] for e in inner.values() if f in e),
        "batch_stats": raw["batch_stats"]}) for f in ("nu", "trace")}
    restored_ok = all(
        torch.equal(opt.state[p]["square_avg"].cpu(), want["nu"][n])
        and torch.equal(opt.state[p]["momentum_buffer"].cpu(),
                        want["trace"][n])
        and opt.state[p]["square_avg"].device == p.device
        for n, p in model.named_parameters())
    lr_ok = math.isclose(opt.param_groups[0]["lr"], float(
        opt_state["hyperparams"]["learning_rate"]))
    step = make_batch_step_fn(n_classes=1)
    r_imgs = imgs[:2, :32, :32]
    r_labs = labs[:2, :32, :32]
    losses = [step(TrainState(model.train(), opt), r_imgs, r_labs)
              for _ in range(2)]
    steps_after = sorted({float(s["step"]) for s in opt.state.values()})
    crop = (slice(0, 4), slice(IMG_H // 2 - 64, IMG_H // 2 + 64),
            slice(IMG_W // 2 - 64, IMG_W // 2 + 64))
    res, launches, bodies = counted(lambda: train_arrays(
        ckpt.load_model_any(JAX_LATEST, dev)[0], t_images[crop],
        t_masks[crop], t_labels[crop], model_name=name,
        model_kwargs=config["model_kwargs"], steps=2, batch_size=2,
        val_percent=0.5, patch_size=32, seed=0,
        save_path=os.path.join(ROOT, "build", "chip_smoke", "resumed.pt"),
        compute_dtype=torch.float32, max_epochs=2, visualize=False,
        resume_from=JAX_LATEST, device=dev))
    conv_by_model[f"{name} (resumed train_arrays)"] = bodies
    resume_ok = (restored_ok and lr_ok
                 and all(ok and math.isfinite(float(v)) for v, ok in losses)
                 # 2 + 2 steps for every parameter: the unused output_OD
                 # head steps with a zero gradient, as optax steps it
                 and steps_after == [4.0]
                 and [r["epoch"] for r in res["history"]] == [2])
    if not resume_ok:
        failures.append({"resume": [restored_ok, lr_ok, steps_after,
                                    res["history"]]})
    print(f"[s2d] resume from {os.path.basename(JAX_LATEST)} ({name}): "
          f"RMSprop state equal to the file's {restored_ok}, lr "
          f"{opt.param_groups[0]['lr']:.1e} ({lr_ok}); two steps on the "
          f"card, losses {[round(float(v), 5) for v, _ in losses]}, steps "
          f"{steps_after}; train_arrays(resume_from=...) ran epochs "
          f"{[r['epoch'] for r in res['history']]}, launches {launches}",
          flush=True)

    out.update({"train_runs": runs, "train_steps": steps,
                "remat_f32_max_abs_diff": remat_diff,
                "resume": {"restored_equal": restored_ok, "lr_ok": lr_ok,
                           "steps_after": steps_after,
                           "history": res["history"]}})
    report["s2d"] = out
    state["s2d_launches"] = launches_sum
    state["s2d_conv_launches"] = conv_by_model
    state["conv_bodies"]["s2d"] = {
        b: sum(m.get(b, 0) for m in conv_by_model.values())
        for b in sorted({b for m in conv_by_model.values() for b in m})}
    by_body = sum(state["conv_bodies"]["s2d"].values())
    if by_body != launches_sum["conv3x3_affine_relu"]:
        failures.append({"launches_by_body": [
            by_body, launches_sum["conv3x3_affine_relu"]]})
    if failures:
        raise AssertionError(f"s2d checks failed: {failures}")


# The export phase: the serving artifact of export_checkpoint's defaults
# (batch 32, patch 512, bf16) on 8 synthetic DRIVE-geometry images (32
# patches of 512^2), loaded in a fresh process; the f32 check's patches;
# the other models exported at batch 2 of 128^2 in f32, with their kernel-1
# launches per call of the exported program (EXPORT_MODELS: registry name,
# s2d, launches); the bf16 tolerance against the eager Predictor (the same
# kernels with the same plans: 0 expected) and the f32 one (summation
# order only).
EXPORT_IMAGES, EXPORT_BATCH = 8, 32
EXPORT_F32_PATCHES, EXPORT_F32_HW, EXPORT_F32_TOL = 2, 128, 1e-5
EXPORT_BF16_TOL = 1e-3
EXPORT_MODELS = [("SegNet.SegNet", False, 26),
                 ("RetinaLiteNet.TransFuseNet", False, 6),
                 ("FRUNet.FRUNet", True, 44),
                 ("UNetPP.NestedUNet", True, 30)]
EXPORT_DIR = os.path.join(ROOT, "build", "chip_smoke_export")
EXPORT_BLOCKED = ("jax", "jaxlib", "flax", "jcfszxc_unet_tpu")


def export_child(workdir: str) -> None:
    """``python3 chip_smoke.py --export-child DIR``: load ``DIR/unet.pt2``
    in this fresh process (torch and the port only), run it on
    ``DIR/patches.npy`` in bf16 and save its probabilities, time it against
    the eager ``Predictor`` of ``DIR/unet.pt`` in turns, and print one JSON
    line of the results."""
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from jcfszxc_unet_tpu_torch.eval.export import load_exported
    from jcfszxc_unet_tpu_torch.eval.predictor import Predictor

    t0 = time.perf_counter()
    with open(os.path.join(workdir, "unet.pt2"), "rb") as f:
        fn = load_exported(f.read())
    load_s = time.perf_counter() - t0
    x = torch.from_numpy(np.load(os.path.join(workdir, "patches.npy"))).to(
        "cuda", torch.bfloat16)
    fn(x)
    reset_counts()
    y = fn(x)
    torch.cuda.synchronize()
    launches, bodies = launch_counts()
    np.save(os.path.join(workdir, "probs.npy"), y.float().cpu().numpy())
    eager = Predictor.from_checkpoint(os.path.join(workdir, "unet.pt"),
                                      device="cuda", patch_size=PATCH,
                                      inference_batch_size=EXPORT_BATCH)
    times = {"program": [], "eager": []}
    for name in ("program", "eager", "eager", "program"):
        run = fn if name == "program" else eager.predict_patches
        times[name].append(host_ms(lambda: run(x), reps=5))
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in EXPORT_BLOCKED)
    print(json.dumps({"load_s": load_s, "launches": launches,
                      "bodies": bodies, "ms_per_call": times,
                      "modules_not_allowed": loaded,
                      "device": torch.cuda.get_device_name(0)}), flush=True)


def phase_export(report, state):
    """``eval.export``: export_checkpoint at its defaults on the full-width
    UNet, the artifact loaded in a fresh process, f32 checks, four more
    models, the s2d cache after an export, and the host cost of the
    operator dispatch."""
    import numpy as np
    import torch

    from jcfszxc_unet_tpu_torch.data.sampler import (
        build_grid_sample_map,
        extract_patches,
    )
    from jcfszxc_unet_tpu_torch.eval.export import (
        export_checkpoint,
        export_forward,
        export_program,
        load_exported,
    )
    from jcfszxc_unet_tpu_torch.eval.predictor import Predictor
    from jcfszxc_unet_tpu_torch.models import with_kwargs
    from jcfszxc_unet_tpu_torch.ops import s2d
    from jcfszxc_unet_tpu_torch.scripts import op_dispatch_cost
    from jcfszxc_unet_tpu_torch.train import checkpoint as ckpt

    dev = torch.device("cuda")
    shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    os.makedirs(EXPORT_DIR)
    out = {"checks": {}}
    checks = out["checks"]
    launches_sum = {"conv3x3_affine_relu": 0, "dice_sums": 0,
                    "conv3x3_relu_imcol": 0}

    def counted(fn):
        """fn() on the export path (a loaded program), its launches read
        around it and summed."""
        reset_counts()
        res = fn()
        torch.cuda.synchronize()
        launches, bodies = launch_counts()
        for key in launches_sum:
            launches_sum[key] += launches[key]
        return res, launches, bodies

    try:
        # 1. export_checkpoint at its defaults on the full-width UNet.
        model = build_model(dev, seed=60)
        ckpt_path = os.path.join(EXPORT_DIR, "unet.pt")
        art = os.path.join(EXPORT_DIR, "unet.pt2")
        ckpt.save_model(ckpt_path, "UNet.UNet", {}, model)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        export_checkpoint(ckpt_path, art, batch_size=EXPORT_BATCH,
                          patch_size=PATCH, compute_dtype=torch.bfloat16,
                          device="cuda")
        out["export_seconds"] = time.perf_counter() - t0
        out["artifact_bytes"] = os.path.getsize(art)
        images, _, _ = synthetic_drive(EXPORT_IMAGES, IMG_H, IMG_W, seed=61)
        centers = build_grid_sample_map(EXPORT_IMAGES, IMG_H, IMG_W,
                                        PATCH // 2)
        patches = extract_patches(torch.as_tensor(images, device=dev),
                                  centers, PATCH)
        checks["patches_32"] = patches.shape[0] == EXPORT_BATCH
        np.save(os.path.join(EXPORT_DIR, "patches.npy"),
                patches.cpu().numpy())

        # 2. Load in a fresh process: torch and the port only.
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--export-child",
             EXPORT_DIR], capture_output=True, text=True, timeout=300,
            cwd=ROOT)
        out["child_seconds"] = time.perf_counter() - t0
        if child.returncode != 0:
            raise RuntimeError(f"export child failed:\n{child.stderr[-4000:]}")
        res = json.loads(child.stdout.strip().splitlines()[-1])
        out["child"] = res
        for key in launches_sum:  # the child's one counted program call
            launches_sum[key] += res["launches"][key]
        eager = Predictor(model, compute_dtype=torch.bfloat16,
                          patch_size=PATCH, inference_batch_size=EXPORT_BATCH,
                          device="cuda")
        want = eager.predict_patches(patches.to(torch.bfloat16))
        got = torch.from_numpy(np.load(os.path.join(EXPORT_DIR,
                                                    "probs.npy"))).to(dev)
        out["bf16_max_abs_dprob"] = float((got - want).abs().max())
        out["bf16_prob_std"] = float(want.std())
        checks["child_without_jax"] = res["modules_not_allowed"] == []
        checks["child_18_launches_per_call"] = res["launches"] == {
            "conv3x3_affine_relu": 18, "dice_sums": 0,
            "conv3x3_relu_imcol": 0}
        checks["child_bodies_17_wgmma_1_mma_sync"] = res["bodies"] == {
            "wgmma": 17, "mma_sync": 1}
        checks["bf16_within_1e-3_of_eager"] = (
            out["bf16_max_abs_dprob"] <= EXPORT_BF16_TOL)
        ms = {k: sum(v) / len(v) for k, v in res["ms_per_call"].items()}
        out["images_per_s"] = {k: EXPORT_IMAGES / (v / 1e3)
                               for k, v in ms.items()}
        del got, want

        # 3. f32, TF32 off: the program against the eager forward and the
        # forward built from the plain versions.
        f32 = patches[:EXPORT_F32_PATCHES, :EXPORT_F32_HW,
                      :EXPORT_F32_HW].float().contiguous()
        fn = load_exported(export_forward(
            model, EXPORT_F32_PATCHES, EXPORT_F32_HW,
            compute_dtype=torch.float32, device="cuda"))
        got, launches, _ = counted(lambda: fn(f32))
        eager_f32 = Predictor(model, compute_dtype=torch.float32,
                              device="cuda").predict_patches(f32)
        with torch.inference_mode():
            plain = torch.sigmoid(plain_unet_forward(
                model, f32.permute(0, 3, 1, 2)).float()).permute(0, 2, 3, 1)
        out["f32"] = {"max_abs_dprob_eager": float((got - eager_f32).abs()
                                                   .max()),
                      "max_abs_dprob_plain": float((got - plain).abs().max()),
                      "prob_std": float(plain.std()),
                      "launches": launches["conv3x3_affine_relu"]}
        checks["f32_within_1e-5_of_eager"] = (
            out["f32"]["max_abs_dprob_eager"] <= EXPORT_F32_TOL)
        checks["f32_within_1e-3_of_plain"] = (
            out["f32"]["max_abs_dprob_plain"] <= 1e-3)
        checks["f32_18_launches"] = out["f32"]["launches"] == 18
        del model, eager, fn

        # 4. Other models at batch 2 of 128^2 in f32; each s2d model's
        # eager forward after its export equal to the one before it.
        out["models"] = {}
        for k, (name, s2d_mode, n_conv) in enumerate(EXPORT_MODELS):
            m = build_model(dev, seed=62 + k, name=name)
            if s2d_mode:
                m = with_kwargs(m, name, {"s2d": True}).eval()
            pred = Predictor(m, compute_dtype=torch.float32, device="cuda")
            before = pred.predict_patches(f32)
            if s2d_mode:
                s2d._selector_tensor.cache_clear()
            t0 = time.perf_counter()
            program = export_program(m, EXPORT_F32_PATCHES, EXPORT_F32_HW,
                                     compute_dtype=torch.float32,
                                     device="cuda").module()
            seconds = time.perf_counter() - t0

            def run_program():
                with torch.inference_mode():
                    return program(f32)

            got, launches, _ = counted(run_program)
            after = pred.predict_patches(f32)
            row = {"s2d": s2d_mode, "export_seconds": seconds,
                   "launches": launches["conv3x3_affine_relu"],
                   "max_abs_dprob_eager": float((got - before).abs().max()),
                   "prob_std": float(before.std()),
                   "eager_after_export_max_abs_diff": float(
                       (after - before).abs().max())}
            ok = (row["launches"] == n_conv
                  and row["max_abs_dprob_eager"] <= EXPORT_F32_TOL)
            if s2d_mode:  # the selector's cache stayed real: the same maps
                row["eager_after_export_equal"] = bool(
                    type(after) is torch.Tensor and torch.equal(after, before))
                ok = ok and row["eager_after_export_equal"]
            out["models"][name + (" (s2d)" if s2d_mode else "")] = row
            checks[f"{name}{' s2d' if s2d_mode else ''}_ok"] = ok
            del m, pred, program

        # 5. Host cost of the operator dispatch against the direct launch.
        out["dispatch_us_per_call"] = op_dispatch_cost.measure(passes=120)
    finally:
        shutil.rmtree(EXPORT_DIR, ignore_errors=True)
    state["export_launches"] = launches_sum
    report["export"] = out
    print(f"[export] export_checkpoint UNet B{EXPORT_BATCH} {PATCH}^2 bf16: "
          f"{out['export_seconds']:.2f} s, {out['artifact_bytes']} bytes; "
          f"child (torch + port) load {res['load_s']:.2f} s, "
          f"{res['launches']['conv3x3_affine_relu']} conv launches per "
          f"call {res['bodies']}; "
          f"max |dprob| vs eager {out['bf16_max_abs_dprob']:.3e}", flush=True)
    print(f"[export] images/s program {out['images_per_s']['program']:.2f} "
          f"vs eager {out['images_per_s']['eager']:.2f}; f32 vs eager "
          f"{out['f32']['max_abs_dprob_eager']:.3e}, vs plain "
          f"{out['f32']['max_abs_dprob_plain']:.3e}", flush=True)
    for name, row in out["models"].items():
        print(f"[export] {name}: {row['launches']} launches, f32 vs eager "
              f"{row['max_abs_dprob_eager']:.3e} (std "
              f"{row['prob_std']:.3f}), eager after export vs before "
              f"{row['eager_after_export_max_abs_diff']:.3e}"
              + (f" (equal {row['eager_after_export_equal']})"
                 if row["s2d"] else ""), flush=True)
    d = out["dispatch_us_per_call"]
    print("[export] host us per conv call (UNet's 18; median, and the "
          "medians of its two blocks): " + "; ".join(
              f"{mode} " + ", ".join(
                  f"{v} {d[mode][v]:.1f} "
                  f"({'/'.join(f'{b:.1f}' for b in d[mode]['blocks'][v])})"
                  for v in ("direct", "library"))
              for mode in ("inference_mode", "no_grad")), flush=True)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"export checks failed: {bad}")


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
    schedules = dict(conv_imcol.counter.schedules)

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
    report["probe"] = {"launches": launches, "bodies": bodies,
                       "schedules": schedules, "run": res,
                       "checks": checks, "times": times}
    n_ok = sum(c["ok"] for c in checks)
    print(f"[probe] imcol kernel vs plain: {n_ok}/{len(checks)} cases within "
          f"1e-2 (bf16) / 1e-4 (f32) of max|plain|; launches on the probe "
          f"path {launches} ({bodies}, {schedules})", flush=True)
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
        "launches_by_schedule": {"probe": schedules},
        "max_abs_err": max(c["max_abs_err"] for c in checks
                           if c["dtype"] == "bfloat16"),
        "ms": times["ms"], "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"], "bound_by": times["bound_by"],
        "library_ms": times["library_ms"]}


def md_train_inputs():
    """The train path's 8 synthetic DRIVE-geometry images (seed 1), and
    MULTI_F32_STEPS global batches of TRAIN_BATCH patches of TRAIN_PATCH^2
    cut from them at seeded random centers."""
    import numpy as np

    images, masks, labels = synthetic_drive(TRAIN_IMAGES, IMG_H, IMG_W,
                                            seed=1)
    rng = np.random.RandomState(MULTI_SEED)
    half = TRAIN_PATCH // 2
    batches = []
    for _ in range(MULTI_F32_STEPS):
        idx = rng.randint(TRAIN_IMAGES, size=TRAIN_BATCH)
        ys = rng.randint(half, IMG_H - half, size=TRAIN_BATCH)
        xs = rng.randint(half, IMG_W - half, size=TRAIN_BATCH)
        cut = [(i, slice(y - half, y + half), slice(x - half, x + half))
               for i, y, x in zip(idx, ys, xs)]
        batches.append((np.stack([images[i, r, c] for i, r, c in cut]),
                        np.stack([labels[i, r, c, None] for i, r, c in cut])))
    return batches, (images, masks, labels)


def phase_multi_device(report, state):
    """MULTI_RANKS ranks of the port's data-parallel path
    (``parallel.spawn`` of ``parallel.jobs.run``) against the port in this
    process: f32 train steps, a bf16 ``train_arrays`` run with
    validation, and tiled evaluation with the patch grid split over the
    ranks.  On one card the ranks share it over gloo (NCCL refuses two
    ranks on one device); with two cards they take one each over NCCL."""
    import numpy as np
    import torch

    from jcfszxc_unet_tpu_torch.eval.metrics import binary_dice
    from jcfszxc_unet_tpu_torch.parallel import jobs, spawn
    from jcfszxc_unet_tpu_torch.train.checkpoint import load_model

    two_cards = torch.cuda.device_count() >= MULTI_RANKS
    device, backend = (("cuda", "nccl") if two_cards
                       else ("cuda:0", "gloo"))
    print(f"[multi_device] {MULTI_RANKS} ranks on {device} over {backend} "
          f"(backend passed by name), timeout {MULTI_TIMEOUT_S:.0f} s",
          flush=True)
    batches, (images, masks, labels) = md_train_inputs()
    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_multi")
    os.makedirs(ckpt_dir, exist_ok=True)
    save_path = os.path.join(ckpt_dir, "best_model.pt")
    if os.path.exists(save_path):
        os.remove(save_path)
    steps = dict(model_name="UNet.UNet", batches=batches, lr=TRAIN_LR,
                 seed=2, compute_dtype=torch.float32)
    tiled = dict(model_name="UNet.UNet", images=state["images"],
                 patch_size=PATCH, batch_size=INFER_BATCH,
                 state_dict=jobs.numpy_state(state["model"]))
    tasks = [
        ("configure", dict(tf32=False)),
        ("train_steps", steps),
        ("tiled_maps", dict(tiled, compute_dtype=torch.float32)),
        ("tiled_maps", dict(tiled, compute_dtype=torch.bfloat16)),
        ("train_run", dict(
            model_name="UNet.UNet", images=images, masks=masks,
            labels=labels, save_path=save_path, seed=2, steps=MULTI_STEPS,
            batch_size=TRAIN_BATCH, learning_rate=TRAIN_LR,
            val_percent=TRAIN_VAL, patch_size=TRAIN_PATCH,
            compute_dtype=torch.bfloat16, max_epochs=MULTI_EPOCHS,
            visualize=False)),
    ]
    torch.cuda.empty_cache()  # the ranks allocate on the same card
    t0 = time.perf_counter()
    per_rank = spawn(jobs.run, MULTI_RANKS, tasks, device=device,
                     backend=backend, timeout_s=MULTI_TIMEOUT_S,
                     join_timeout_s=MULTI_JOIN_S)
    spawn_s = time.perf_counter() - t0
    state.setdefault("f32_rank_launches", {})["multi_device"] = \
        rank_f32_launches(tasks, per_rank)
    single = jobs.train_steps(None, device="cuda", **steps)
    maps32 = jobs.tiled_maps(None, device="cuda",
                             **dict(tiled, compute_dtype=torch.float32))
    maps16 = jobs.tiled_maps(None, device="cuda",
                             **dict(tiled, compute_dtype=torch.bfloat16))

    st = [r[1] for r in per_rank]
    loss_rel = max(abs(a - b) / abs(b)
                   for a, b in zip(st[0]["losses"], single["losses"]))

    def excess(got, want, rtol, atol, running):
        """max over the keys of |got - want| - (atol + rtol |want|)."""
        return max(float((np.abs(got[k] - v) - atol - rtol * np.abs(v))
                         .max())
                   for k, v in want.items()
                   if ("running" in k) == running
                   and not k.endswith("num_batches_tracked"))

    # The running statistics after the first step, which both runs take
    # from the same parameters: after it, the parameters differ by the
    # RMSprop-amplified noise of near-zero gradients (held by the params
    # bound below), which moves later batch means by ~1e-5.
    stats_excess = excess(st[0]["first_stats"], single["first_stats"], 1e-4,
                          1e-6, True)
    param_excess = excess(st[0]["state"], single["state"], 1e-3, 5e-5,
                          False)
    d32 = float(np.abs(per_rank[0][2]["maps"] - maps32["maps"]).max())
    d16 = float(np.abs(per_rank[0][3]["maps"] - maps16["maps"]).max())
    lab = torch.from_numpy(state["labels"])

    def dice(maps):
        pred = torch.from_numpy(
            (maps * state["masks"] > 0.5).astype(np.float32))
        return binary_dice(pred, lab).numpy()

    dice16 = float(np.abs(dice(per_rank[0][3]["maps"])
                          - dice(maps16["maps"])).max())
    runs = [r[4] for r in per_rank]
    reloaded, _ = load_model(save_path, device="cuda")  # strict=True
    del reloaded
    os.remove(save_path)
    launches = [{k: sum(t["launches"][k] for t in r) for k in r[0]["launches"]}
                for r in per_rank]
    state["multi_device_launches"] = {
        k: sum(rank[k] for rank in launches) for k in launches[0]}
    hist = runs[0]["history"]
    val_dprob = [r["val_max_abs_dprob"] for r in runs]
    checks = {
        "f32_losses_within_1e-4_rel": loss_rel <= 1e-4,
        "f32_step1_bn_stats_within_rtol_1e-4_atol_1e-6":
            stats_excess <= 0.0,
        "f32_params_within_rtol_1e-3_atol_5e-5": param_excess <= 0.0,
        "f32_params_bit_identical_across_ranks":
            len({s["digest"] for s in st}) == 1,
        "f32_no_step_skipped": all(all(s["oks"]) for s in st),
        "tiled_f32_within_1e-5": d32 <= 1e-5,
        "tiled_bf16_dice_within_1e-3": dice16 <= 1e-3,
        "tiled_maps_equal_on_every_rank": all(
            np.array_equal(r[t]["maps"], per_rank[0][t]["maps"])
            for r in per_rank for t in (2, 3)),
        "train_run_rank0_alone_wrote_the_checkpoint":
            runs[0]["saved"] == [save_path]
            and all(r["saved"] == [] for r in runs[1:]),
        "train_run_val_probs_bit_identical_across_ranks":
            len({r["val_digest"] for r in runs}) == 1,
        f"train_run_val_probs_within_{MULTI_VAL_DPROB:g}_of_one_process":
            max(val_dprob) <= MULTI_VAL_DPROB,
        "train_run_val_dice_equal_on_every_rank": all(
            [h["dice"] for h in r["history"]]
            == [h["dice"] for h in hist] for r in runs),
        "train_run_params_bit_identical_across_ranks":
            len({r["digest"] for r in runs}) == 1,
        "train_run_losses_finite_none_skipped": all(
            math.isfinite(h["loss"]) and h["skipped_steps"] == 0
            for h in hist) and len(hist) == MULTI_EPOCHS,
        "conv_and_dice_launched_in_every_rank": all(
            rank["conv3x3_affine_relu"] > 0 and rank["dice_sums"] > 0
            for rank in launches),
    }
    f32_ms = st[0]["step_ms"][1:]
    bf16_ms = hist[-1]["train_seconds"] * 1e3 / MULTI_STEPS
    report["multi_device"] = {
        "ranks": MULTI_RANKS, "device": device, "backend": backend,
        "timeout_s": MULTI_TIMEOUT_S, "spawn_seconds": spawn_s,
        "f32_losses": st[0]["losses"], "f32_single_losses": single["losses"],
        "f32_loss_max_rel": loss_rel, "f32_stats_excess": stats_excess,
        "f32_param_excess": param_excess, "f32_step_ms": st[0]["step_ms"],
        "f32_single_step_ms": single["step_ms"],
        "tiled_f32_max_abs_dprob": d32, "tiled_bf16_max_abs_dprob": d16,
        "tiled_bf16_max_abs_ddice": dice16,
        "tiled_ms": [r[3]["ms"] for r in per_rank],
        "tiled_single_ms": maps16["ms"],
        "train_run_history": hist, "train_run_step_ms": bf16_ms,
        "train_run_val_max_abs_dprob": val_dprob,
        "train_run_val_range": runs[0]["val_range"],
        "launches_by_rank": launches, "checks": checks}
    print(f"[multi_device] f32 UNet {MULTI_F32_STEPS} steps at global batch "
          f"{TRAIN_BATCH}, {TRAIN_PATCH}^2: losses {st[0]['losses']} vs one "
          f"process {single['losses']} (max rel {loss_rel:.2e}); step-1 BN "
          f"stats excess {stats_excess:.2e}, params excess "
          f"{param_excess:.2e}; "
          f"ranks bit-identical "
          f"{checks['f32_params_bit_identical_across_ranks']}", flush=True)
    print(f"[multi_device] tiled eval, {len(state['images'])} images "
          f"sharded {MULTI_RANKS} ways: f32 max |dprob| {d32:.2e}, bf16 max "
          f"|dprob| {d16:.2e}, bf16 max |dDice| {dice16:.2e}", flush=True)
    print(f"[multi_device] train_arrays bf16 {MULTI_EPOCHS} x {MULTI_STEPS} "
          f"steps: val dice {[h['dice'] for h in hist]} on every rank; last "
          f"val probabilities in [{runs[0]['val_range'][0]:.4f}, "
          f"{runs[0]['val_range'][1]:.4f}], the same bits on every rank "
          f"{checks['train_run_val_probs_bit_identical_across_ranks']}, max "
          f"|dprob| against one process {max(val_dprob):.2e} (bound "
          f"{MULTI_VAL_DPROB:g}); rank 0 wrote {runs[0]['saved']}",
          flush=True)
    how = (f"{backend}, one card a rank" if two_cards
           else f"{backend} through host memory on one card")
    print(f"[multi_device] path check, not a speed ({how}): f32 step ms "
          f"{[round(t, 2) for t in f32_ms]} (one process "
          f"{[round(t, 2) for t in single['step_ms'][1:]]}), bf16 step ms "
          f"{bf16_ms:.2f}; spawn + jobs {spawn_s:.1f} s; launches per rank "
          f"{launches}", flush=True)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"multi_device checks failed: {bad}")


def phase_spatial_sharded(report, state):
    """The whole-image forward with the rows of each padded image sharded
    over MULTI_RANKS ranks (``parallel.jobs`` ``spatial_eval`` and
    ``spatial_maps`` in ranks spawned as in ``multi_device``) against
    ``predict_spatial`` in this process on the same images, padded the
    same way."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from jcfszxc_unet_tpu_torch.cli.evaluate import evaluate_arrays
    from jcfszxc_unet_tpu_torch.eval.metrics import binary_dice
    from jcfszxc_unet_tpu_torch.eval.predictor import Predictor
    from jcfszxc_unet_tpu_torch.parallel import jobs, spawn

    two_cards = torch.cuda.device_count() >= MULTI_RANKS
    device, backend = (("cuda", "nccl") if two_cards
                       else ("cuda:0", "gloo"))
    dev = torch.device("cuda")
    n = SPATIAL_IMAGES
    images, masks, labels = (state[k][:n]
                             for k in ("images", "masks", "labels"))
    tfn_model = build_model(dev, seed=9, name=SPATIAL_TFN)
    unet = jobs.numpy_state(state["model"])
    ev = dict(model_name="UNet.UNet", images=images, masks=masks,
              labels=labels, state_dict=unet, batch_size=INFER_BATCH,
              repeats=SPATIAL_REPEATS)
    tasks = [
        ("configure", dict(tf32=False)),
        ("spatial_eval", dict(ev, compute_dtype=torch.float32)),
        ("spatial_eval", dict(ev, compute_dtype=torch.bfloat16)),
        ("spatial_maps", dict(model_name=SPATIAL_TFN, images=images,
                              state_dict=jobs.numpy_state(tfn_model),
                              model_kwargs={"logit_head": True},
                              batch_size=INFER_BATCH)),
    ]
    print(f"[spatial_sharded] {MULTI_RANKS} ranks on {device} over "
          f"{backend}; {n} images of {IMG_H} x {IMG_W}", flush=True)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    per_rank = spawn(jobs.run, MULTI_RANKS, tasks, device=device,
                     backend=backend, timeout_s=MULTI_TIMEOUT_S,
                     join_timeout_s=MULTI_JOIN_S)
    spawn_s = time.perf_counter() - t0
    state.setdefault("f32_rank_launches", {})["spatial_sharded"] = \
        rank_f32_launches(tasks, per_rank)

    # This process, on the images padded as the ranks pad them (H to a
    # multiple of 32 x the ranks; predict_spatial pads W).
    hp = -(-IMG_H // (32 * MULTI_RANKS)) * 32 * MULTI_RANKS
    padded = F.pad(torch.from_numpy(images).to(dev),
                   (0, 0, 0, 0, 0, hp - IMG_H))
    fov = torch.from_numpy(masks).to(dev)
    lab = torch.from_numpy(labels).to(dev)

    def one_process(model, dtype):
        pred = Predictor(model, compute_dtype=dtype,
                         inference_batch_size=INFER_BATCH, device=dev)
        return pred.predict_spatial(padded)[:, :IMG_H]

    f32 = one_process(state["model"], torch.float32) * fov
    bf16 = one_process(state["model"], torch.bfloat16) * fov
    tfn = one_process(tfn_model, torch.float32)
    r32, r16 = (per_rank[0][t]["result"] for t in (1, 2))
    d32 = float(np.abs(r32["pred_maps"] - f32.cpu().numpy()).max())
    dice16 = binary_dice((bf16 > 0.5).float(), lab).cpu().numpy()
    ddice = float(np.abs(np.asarray(r16["dice"]) - dice16).max())
    dtfn = float(np.abs(per_rank[0][3]["maps"] - tfn.cpu().numpy()).max())

    # Kernel 1 at this path's shapes: every conv of a rank's forward is the
    # one-process conv at its padded shape with H / ranks + 2 rows (the
    # rank's slab and a halo row on each side).
    whole = record_convs(lambda: one_process(state["model"], torch.bfloat16))
    calls = {}
    for (b, h, w, cin, cout, relu), k in whole.items():
        key = (b, h // MULTI_RANKS + 2, w, cin, cout, relu)
        calls[key] = calls.get(key, 0) + k
    convs = {name: conv_list(calls, dtype, f"spatial_sharded_{name}")
             for name, dtype in (("bf16", torch.bfloat16),
                                 ("f32", torch.float32))}
    convs_whole = conv_list(whole, torch.bfloat16, "spatial_one_process")
    whole_n = convs_whole["total"]["n_convs"]
    # The slab each conv builds (``halo_slab``: the halo rows and the
    # rank's rows concatenated), in bf16, device ms per forward.
    copy_ms = 0.0
    for (b, h, w, cin, _, _), k in calls.items():
        rows = [torch.zeros((b, r, w, cin), device=dev, dtype=torch.bfloat16)
                for r in (1, h - 2, 1)]
        copy_ms += k * time_ms(lambda: torch.cat(rows, dim=1), 10.0)

    # One rank: the eval CLI's --spatial --devices 1 in this process (H
    # padded to 608), bf16, the second call timed, its peak above the
    # memory allocated before it.
    for _ in range(SPATIAL_REPEATS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        t1 = time.perf_counter()
        evaluate_arrays(state["model"], images, masks, labels,
                        inference_batch_size=INFER_BATCH,
                        compute_dtype=torch.bfloat16, spatial=True,
                        device=dev)
        torch.cuda.synchronize()
        one_ms = (time.perf_counter() - t1) * 1e3
    one_peak = torch.cuda.max_memory_allocated() - start

    launches = [{k: sum(t["launches"][k] for t in r) for k in r[0]["launches"]}
                for r in per_rank]
    state["spatial_sharded_launches"] = {
        k: sum(rank[k] for rank in launches) for k in launches[0]}
    ev_runs = 2 * SPATIAL_REPEATS  # f32 and bf16 evaluations, each repeated
    rank16 = [r[2] for r in per_rank]
    coll = [r["collectives"] for r in rank16]
    peaks = [r["peak_bytes"] - r["start_bytes"] for r in rank16]
    ms2 = max(r["ms"][-1] for r in rank16)
    pm = r16["pred_maps"]
    checks = {
        "f32_within_1e-5_of_one_process": d32 <= SPATIAL_F32_DPROB,
        "bf16_dice_within_1e-3_of_one_process":
            ddice <= SPATIAL_BF16_DDICE,
        "transfusenet_f32_within_1e-5_of_one_process":
            dtfn <= SPATIAL_F32_DPROB,
        "maps_shape_finite_in_0_1": pm.shape == (n, IMG_H, IMG_W)
            and bool(np.isfinite(pm).all() and pm.min() >= 0
                     and pm.max() <= 1),
        "transfusenet_maps_equal_on_every_rank": all(
            np.array_equal(r[3]["maps"], per_rank[0][3]["maps"])
            for r in per_rank),
        "rank0_alone_returns_metrics": all(
            r[t]["result"] == {} for r in per_rank[1:] for t in (1, 2)),
        "conv_launches_18_a_rank_a_unet_forward_6_a_transfusenet": all(
            rank["conv3x3_affine_relu"] == 18 * ev_runs + 6
            for rank in launches),
        "dice_on_rank0_alone": launches[0]["dice_sums"] == ev_runs
            and all(rank["dice_sums"] == 0 for rank in launches[1:]),
        "halo_exchanged_every_forward": all(c["calls"] > 18 for c in coll),
        "conv_list_kernel_vs_plain": all(
            c["total"]["checks_ok"] == c["total"]["checks"]
            for c in [*convs.values(), convs_whole]),
    }
    report["spatial_sharded"] = {
        "ranks": MULTI_RANKS, "device": device, "backend": backend,
        "n_images": n, "padded_hw": [hp, -(-IMG_W // 32) * 32],
        "spawn_seconds": spawn_s, "f32_max_abs_dprob": d32,
        "bf16_dice": r16["dice"], "bf16_dice_one_process": dice16.tolist(),
        "bf16_max_abs_ddice": ddice, "transfusenet_f32_max_abs_dprob": dtfn,
        "ms_per_image_2_ranks": ms2 / n, "ms_per_image_1_rank": one_ms / n,
        "ms_by_rank": [r["ms"] for r in rank16],
        "collectives_per_forward": coll,
        "f32_collectives_per_forward": [r[1]["collectives"]
                                        for r in per_rank],
        "transfusenet_collectives": per_rank[0][3]["collectives"],
        "peak_above_start_bytes_by_rank": peaks,
        "peak_above_start_bytes_one_process": one_peak,
        "conv_slab_shapes": [list(k) + [v] for k, v in sorted(calls.items())],
        "conv_per_forward": {k: c["total"] for k, c in convs.items()},
        "conv_per_forward_one_process_bf16": convs_whole["total"],
        "slab_copy_ms_per_forward_bf16": copy_ms,
        "conv_rows": {k: c["rows"] for k, c in convs.items()},
        "launches_by_rank": launches, "checks": checks}
    print(f"[spatial_sharded] UNet f32 max |dprob| {d32:.2e} (bound "
          f"{SPATIAL_F32_DPROB:g}); bf16 dice {[round(d, 4) for d in r16['dice']]}"
          f" vs one process {[round(float(d), 4) for d in dice16]} (max "
          f"|dDice| {ddice:.2e}); TransFuseNet f32 max |dprob| {dtfn:.2e}",
          flush=True)
    print(f"[spatial_sharded] bf16 ms per image: 2 ranks {ms2 / n:.2f}, "
          f"1 rank {one_ms / n:.2f}; collectives per forward (a rank) "
          f"{[c['calls'] for c in coll]}, host ms {[round(c['ms'], 2) for c in coll]}"
          f", bytes {[c['bytes'] for c in coll]}; peak above start MiB a "
          f"rank {[round(p / 2**20, 1) for p in peaks]} vs one process "
          f"{one_peak / 2**20:.1f}; spawn + jobs {spawn_s:.1f} s", flush=True)
    for name, c in convs.items():
        t = c["total"]
        print(f"[spatial_sharded] kernel 1 on the {t['n_convs']} slab convs "
              f"({name}): {t['ms']:.2f} ms, plain {t['plain_ms']:.2f}, "
              f"cuDNN {t['library_ms']:.2f}, bound {t['bound_ms']:.2f}; "
              f"kernel vs plain {t['checks_ok']}/{t['checks']} shapes",
              flush=True)
    print(f"[spatial_sharded] one process, the {whole_n} convs at the "
          f"same padding (bf16): kernel 1 {convs_whole['total']['ms']:.2f} "
          f"ms; the slabs' concatenation copies {copy_ms:.3f} ms a rank a "
          f"forward (bf16)", flush=True)
    print(f"[spatial_sharded] launches per rank {launches}", flush=True)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"spatial_sharded checks failed: {bad}")


def count_bodies_by_phase(state):
    """Tally kernel 1's launches in this process by phase and body, its
    checks and timing loops included, into ``state["phase_bodies"]``: the
    counter's ``add`` (called where the wrapper launches, and nowhere
    else) also adds to the tally of the phase that ``tally["phase"]``
    names.  Returns that control dict."""
    from jcfszxc_unet_tpu_torch.ops.kernels import conv_fused

    control = {"phase": None}
    by_phase = state.setdefault("phase_bodies", {})
    real_add = conv_fused.counter.add

    def add(body, schedule=None):
        real_add(body, schedule)
        row = by_phase.setdefault(control["phase"], {})
        row[body] = row.get(body, 0) + 1

    conv_fused.counter.add = add
    return control


def rank_f32_launches(tasks, per_rank):
    """Kernel 1's launches read in the ranks during the tasks whose compute
    dtype is float32, all ranks summed: every f32 call of kernel 1 takes
    the ``f32_box`` body (held in this process by the kernels phase)."""
    import inspect

    import torch

    from jcfszxc_unet_tpu_torch.parallel import jobs

    total = 0
    for i, (name, kwargs) in enumerate(tasks):
        param = inspect.signature(jobs.JOBS[name]).parameters.get(
            "compute_dtype")
        dtype = kwargs.get("compute_dtype",
                           param.default if param is not None else None)
        if dtype is torch.float32:
            total += sum(r[i]["launches"]["conv3x3_affine_relu"]
                         for r in per_rank)
    return total


def kernels_line(state):
    """The kernels of every path, each with its launches summed over the
    paths that ran it (and split by path)."""
    rows = [dict(k) for k in state["kernels"]]
    for row in rows:
        by_path = {"eval": row["launches"],
                   "train": state["train_launches"][row["name"]],
                   "zoo": state["zoo_launches"][row["name"]],
                   "protocols": state["protocol_launches"][row["name"]],
                   "serve": state["serve_launches"][row["name"]],
                   "orbax": state["orbax_launches"][row["name"]],
                   "fractal": state["fractal_launches"][row["name"]],
                   "s2d": state["s2d_launches"][row["name"]],
                   "export": state["export_launches"][row["name"]],
                   "multi_device":
                       state["multi_device_launches"][row["name"]],
                   "spatial_sharded":
                       state["spatial_sharded_launches"][row["name"]]}
        row["launches"] = sum(by_path.values())
        row["launches_by_path"] = by_path
        if row["name"] == "conv3x3_affine_relu":
            row["launches_by_body"] = state["conv_bodies"]
            row["launches_by_schedule"] = state["conv_schedules"]
            row["launches_by_model"] = {**state["zoo_conv_launches"],
                                        **state["s2d_conv_launches"]}
            row["by_body"] = state["conv_by_body"]
            # f32_box launches by phase (this process, checks and timing
            # loops included) and in the ranks' f32 tasks
            row["f32_box_launches"] = {
                **{phase: bodies.get("f32_box", 0) for phase, bodies
                   in state["phase_bodies"].items()},
                **{f"{phase}_ranks": n for phase, n
                   in state.get("f32_rank_launches", {}).items()}}
            row["mma_sync_lists"] = {
                name: {k: v for k, v in t.items() if k != "rows"}
                for name, t in state["mma_sync_lists"].items()}
            row["narrow_list"] = {
                k: v for k, v in state["narrow_list"].items()
                if k not in ("rows", "by_body")}
    probe = dict(state["kernels_probe"])
    probe["launches_by_path"] = {
        "probe": probe["launches"],
        "export": state["export_launches"]["conv3x3_relu_imcol"],
        "orbax": state["orbax_launches"]["conv3x3_relu_imcol"],
        "multi_device":
            state["multi_device_launches"]["conv3x3_relu_imcol"],
        "spatial_sharded":
            state["spatial_sharded_launches"]["conv3x3_relu_imcol"]}
    probe["launches"] = sum(probe["launches_by_path"].values())
    return rows + [probe]


def main() -> None:
    if sys.argv[1:2] == ["--export-child"]:
        export_child(sys.argv[2])
        return
    if sys.argv[1:2] == ["--orbax-child"]:
        orbax_child(sys.argv[2])
        return
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ["--pool-gaps"]:
        pool_gaps(int(sys.argv[2]))
        return
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    try:
        import jcfszxc_unet_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port's package is not importable from {ROOT}: {e}")
    os.makedirs(OUT_DIR, exist_ok=True)
    state = {}
    tally = count_bodies_by_phase(state)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "tf32": False}
    t_start = time.perf_counter()
    failed = []
    needs = {"train_val_f32": "train_path", "serve": "train_path",
             "orbax": "train_path", "s2d": "zoo_eval"}
    for name, phase in (("build", phase_build),
                        ("main_path", phase_main_path),
                        ("f32_end_to_end", phase_f32_end_to_end),
                        ("kernels", phase_kernels),
                        ("zoo_eval", phase_zoo_eval),
                        ("eval_protocols", phase_eval_protocols),
                        ("train_path", phase_train_path),
                        ("serve", phase_serve),
                        ("orbax", phase_orbax),
                        ("train_val_f32", phase_train_val_f32),
                        ("fractal", phase_fractal),
                        ("s2d", phase_s2d),
                        ("export", phase_export),
                        ("probe", phase_probe),
                        ("multi_device", phase_multi_device),
                        ("spatial_sharded", phase_spatial_sharded)):
        if needs.get(name) in failed:
            failed.append(name)
            continue
        t_phase = time.perf_counter()
        tally["phase"] = name
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
