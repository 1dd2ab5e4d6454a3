"""The port's three kernels as PyTorch operators, in the namespace
``jcfszxc_unet``:

* ``conv3x3_affine_relu(x, w_km, scale, shift, relu) -> Tensor``
  (``conv_fused``: x (B, H, W, Cin), w_km (Cout, 3, 3, Cin), f32 scale and
  shift (Cout,); returns (B, H, W, Cout) in x's dtype);
* ``dice_sums(probs, target) -> (Tensor, Tensor, Tensor)`` (``dice_fused``:
  two f32 (B, H, W) maps; returns three f32 (B,) sums);
* ``conv3x3_relu_imcol(xp, wt) -> Tensor`` (``conv_imcol``: the padded
  operands of ``conv_imcol.pad_inputs``; returns (B, H, W, Cout)).

Each has a CPU implementation, which is the kernel's plain PyTorch
version; a CUDA implementation, which launches the hand-written kernel
(built by ``build.load_library``) and raises on any error code it
returns; and a fake implementation, which gives the output's shape, dtype
and contiguous NHWC strides without touching storage, so that
``torch.export`` traces through the operator and the exported program
holds one node per call.  Only the CUDA implementations read
``data_ptr()``, the alignment tests of the plans included, and only they
add to the launch counters, so the launches of an exported program count
too.  The kernels are eval-mode kernels: a backward through an operator
raises.

The operators are defined with ``torch.library.Library``.  Measured on
the card against the same CUDA implementation registered with
``torch.library.custom_op``, neither was consistently cheaper per call:
every difference lay within the host's run-to-run spread (PERF.md §6).
``Library`` was kept because it names each schema once and registers the
CPU and CUDA implementations by dispatch key, so the device is chosen by
the dispatcher and no Python layer of its own sits in front of the call.
Outside ``torch.inference_mode`` the autograd kernel that makes a backward
raise runs in Python on every call; the evaluation paths and the trainers'
validations run in inference mode, which skips it
(``scripts/op_dispatch_cost.py`` times both modes).  The wrappers
(``conv_fused.conv3x3_affine_relu_kmajor``, ``dice_fused.dice_sums``,
``conv_imcol.conv3x3_relu_imcol``) check their inputs and call the
operators; importing ``jcfszxc_unet_tpu_torch.ops.kernels`` registers
them.
"""

from __future__ import annotations

import torch

from jcfszxc_unet_tpu_torch.ops.kernels import (
    conv_fused,
    conv_imcol,
    conv_plan,
    dice_fused,
)

NAMESPACE = "jcfszxc_unet"

LIB = torch.library.Library(NAMESPACE, "DEF")
LIB.define("conv3x3_affine_relu(Tensor x, Tensor w_km, Tensor scale, "
           "Tensor shift, bool relu) -> Tensor")
LIB.define("dice_sums(Tensor probs, Tensor target) -> (Tensor, Tensor, Tensor)")
LIB.define("conv3x3_relu_imcol(Tensor xp, Tensor wt) -> Tensor")


# --- conv3x3_affine_relu ---------------------------------------------------

def _conv_cpu(x, w_km, scale, shift, relu):
    return conv_fused.conv3x3_affine_relu_torch(x, w_km.permute(1, 2, 3, 0),
                                                scale, shift, relu)


def _conv_cuda(x, w_km, scale, shift, relu):
    return conv_fused.launch(x, w_km, scale, shift, relu,
                             conv_fused.plan_for(x, w_km))


def _conv_fake(x, w_km, scale, shift, relu):
    b, h, w, _ = x.shape
    return x.new_empty((b, h, w, w_km.shape[0]))


# --- dice_sums -------------------------------------------------------------

def _dice_fake(probs, target):
    return tuple(probs.new_empty((probs.shape[0],)) for _ in range(3))


# --- conv3x3_relu_imcol ----------------------------------------------------

def _imcol_cpu(xp, wt):
    c8, cout = xp.shape[3], wt.shape[0]
    return conv_imcol.conv3x3_relu_imcol_torch(
        xp[:, 1:-1, 1:-1], wt.t().reshape(3, 3, c8, cout).contiguous())


def _imcol_cuda(xp, wt):
    for name, t in (("xp", xp), ("wt", wt)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    b, hp, wp, c8 = xp.shape
    plan = conv_plan.plan_conv(
        b, hp - 2, wp - 2, c8, wt.shape[0], xp.dtype, True,
        conv_plan.sm_count(xp.device), imcol=True)
    return conv_imcol.launch(xp, wt, plan)


def _imcol_fake(xp, wt):
    b, hp, wp, _ = xp.shape
    return xp.new_empty((b, hp - 2, wp - 2, wt.shape[0]))


def _no_backward(ctx, *grads):
    raise RuntimeError(
        f"{NAMESPACE} kernels are eval-mode kernels: no gradient flows "
        "through them (train mode runs stock torch ops)")


for _name, _cpu, _cuda, _fake in (
        ("conv3x3_affine_relu", _conv_cpu, _conv_cuda, _conv_fake),
        ("dice_sums", dice_fused.dice_sums_torch, dice_fused.launch,
         _dice_fake),
        ("conv3x3_relu_imcol", _imcol_cpu, _imcol_cuda, _imcol_fake)):
    LIB.impl(_name, _cpu, "CPU")
    LIB.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{_name}", _fake, lib=LIB)
    torch.library.register_autograd(f"{NAMESPACE}::{_name}", _no_backward,
                                    lib=LIB)

ops = getattr(torch.ops, NAMESPACE)
