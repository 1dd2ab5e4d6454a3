"""Fused 3x3 conv + per-channel affine + ReLU.

``relu?(conv3x3_SAME(x, w) * scale + shift)`` on NHWC ``x (B, H, W, Cin)``
and HWIO ``w (3, 3, Cin, Cout)``, accumulated in f32 and stored once in
``x.dtype``.  In the eval-mode UNet forward every DoubleConv conv goes
through it with its BatchNorm folded into ``scale``/``shift``.

Kernel: ``csrc/conv3x3_affine_relu.cu``, CUDA C++ for sm_90a, replacing
the TPU kernel ``conv3x3_affine_relu_pallas`` in
``jcfszxc_unet_tpu/ops/pallas/conv_fused.py``.  It is an implicit GEMM
(M = B*H*W, N = Cout, K = 9*Cin) that reads the weights K-major,
(Cout, 3, 3, Cin), and no padded copy of x.  At UNet's shapes it is bound
by operations, so the bf16 path has to reach the tensor cores' ``wgmma``
rate, which its first ``mma.sync`` form (80 TFLOP/s) did not.  The ``wgmma``
body (``csrc/conv3x3_wgmma.cuh``) brings both operands in by TMA: x as 4-D
boxes of output pixels whose out-of-image taps TMA zero-fills, or as
haloed row strips that serve three taps each, into a persistent,
warp-specialised ``mbarrier`` ring.  It takes every bf16 call with
Cin % 8 == 0 and 16-byte-aligned operands but the narrow ones (few
channels on one side, at the widths ``conv_plan.NARROW_SHAPES`` lists),
which bytes bound and which the
``narrow`` body (``csrc/conv3x3_narrow.cu``) takes: persistent blocks that
keep the weights in shared memory and bring in one haloed input box of
all the taps per tile by TMA, the pixels as ``wgmma``'s rows and Cout
rounded up to 8 as its width.  TMA needs 16-byte global
strides, and a pixel of the stem (Cin = 3) is 6 bytes, so every other bf16
call (the stems, MultiResUNet's odd widths) takes the ``mma_sync`` body:
one haloed input box per tile in shared memory with its channels padded
to a multiple of 8, the nine taps as fixed offsets into it, ``ldmatrix`` +
``mma.sync``, the weights padded once per call into a workspace that
:func:`launch` allocates.  f32 runs on the CUDA cores so that its
products stay f32, in the ``f32_box`` body: the same haloed box per tile,
here as channel planes fed by a ``cp.async`` ring, each thread's 16
pixels of a box row by 4 channels (8 by 8 in boxes 8 wide) register-blocked
over a tap row, the weights laid out once per call into the workspace
too.  :func:`conv_plan.plan_conv` picks the
body and the tile from the dtype, the shapes and the alignment.

:func:`conv3x3_affine_relu_torch` is the plain PyTorch version.  The
wrappers check their inputs and call the ``jcfszxc_unet::conv3x3_affine_relu``
operator (``library.py``), which takes the plain version only for tensors
on the CPU; for a CUDA tensor it launches the kernel (:func:`launch` with
:func:`plan_for`'s plan) or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from jcfszxc_unet_tpu_torch.ops.kernels import build, conv_plan

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

counter = build.LaunchCounter()


def conv3x3_affine_relu_torch(x, w, scale, shift, relu: bool = True):
    """Plain version: ``F.conv2d`` on inputs upcast to f32 (f64 stays f64,
    for the CPU replays of the kernel's addressing), then the affine, the
    optional ReLU and one cast to ``x.dtype``.  Returns contiguous NHWC."""
    ct = torch.promote_types(x.dtype, torch.float32)
    y = F.conv2d(x.permute(0, 3, 1, 2).to(ct), w.permute(3, 2, 0, 1).to(ct),
                 padding=1)
    y = y * scale.to(ct).view(1, -1, 1, 1) + shift.to(ct).view(1, -1, 1, 1)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype).permute(0, 2, 3, 1).contiguous()


def _validate(x, w_km, scale, shift):
    """w_km: the weights K-major, (Cout, 3, 3, Cin)."""
    cout, cin = w_km.shape[0], w_km.shape[3]
    if x.shape[3] != cin:
        raise ValueError(f"x has {x.shape[3]} channels, w expects {cin}")
    if tuple(scale.shape) != (cout,) or tuple(shift.shape) != (cout,):
        raise ValueError(f"scale and shift must have shape ({cout},)")
    if x.dtype not in _DTYPE_CODES or w_km.dtype != x.dtype:
        raise TypeError(
            f"x and w must share float32 or bfloat16, got {x.dtype} and "
            f"{w_km.dtype}")
    if scale.dtype != torch.float32 or shift.dtype != torch.float32:
        raise TypeError("scale and shift must be float32")
    for name, t in (("x", x), ("scale", scale), ("shift", shift)):
        if not t.is_contiguous():
            raise ValueError(
                f"{name} must be contiguous in the layout given (for x: a "
                f"channels_last NCHW tensor permuted to NHWC)")
    for name, t in (("w", w_km), ("scale", scale), ("shift", shift)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _check_dims(x, w, window, layout: str):
    """window: w's two kernel-window dims, which must be (3, 3)."""
    if x.dim() != 4 or w.dim() != 4 or tuple(window) != (3, 3):
        raise ValueError(
            f"expected x (B,H,W,Cin) and w {layout}, got {tuple(x.shape)} "
            f"and {tuple(w.shape)}")


def launch(x, w_km, scale, shift, relu: bool, plan: conv_plan.ConvPlan):
    """The kernel on CUDA tensors with the given plan; raises on any error
    the launch function returns (a refused tensor-map encode, shared-memory
    attribute or launch, or a plan the body does not take)."""
    b, h, wd, cin = x.shape
    cout = w_km.shape[0]
    out = torch.empty((b, h, wd, cout), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = build.load_library()
    # the box bodies' weights, laid out by the launch in their stages' order
    ws_bytes = conv_plan.box_workspace_bytes(plan, cin)
    ws = (torch.empty(ws_bytes, dtype=torch.uint8, device=x.device)
          if ws_bytes else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.conv3x3_affine_relu_launch(
            _DTYPE_CODES[x.dtype], x.data_ptr(), w_km.data_ptr(),
            scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
            b, h, wd, cin, cout, int(relu), plan.ints(),
            ws.data_ptr() if ws is not None else None, ws_bytes, stream)
    build.check(lib, code, "conv3x3_affine_relu")
    counter.add(plan.body, conv_plan.schedule(plan))
    return out


def plan_for(x, w_km) -> conv_plan.ConvPlan:
    """The plan the operator's CUDA implementation launches with (it reads
    the operands' alignment, so CUDA tensors only)."""
    b, h, wd, cin = x.shape
    aligned = x.data_ptr() % 16 == 0 and w_km.data_ptr() % 16 == 0
    return conv_plan.plan_conv(b, h, wd, cin, w_km.shape[0], x.dtype, aligned,
                               conv_plan.sm_count(x.device))


def _check_device(x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {x.device}")


def conv3x3_affine_relu_kmajor(x, w_km, scale, shift, relu: bool = True):
    """:func:`conv3x3_affine_relu` with the weights K-major: ``w_km``
    (Cout, 3, 3, Cin), contiguous, which is ``conv.weight.permute(0, 2, 3,
    1)`` of a PyTorch conv and the layout the kernel reads."""
    _check_dims(x, w_km, w_km.shape[1:3], "(Cout,3,3,Cin)")
    _validate(x, w_km, scale, shift)
    if not w_km.is_contiguous():
        raise ValueError("w must be contiguous (Cout, 3, 3, Cin)")
    _check_device(x)
    return torch.ops.jcfszxc_unet.conv3x3_affine_relu.default(
        x, w_km, scale, shift, relu)


def conv3x3_affine_relu(x, w, scale, shift, relu: bool = True):
    """``relu?(conv3x3_SAME(x, w) * scale + shift)`` in ``x.dtype``.

    x: (B, H, W, Cin) float32 or bfloat16, contiguous; w: (3, 3, Cin, Cout)
    of the same dtype, contiguous (re-laid K-major for the kernel); scale,
    shift: (Cout,) float32.
    """
    _check_dims(x, w, w.shape[:2], "(3,3,Cin,Cout)")
    _validate(x, w.permute(3, 0, 1, 2), scale, shift)
    if not w.is_contiguous():
        raise ValueError("w must be contiguous (3, 3, Cin, Cout)")
    _check_device(x)
    return torch.ops.jcfszxc_unet.conv3x3_affine_relu.default(
        x, w.permute(3, 0, 1, 2).contiguous(), scale, shift, relu)
