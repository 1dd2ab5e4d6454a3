"""Model export for serving, counterpart of
``jcfszxc_unet_tpu/eval/export.py``:

    blob = export_forward(model, batch_size=32, patch_size=512)  # bytes
    fn = load_exported(blob)
    probs = fn(patches)          # (32, 512, 512, 3) -> (32, 512, 512, 1)
    export_checkpoint("best_model.pt", "unet.pt2")   # file -> artifact

The exported function is the one :class:`~.predictor.Predictor` serves,
``predictor.sigmoid_forward``: NHWC input in the compute dtype, the model
on its NCHW ``channels_last`` view, a sigmoid in f32, NHWC output.
``torch.export`` traces it at one fixed (B, P, P, C) shape and
``torch.export.save`` serializes the program with the model's weights, the
counterpart of JAX's StableHLO artifact.  The port's kernels are
operators (``ops/kernels/library.py``), so the program holds one
``jcfszxc_unet.conv3x3_affine_relu`` node per kernel call of the eager
forward, and on the card it launches the same hand-written kernel with the
same plans.  ``torch.export.load`` needs those operators defined, so the
loading process imports the port (nothing of the model code runs: the
graph is in the artifact).
"""

from __future__ import annotations

import io

import torch
from torch import nn

# registers the operators the artifact names
import jcfszxc_unet_tpu_torch.ops.kernels  # noqa: F401
from jcfszxc_unet_tpu_torch.eval.predictor import sigmoid_forward
from jcfszxc_unet_tpu_torch.utils.device import resolve_device


class _SigmoidForward(nn.Module):
    def __init__(self, model: nn.Module, compute_dtype: torch.dtype):
        super().__init__()
        self.model = model
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return sigmoid_forward(self.model, x, self.compute_dtype)


def export_program(model: nn.Module, batch_size: int, patch_size: int,
                   channels: int = 3, compute_dtype=torch.bfloat16,
                   device="cuda") -> torch.export.ExportedProgram:
    """``torch.export`` of the sigmoid forward of ``model`` (which holds
    its weights; moved to ``device``, ``channels_last``, ``eval()``) for a
    fixed (batch_size, patch_size, patch_size, channels) input in
    ``compute_dtype``, traced under ``torch.inference_mode``."""
    device = resolve_device(device)
    model = model.to(device=device, memory_format=torch.channels_last).eval()
    x = torch.zeros((batch_size, patch_size, patch_size, channels),
                    dtype=compute_dtype, device=device)
    with torch.inference_mode():
        return torch.export.export(_SigmoidForward(model, compute_dtype),
                                   (x,))


def export_forward(model: nn.Module, batch_size: int, patch_size: int,
                   channels: int = 3, compute_dtype=torch.bfloat16,
                   device="cuda") -> bytes:
    """:func:`export_program`, serialized by ``torch.export.save``; returns
    the artifact's bytes (JAX ``export_forward``)."""
    program = export_program(model, batch_size, patch_size, channels,
                             compute_dtype, device)
    # The traced zeros are no part of the artifact (50 MB at batch 32 of
    # 512^2 in bf16, which torch.export.save would store).
    program.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


class ExportedForward:
    """A loaded artifact: call it on a tensor of the exported input's
    shape, dtype and device; returns (B, P, P, 1) float32
    probabilities."""

    def __init__(self, program: torch.export.ExportedProgram):
        self.program = program
        self._module = program.module()
        (name,) = program.graph_signature.user_inputs
        spec = next(n.meta["val"] for n in program.graph.nodes
                    if n.op == "placeholder" and n.name == name)
        self.shape = tuple(spec.shape)
        self.dtype = spec.dtype
        self.device = spec.device

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if (tuple(x.shape), x.dtype, x.device) != (self.shape, self.dtype,
                                                   self.device):
            raise ValueError(
                f"the exported forward takes a {self.shape} {self.dtype} "
                f"tensor on {self.device}; got {tuple(x.shape)} {x.dtype} on "
                f"{x.device}")
        with torch.inference_mode():
            return self._module(x)


def load_exported(blob: bytes) -> ExportedForward:
    """Deserialize an artifact of :func:`export_forward`; returns a
    callable that takes the exported input shape."""
    return ExportedForward(torch.export.load(io.BytesIO(blob)))


def export_checkpoint(ckpt_path: str, out_path: str, batch_size: int = 32,
                      patch_size: int = 512, compute_dtype=torch.bfloat16,
                      device="cuda") -> str:
    """Checkpoint file (the port's, a JAX ``.ckpt`` or a reference
    ``.pth``, read by ``train.checkpoint.load_model_any``, in the mode its
    config records) -> serialized serving artifact at ``out_path``."""
    from jcfszxc_unet_tpu_torch.train.checkpoint import load_model_any

    model, _ = load_model_any(ckpt_path, device=device, patch_size=patch_size)
    blob = export_forward(model, batch_size, patch_size,
                          compute_dtype=compute_dtype, device=device)
    with open(out_path, "wb") as f:
        f.write(blob)
    return out_path
