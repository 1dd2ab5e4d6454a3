"""Port checkpoints to PyTorch ``.pth`` state dicts, the inverse of
``compat/torch_import.py`` and counterpart of
``jcfszxc_unet_tpu/compat/torch_export.py``.

The port's modules carry the reference's attribute names and torch
layouts, so the export is the model's own ``state_dict`` as CPU tensors,
which the reference's class loads:

    model = UNetFamily.UNet.UNet(3, 1)
    model.load_state_dict(torch.load("exported.pth"))

For weights that came from JAX the file equals the JAX package's
``variables_to_state_dict``: ``num_batches_tracked`` is 0 (the BatchNorms
here use a momentum, so torch never reads it) and FRUNet's dead ``fuse``
keys are absent, so a reference FRUNet loads it with ``strict=False``.

CLI:  python -m jcfszxc_unet_tpu_torch.compat.torch_export \\
          --ckpt best_model.pt --out best_model.pth
"""

from __future__ import annotations

import argparse

import torch
from torch import nn


def export_torch_state_dict(model: nn.Module, out_path: str) -> str:
    """Write ``model``'s state dict as a bare ``.pth`` of contiguous CPU
    tensors."""
    torch.save({k: v.detach().cpu().contiguous()
                for k, v in model.state_dict().items()}, out_path)
    return out_path


def export_torch_checkpoint(ckpt_path: str, out_path: str) -> str:
    """A checkpoint of any format ``train.checkpoint.load_model_any``
    reads -> a state-dict ``.pth``."""
    from jcfszxc_unet_tpu_torch.train.checkpoint import load_model_any

    model, _ = load_model_any(ckpt_path, device="cpu")
    return export_torch_state_dict(model, out_path)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Convert a checkpoint (the port's, a JAX .ckpt or a "
                    ".pth) into a PyTorch state-dict .pth that the "
                    "reference's model classes load with load_state_dict")
    p.add_argument("--ckpt", required=True, help="input checkpoint path")
    p.add_argument("--out", required=True, help="output .pth path")
    args = p.parse_args(argv)
    print(f"wrote {export_torch_checkpoint(args.ckpt, args.out)}")


if __name__ == "__main__":
    main()
