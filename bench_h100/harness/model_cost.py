"""What one forward of a configuration costs, counted on its plain
reference on the meta device: the FLOPs per patch
(``torch.utils.flop_counter``: convolutions and matmuls, 2 per
multiply-add) and the shapes of its SAME 3x3 stride-1 convs, the calls
the program's kernel 1 takes in evaluation."""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode


def forward_cost(build, patch: int, channels: int = 3):
    """(flops per patch, [(h, w, cin, cout), ...] of the 3x3 convs)."""
    with torch.device("meta"):
        model = build().eval()
    convs = []

    def record(mod, args):
        x = args[0]
        convs.append((x.shape[2], x.shape[3], mod.in_channels,
                      mod.out_channels))

    for m in model.modules():
        if (isinstance(m, nn.Conv2d) and m.kernel_size == (3, 3)
                and m.stride == (1, 1) and m.padding == (1, 1)
                and m.dilation == (1, 1) and m.groups == 1):
            m.register_forward_pre_hook(record)
    x = torch.empty((1, channels, patch, patch), device="meta")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(x)
    return int(fc.get_total_flops()), convs
