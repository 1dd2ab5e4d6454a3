"""``scripts/forward_repeatability``: the module calls it records and
re-runs, and the innermost module it names, on the CPU."""

import torch
from torch import nn

from jcfszxc_unet_tpu_torch.scripts import forward_repeatability as fr

from . import torch_port_common  # noqa: F401  (one torch thread)


class _Noisy(nn.Module):
    """Adds fresh noise on every call: not reproducible."""

    def forward(self, x):
        return x + torch.rand_like(x)


class _Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 4, 3, padding=1)
        self.block = nn.Sequential(nn.ReLU(inplace=True), _Noisy())
        self.head = nn.Conv2d(4, 1, 1)

    def forward(self, x):
        return self.head(self.block(self.conv(x)))


def test_names_the_innermost_module_that_does_not_reproduce():
    torch.manual_seed(0)
    net = _Net().eval()
    calls = fr.record_calls(net, torch.rand(2, 3, 8, 8))
    assert [c[0] for c in calls] == ["conv", "block.0", "block.1", "block",
                                     "head", ""]
    rows = fr.recall(calls, repeats=2)
    diff = {r["module"]: r["max_abs_diff"] for r in rows}
    # The in-place ReLU re-runs on its recorded input, not on its output.
    assert diff["conv"] == diff["block.0"] == diff["head"] == 0.0
    assert diff["block.1"] > 0 and diff["block"] > 0 and diff["<model>"] > 0
    assert fr.innermost(rows) == ["block.1"]


def test_a_reproducible_model_moves_nothing():
    torch.manual_seed(0)
    net = nn.Sequential(nn.Conv2d(3, 4, 3, padding=1), nn.ReLU()).eval()
    rows = fr.recall(fr.record_calls(net, torch.rand(1, 3, 8, 8)), repeats=2)
    assert fr.innermost(rows) == [] and all(
        r["max_abs_diff"] == 0.0 for r in rows)
