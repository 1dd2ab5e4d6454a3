"""Each hook of the port's row-sharded forward (``parallel/spatial.py``
and the ops that call it in ``ops/layers.py``, ``ops/blocks.py`` and
``ops/s2d.py``) under 2 and 4 gloo ranks on the CPU against the same op
on the whole map in one process: one ``parallel.jobs.run`` per world size
(``spatial_ops``), a module-scoped fixture.

The cases: kernel 1's entry (``conv3x3_folded``, its plain version on
the CPU) on halo slabs; the 7x7, dilated, stride-2 and 2x2/stride-2
convs; the s2d conv; the transposed convs k3/s2/p1/op1, k4/s2/p1 and
k2/s2; ``avg_pool2d``; align-corners bilinear upsampling (also in s2d
form) at an even and at an odd global H (9 rows: 5 + 4 on 2 ranks,
3 + 2 + 2 + 2 on 4); the global average and max pools; ``SEBlock``
(``row_mean``); the self-attention over row-major tokens; the center crop
and pad of ``pad_or_crop_to``; and halos deeper than a neighbour's slab
(the 7x7 and the dilated conv on 8 rows over 4 ranks, 2 rows a rank,
and ``halo_slab(x, 3, 3)`` itself).  Also: the helpers outside a sharded
forward, and ``pad_to_multiple`` against JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jcfszxc_unet_tpu.parallel.spatial import (
    pad_to_multiple as jax_pad_to_multiple,
)
from jcfszxc_unet_tpu_torch.parallel import World, jobs, spawn, spatial
from jcfszxc_unet_tpu_torch.parallel.mesh import row_bounds

# The same op on other slab heights: summation order alone (at most
# 4.8e-7 seen, the bilinear contractions against F.interpolate).
TOL = 1e-6
RNG = np.random.RandomState(0)
X16 = RNG.randn(2, 16, 16, 12).astype(np.float32)   # 8 / 4 rows a rank
X9 = RNG.randn(2, 16, 9, 10).astype(np.float32)     # odd global H
X8 = RNG.randn(1, 16, 8, 6).astype(np.float32)      # 2 rows a rank at 4
OPS = ["conv3x3_fused", "conv7x7", "conv_dilated", "conv_stride2",
       "conv_k2s2", "conv_s2d", "convT_k3s2", "convT_k4s2", "convT_k2s2",
       "avg_pool", "bilinear", "bilinear_s2d", "avg_pool_1x1",
       "max_pool_1x1", "se_block", "attention", "crop", "pad"]
CASES = ([(op, "x16") for op in OPS]
         + [(op, "x9") for op in ("bilinear", "avg_pool", "conv3x3_fused")]
         + [(op, "x8") for op in ("conv7x7", "conv_dilated", "attention",
                                  "conv3x3_fused", "halo3")])
INPUTS = {"x16": X16, "x9": X9, "x8": X8}
RANKS = (2, 4)


@pytest.fixture(scope="module")
def runs():
    cases = [(op, INPUTS[x]) for op, x in CASES]
    tasks = [("spatial_ops", dict(cases=cases))]
    single = jobs.run(None, tasks, device="cpu")[0]["outs"]
    return single, {n: [r[0]["outs"] for r in spawn(
        jobs.run, n, tasks, device="cpu", join_timeout_s=300)]
        for n in RANKS}


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{op}-{x}" for op, x in CASES])
def test_sharded_op_equals_the_whole_map(runs, case, ranks):
    single, per_rank = runs
    op, name = CASES[case]
    if op == "halo3":
        x = INPUTS[name]
        h = x.shape[2]
        padded = np.pad(x, ((0, 0), (0, 0), (3, 3), (0, 0)))
        for r, outs in enumerate(per_rank[ranks]):
            start, stop = row_bounds(h, World(r, ranks, torch.device("cpu"),
                                              "gloo"))
            if ranks == 4:
                assert stop - start < 3  # deeper than a neighbour's slab
            np.testing.assert_array_equal(outs[case],
                                          padded[:, :, start:stop + 6])
        return
    want = single[case]
    assert np.abs(want).max() > 0.1
    for outs in per_rank[ranks]:
        assert outs[case].shape == want.shape
        np.testing.assert_allclose(outs[case], want, rtol=TOL, atol=TOL)


def test_helpers_outside_a_sharded_forward_are_the_whole_map_ops():
    x = torch.from_numpy(X9).contiguous(memory_format=torch.channels_last)
    assert spatial.active() is None
    assert torch.equal(spatial.row_mean(x), x.mean(dim=(2, 3)))
    assert torch.equal(spatial.row_max(x, keepdim=True),
                       x.amax(dim=(2, 3), keepdim=True))
    assert torch.equal(spatial.row_sum(x, (2,)), x.sum(dim=(2,)))
    assert spatial.gather_h(x) is x
    halo = spatial.halo_slab(x, 2, 1)
    assert torch.equal(halo, torch.nn.functional.pad(x, (0, 0, 2, 1)))
    assert torch.equal(spatial.halo_slab(x, -1, -2), x[:, :, 1:-2])
    # one rank: no sharding at all
    with spatial.row_sharded(World(0, 1, torch.device("cpu"), "gloo"), 9):
        assert spatial.active() is None


def test_layout_follows_the_input_split():
    sharding = spatial.RowSharding(World(1, 4, torch.device("cpu"), "gloo"),
                                   (3, 2, 2, 2))
    assert sharding.layout(2) == ([0, 3, 5, 7], [3, 2, 2, 2])
    assert sharding.layout(4) == ([0, 6, 10, 14], [6, 4, 4, 4])
    with pytest.raises(ValueError, match="does not split"):
        sharding.layout(1)  # 1.5 rows of rank 0's


@pytest.mark.parametrize("axis,multiple", [(1, 64), (2, 32), (1, 5)])
def test_pad_to_multiple_matches_jax(axis, multiple):
    got, size = spatial.pad_to_multiple(torch.from_numpy(X9), axis, multiple)
    want, jsize = jax_pad_to_multiple(jnp.asarray(X9), axis, multiple)
    assert size == jsize == X9.shape[axis]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
