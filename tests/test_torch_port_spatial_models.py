"""The port's row-sharded whole-image forward (``parallel/spatial.py``,
through ``Predictor.predict_spatial(world=...)``) against JAX
``make_spatial_forward`` on ``make_mesh(n)``, on the CPU, in f32, on JAX
weights carried across by ``state_dict_from_jax`` (drawn with numpy at a
trained network's scale; dropout silenced), in one 2-rank gloo job and
one 4-rank job (``torch_port_common.run_spatial_cases``):

  * UNet, and the four cases of tests/test_parallel.py:248-330 at their
    sizes, divisors and mesh sizes: TransFuseNet on 4 ranks (2 x 40 x 48,
    divisor 8, where the CBAM's 7x7 conv reads 3 rows from ranks that
    hold 2 each), SegNet (divisor 32, 1 x 40 x 64), FRUNet (divisor 16,
    1 x 24 x 32) and BCDU_net_D3 (divisor 8, N = 24, 1 x 24 x 32);
  * the three ``--s2d`` models under 2 ranks, against JAX's one-device
    apply of the identically padded image.

tests/test_torch_port_spatial_zoo.py holds the other models.  Tolerance
rtol 1e-5, atol 1e-5, as JAX's ``_check_spatial``; every rank holds the
same maps, bit for bit.  The models with a pre-sigmoid head run with it
(``logit_head``), as in the zoo files.
"""

import pytest

from .torch_port_common import check_spatial_case, run_spatial_cases

LOGIT = {"logit_head": True}
S2D = {"s2d": True}
# id -> (registry name, model kwargs, image shape (N, H, W), divisor,
# ranks, reference: "mesh" for JAX make_spatial_forward, "apply" for its
# one-device apply of the padded image)
CASES = {
    "UNet": ("UNet.UNet", {}, (1, 40, 32), 32, 2, "mesh"),
    "SegNet": ("SegNet.SegNet", {}, (1, 40, 64), 32, 2, "mesh"),
    "FRUNet": ("FRUNet.FRUNet", {}, (1, 24, 32), 16, 2, "mesh"),
    "BCDU_net_D3": ("BCDUNet.BCDU_net_D3", {**LOGIT, "N": 24}, (1, 24, 32),
                    8, 2, "mesh"),
    "TransFuseNet_4_ranks": ("RetinaLiteNet.TransFuseNet", LOGIT,
                             (2, 40, 48), 8, 4, "mesh"),
    "NestedUNet_s2d": ("UNetPP.NestedUNet", S2D, (1, 40, 32), 32, 2,
                       "apply"),
    "MultiResUNet_s2d": ("MultiResUNet.MultiResUNet", S2D, (1, 40, 32), 32,
                         2, "apply"),
    "FRUNet_s2d": ("FRUNet.FRUNet", S2D, (1, 40, 32), 32, 2, "apply"),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_spatial_cases(CASES, tmp_path_factory.mktemp("spatial"), 200)


@pytest.mark.parametrize("case", sorted(CASES))
def test_row_sharded_forward_matches_jax_mesh(runs, case):
    check_spatial_case(runs, CASES, case)


def test_cases_cover_the_s2d_models():
    from jcfszxc_unet_tpu_torch.models import s2d_capable

    assert sorted(name for name, kwargs, *_ in CASES.values()
                  if kwargs.get("s2d")) == s2d_capable()
