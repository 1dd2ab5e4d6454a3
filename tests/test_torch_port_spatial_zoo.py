"""The port's row-sharded whole-image forward under 2 ranks against JAX
for the zoo models that tests/test_torch_port_spatial_models.py does not
hold against JAX's sharded forward: each against JAX's one-device apply
of the image padded as JAX's sharded forward pads it (H to a multiple of
2 x 32, W of 32), which JAX's own tests hold equal to that forward (CPU,
f32, JAX weights carried across by ``state_dict_from_jax``, drawn with
numpy at a trained network's scale; one 2-rank gloo job,
``torch_port_common.run_spatial_cases``).  Tolerance rtol 1e-5, atol
1e-5.  The models with a pre-sigmoid or pre-softmax head run with it
(``logit_head``), so that BARUNet's and BIARUNet's maps are not the
constant of a softmax over one channel.
"""

import pytest

from .test_torch_port_spatial_models import CASES as MESH_CASES
from .torch_port_common import check_spatial_case, run_spatial_cases

LOGIT = {"logit_head": True}
SHAPE, DIVISOR = (1, 40, 32), 32
CASES = {name.split(".")[-1]: (name, kwargs, SHAPE, DIVISOR, 2, "apply")
         for name, kwargs in (
             ("ResUNet.ResUNet", {}),
             ("UNetPP.NestedUNet", {}),
             ("AttentionUNet.AttentionUNet", {}),
             ("R2UNet.R2UNet", {}),
             ("R2AttentionUNet.R2AttentionUNet", {}),
             ("BCDUNet.BCDU_net_D1", LOGIT),
             ("MultiResUNet.MultiResUNet", {}),
             ("DenseUNet.DenseUNet", {}),
             ("BARUNet.BARUNet", LOGIT),
             ("BIARUNet.BIARUNet", LOGIT),
             ("MCUNet.MCUNet", {}),
             ("RetinaLiteNet.TransFuseNet", LOGIT))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_spatial_cases(CASES, tmp_path_factory.mktemp("spatial"), 300)


@pytest.mark.parametrize("case", sorted(CASES))
def test_row_sharded_forward_matches_jax_apply(runs, case):
    check_spatial_case(runs, CASES, case)


def test_cases_cover_the_zoo_under_two_ranks():
    from jcfszxc_unet_tpu_torch.models import MODEL_REGISTRY

    two_ranks = {name for name, kwargs, _, _, ranks, _ in
                 list(CASES.values()) + list(MESH_CASES.values())
                 if ranks == 2 and not kwargs.get("s2d")}
    assert two_ranks == set(MODEL_REGISTRY)
