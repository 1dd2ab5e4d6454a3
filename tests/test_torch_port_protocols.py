"""The port's other evaluation protocols against the JAX functions (CPU,
f32): the sliding window (``sliding_window_predict``, with the border it
leaves uncovered), dihedral-8 TTA (``dihedral_tta`` over the tiled
protocol) and whole-image evaluation (``make_spatial_forward`` on a mesh
of one), each JAX forward built from the same UNet variables as the
port's ``Predictor``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jcfszxc_unet_tpu.eval.tiling import (
    dihedral_tta as jax_dihedral_tta,
    sliding_window_predict as jax_sliding_window_predict,
    tiled_predict as jax_tiled_predict,
)
from jcfszxc_unet_tpu.parallel.mesh import make_mesh
from jcfszxc_unet_tpu.parallel.spatial import make_spatial_forward
from jcfszxc_unet_tpu_torch.eval.predictor import Predictor
from jcfszxc_unet_tpu_torch.eval.spatial import pad_to_multiple
from jcfszxc_unet_tpu_torch.eval.tiling import (
    dihedral_tta,
    sliding_window_predict,
)

from .torch_port_common import jax_unet, port_unet

# 2 images of 40 x 36: not a multiple of 32 (whole-image padding), and a
# window grid of patch 16 at overlap 0.3 (stride 11) that leaves the last
# 2 rows and 9 columns uncovered
N, H, W, PATCH, OVERLAP, BATCH = 2, 40, 36, 16, 0.3, 4
TOL = 1e-5  # probabilities, f32 on both sides


@pytest.fixture(scope="module")
def setup():
    jmodel, variables = jax_unet(seed=3, hw=PATCH)
    images = np.random.RandomState(4).rand(N, H, W, 3).astype(np.float32)

    def jax_forward(batch):
        return jax.nn.sigmoid(jmodel.apply(variables, batch, train=False))

    pred = Predictor(port_unet(variables), compute_dtype=torch.float32,
                     patch_size=PATCH, inference_batch_size=BATCH,
                     device="cpu")
    return dict(jmodel=jmodel, variables=variables, images=images,
                jax_forward=jax_forward, pred=pred)


def test_sliding_window_matches_jax_and_leaves_the_border_zero(setup):
    image = setup["images"][1]
    want = np.asarray(jax_sliding_window_predict(
        setup["jax_forward"], jnp.asarray(image), PATCH, OVERLAP, BATCH))
    got = setup["pred"].predict_full_image(image, PATCH, OVERLAP, BATCH)
    assert got.shape == (H, W)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    covered_h, covered_w = 22 + PATCH, 11 + PATCH
    assert not got[covered_h:].any() and not got[:, covered_w:].any()
    assert (got[:covered_h, :covered_w] > 0).all()


def test_sliding_window_refuses_a_patch_larger_than_the_image():
    with pytest.raises(ValueError, match="exceeds the image size"):
        sliding_window_predict(lambda b: b[..., :1], torch.zeros(8, 8, 3), 16)


def test_tta_matches_jax(setup):
    want = np.asarray(jax_tiled_predict(
        jax_dihedral_tta(setup["jax_forward"]), jnp.asarray(setup["images"]),
        PATCH, BATCH))
    pred = setup["pred"]
    tta = Predictor(pred.model, compute_dtype=torch.float32, patch_size=PATCH,
                    inference_batch_size=BATCH, device="cpu", tta=True)
    got = tta.predict_images(setup["images"])
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    # the augmentation changes the maps: not the plain tiled protocol
    assert np.abs(got.numpy() - pred.predict_images(
        setup["images"]).numpy()).max() > 1e-4


def test_tta_hands_the_forward_contiguous_variants():
    seen = []

    def forward(batch):
        seen.append(batch.is_contiguous())
        return batch[..., :1] * 2.0

    x = torch.rand(2, 5, 5, 3)
    got = dihedral_tta(forward)(x)
    assert seen == [True] * 8
    # each variant is mapped back before the average: identity * 2
    torch.testing.assert_close(got, 2.0 * x[..., :1])


def test_spatial_matches_jax(setup):
    fwd = make_spatial_forward(setup["jmodel"], setup["variables"],
                               make_mesh(1), divisor=32,
                               compute_dtype=jnp.float32)
    want = np.asarray(fwd(jnp.asarray(setup["images"])))
    got = setup["pred"].predict_spatial(setup["images"])
    assert got.shape == (N, H, W)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_spatial_pads_bottom_right_and_refuses_tta(setup):
    x = torch.rand(1, 40, 33, 3)
    padded = pad_to_multiple(x, 32)
    assert padded.shape == (1, 64, 64, 3)
    assert torch.equal(padded[:, :40, :33], x)
    assert not padded[:, 40:].any() and not padded[:, :, 33:].any()
    assert pad_to_multiple(padded, 32) is padded
    tta = Predictor(setup["pred"].model, device="cpu", tta=True)
    with pytest.raises(ValueError, match="square patches"):
        tta.predict_spatial(setup["images"])
