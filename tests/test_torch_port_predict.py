"""The port's predict CLI (``cli/predict.py``) against the JAX package's
``cli/predict.py``: the same JAX ``.ckpt`` (the TransFuseNet fixture) and
the same image files (RGB uint8, grayscale, 16-bit TIFF, RGBA) through
each protocol give the same probability maps, in f32."""

import numpy as np
import pytest
import torch
from PIL import Image

from jcfszxc_unet_tpu.cli import predict as jax_predict
from jcfszxc_unet_tpu_torch.cli import predict as port_predict
from jcfszxc_unet_tpu_torch.eval.predictor import Predictor

from .torch_port_common import EVAL_TOL, JAX_FIXTURE, assert_close_to

H, W, PATCH = 48, 40, 32


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """One retina-like content in four encodings, as files."""
    root = tmp_path_factory.mktemp("images")
    rng = np.random.RandomState(0)
    rgb = rng.rand(H, W, 3)
    files = {
        "rgb.png": (rgb * 255).astype(np.uint8),
        "gray.png": (rgb[..., 1] * 255).astype(np.uint8),
        "deep.tif": (rgb[..., 1] * 65535).astype(np.uint16),
        "rgba.png": np.concatenate(
            [(rgb * 255).astype(np.uint8),
             np.full((H, W, 1), 128, np.uint8)], axis=-1),
    }
    paths = []
    for name, arr in files.items():
        Image.fromarray(arr).save(root / name)
        paths.append(str(root / name))
    assert np.asarray(Image.open(paths[2])).dtype == np.uint16
    return paths


@pytest.mark.parametrize("mode,tta", [("tiled", False), ("sliding", False),
                                      ("spatial", False), ("tiled", True)],
                         ids=["tiled", "sliding", "spatial", "tiled_tta"])
def test_predict_files_matches_jax(tmp_path, images, mode, tta):
    import jax.numpy as jnp

    kwargs = dict(patch_size=PATCH, mode=mode, overlap=0.5, threshold=0.5,
                  inference_batch_size=4, tta=tta)
    want = jax_predict.predict_files(
        images, model_path=str(JAX_FIXTURE), output_dir=str(tmp_path / "jax"),
        compute_dtype=jnp.float32, **kwargs)
    out = tmp_path / "port"
    got = port_predict.predict_files(
        images, model_path=str(JAX_FIXTURE), output_dir=str(out),
        compute_dtype=torch.float32, device="cpu", **kwargs)
    assert len(got) == len(want) == len(images)
    for g, w in zip(got, want):
        assert g.shape == (H, W) and g.dtype == np.float32
        assert_close_to(g, np.asarray(w), EVAL_TOL)
    for path in images:
        stem = path.rsplit("/", 1)[1].rsplit(".", 1)[0]
        for kind in ("prob", "mask"):
            png = np.asarray(Image.open(out / f"{stem}_{kind}.png"))
            assert png.shape == (H, W) and png.dtype == np.uint8
    # the four encodings of one content give nearly the same map
    assert np.abs(got[0] - got[3]).max() == 0.0  # alpha dropped
    assert np.abs(got[1] - got[2]).max() < 1e-2   # 8 vs 16 bit


def test_predict_arrays_normalizes_as_the_files_path(images):
    raw = [np.asarray(Image.open(p)) for p in images]
    assert [r.dtype for r in raw] == [np.uint8, np.uint8, np.uint16,
                                      np.uint8]
    norm = [port_predict.normalize_image(r) for r in raw]
    assert all(n.shape == (H, W, 3) and n.dtype == np.float32 for n in norm)
    assert all(0.0 <= n.min() and n.max() <= 1.0 for n in norm)
    np.testing.assert_array_equal(norm[1][..., 0], norm[1][..., 2])
    predictor = Predictor.from_checkpoint(
        str(JAX_FIXTURE), device="cpu", compute_dtype=torch.float32,
        patch_size=PATCH, inference_batch_size=4)
    maps = port_predict.predict_arrays(predictor, raw, "tiled", PATCH)
    want = [predictor.predict_images(n[None])[0].numpy() for n in norm]
    for m, w in zip(maps, want):
        np.testing.assert_array_equal(m, w)


def test_get_args_defaults_equal_the_jax_cli():
    port = vars(port_predict.get_args(["a.tif"]))
    assert port.pop("device") == "cuda"
    assert port == vars(jax_predict.get_args(["a.tif"]))


def test_tta_with_spatial_mode_exits(tmp_path):
    with pytest.raises(SystemExit, match="--tta needs square patches"):
        port_predict.main(["a.tif", "--tta", "--mode", "spatial",
                           "--device", "cpu", "-m", str(JAX_FIXTURE)])
    with pytest.raises(ValueError, match="--tta needs square patches"):
        port_predict.predict_files(["a.tif"], str(JAX_FIXTURE), str(tmp_path),
                                   mode="spatial", tta=True, device="cpu")
