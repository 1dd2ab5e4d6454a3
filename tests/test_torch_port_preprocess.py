"""The port's preprocessing (``data/preprocess.py``, ``cli/preprocess.py``)
against the JAX package's: the enhancements array-equal, the DRIVE splits
of a synthetic tree equal, each save method round-tripping and read by
both packages."""

import numpy as np
import pytest

from jcfszxc_unet_tpu.data import preprocess as jpp
from jcfszxc_unet_tpu_torch.cli import preprocess as port_cli
from jcfszxc_unet_tpu_torch.data import preprocess as ppp

from .test_e2e import make_synthetic_drive


def _image(seed=0, h=37, w=29):
    return np.random.RandomState(seed).rand(h, w, 3).astype(np.float32)


def test_to_grayscale_and_gamma_equal_jax():
    img = _image()
    np.testing.assert_array_equal(ppp.to_grayscale(img),
                                  jpp.to_grayscale(img))
    over = img * 1.2 - 0.1  # values outside [0, 1] are clipped first
    for g in (0.5, 1.0, 2.2):
        np.testing.assert_array_equal(ppp.gamma_correct(over, g),
                                      jpp.gamma_correct(over, g))


@pytest.mark.parametrize("shape,clip,tiles", [((37, 29), 2.0, 8),
                                              ((64, 48), 3.0, 4),
                                              ((16, 16), 1.0, 8)])
def test_clahe_equals_jax(shape, clip, tiles):
    g = np.random.RandomState(sum(shape)).rand(*shape).astype(np.float32)
    got = ppp.clahe(g, clip, tiles)
    np.testing.assert_array_equal(got, jpp.clahe(g, clip, tiles))
    assert got.dtype == np.float32 and got.shape == shape


@pytest.mark.parametrize("grayscale,use_clahe,gamma", [
    (False, False, None), (True, False, None), (False, True, None),
    (False, False, 0.8), (True, True, 1.5), (False, True, 2.0)])
def test_enhance_image_equals_jax(grayscale, use_clahe, gamma):
    img = _image(1)
    got = ppp.enhance_image(img, grayscale, use_clahe, gamma)
    want = jpp.enhance_image(img, grayscale, use_clahe, gamma)
    assert got.shape == img.shape
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def drive_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("drive")
    make_synthetic_drive(str(root / "raw"), n_train=3, n_test=2, h=40, w=32)
    return root


def _same_split(got, want):
    assert sorted(got) == sorted(want)
    for k in ("images", "masks", "labels"):
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k])
    assert list(got["filenames"]) == list(want["filenames"])


@pytest.mark.parametrize("save_method", ["h5", "pickle", "joblib"])
def test_preprocess_dataset_equals_jax(drive_root, tmp_path, save_method):
    raw = str(drive_root / "raw")
    got = ppp.preprocess_dataset(raw, str(tmp_path / "port"), save_method)
    want = jpp.preprocess_dataset(raw, str(tmp_path / "jax"), save_method)
    for split, n in (("train", 3), ("test", 2)):
        assert got[split]["num_samples"] == n
        assert got[split]["image_shape"] == want[split]["image_shape"]
        port_file = got[split]["output_file"]
        assert port_file.endswith({"h5": ".h5", "pickle": ".pkl",
                                   "joblib": ".joblib"}[save_method])
        ours = ppp.load_preprocessed_data(port_file)
        _same_split(ours, jpp.load_preprocessed_data(
            want[split]["output_file"]))
        # each package reads the other's file
        _same_split(jpp.load_preprocessed_data(port_file), ours)


def test_enhanced_split_equals_jax(drive_root, tmp_path):
    raw = str(drive_root / "raw" / "training")
    kw = dict(grayscale=True, use_clahe=True, gamma=0.7)
    got = ppp.process_data_subset(raw, "train", **kw)
    _same_split(got, jpp.process_data_subset(raw, "train", **kw))
    assert np.array_equal(got["images"][..., 0], got["images"][..., 2])


def test_save_data_refuses_unknown_method(tmp_path):
    with pytest.raises(ValueError, match="Unsupported save method"):
        ppp.save_data({"images": np.zeros((1, 2, 2, 3))}, str(tmp_path),
                      "x", "npz")


def test_preprocess_cli(drive_root, tmp_path, capsys):
    out_dir = tmp_path / "data"
    port_cli.main(["--dataset-path", str(drive_root / "raw"), "--output-dir",
                   str(out_dir), "--no-test", "--save-method", "pickle",
                   "--clahe"])
    out = capsys.readouterr().out
    assert "Train split info:" in out and "Test split info:" not in out
    assert "Reloaded train split - images: 3" in out
    assert sorted(p.name for p in out_dir.iterdir()) == [
        "train_eye_dataset.pkl"]
    port_cli.main(["--dataset-path", str(drive_root / "raw"), "--output-dir",
                   str(out_dir)])
    out = capsys.readouterr().out
    assert "Reloaded test split - images: 2" in out
    _same_split(ppp.load_preprocessed_data(str(out_dir /
                                               "test_eye_dataset.h5")),
                jpp.process_data_subset(str(drive_root / "raw" / "test")))
