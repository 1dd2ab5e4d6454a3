"""The port's evaluation slice end to end against the JAX package (CPU, f32):
tiled prediction, eval_model on an h5 split, the metrics, the CLI, and the
rule that a CUDA default never falls back to the CPU.

The split holds 2 images of 64 x 48; patch 32 gives 6 overlapping patches
per image and inference batch 5 leaves a short tail chunk.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jcfszxc_unet_tpu.cli.evaluate import eval_model as jax_eval_model
from jcfszxc_unet_tpu.data.sampler import (
    build_grid_sample_map as jax_grid,
    extract_patches as jax_extract,
)
from jcfszxc_unet_tpu.eval import metrics as jax_metrics
from jcfszxc_unet_tpu.eval.tiling import tiled_predict as jax_tiled_predict
from jcfszxc_unet_tpu_torch.cli import evaluate as port_cli
from jcfszxc_unet_tpu_torch.cli.evaluate import eval_model
from jcfszxc_unet_tpu_torch.eval import metrics
from jcfszxc_unet_tpu_torch.eval.predictor import Predictor
from jcfszxc_unet_tpu_torch.eval.tiling import tiled_predict
from jcfszxc_unet_tpu_torch.ops.kernels import dice_fused
from jcfszxc_unet_tpu_torch.train.checkpoint import save_model

from .torch_port_common import jax_unet, port_unet

N, H, W, PATCH, BATCH = 2, 64, 48, 32, 5


def _split(seed=0):
    rng = np.random.RandomState(seed)
    labels = np.zeros((N, H, W), np.float32)
    for i in range(N):
        y, x = H // 2, W // 2
        for _ in range(H * W // 3):
            labels[i, y, x] = 1.0
            y = int(np.clip(y + rng.randint(-2, 3), 1, H - 2))
            x = int(np.clip(x + rng.randint(-2, 3), 1, W - 2))
    images = (0.5 * rng.rand(N, H, W, 3)).astype(np.float32)
    images[..., 1] += 0.4 * labels
    masks = np.zeros((N, H, W), np.float32)
    masks[:, 4:-4, 4:-4] = 1.0
    return images, masks, labels


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX UNet whose BatchNorm variances are scaled down so activations
    keep their size through the 18 convs, and whose head is rescaled so
    the probabilities spread over (0, 1) around the 0.5 cut; the same
    weights in the port; the split written as h5 in the preprocessing
    schema."""
    import h5py

    images, masks, labels = _split()
    jmodel, variables = jax_unet(seed=2, hw=PATCH)

    def scale_var(stats):
        for k, v in stats.items():
            if k == "bn":
                v["var"] = (0.15 * v["var"]).astype(np.float32)
            else:
                scale_var(v)

    scale_var(variables["batch_stats"])
    centers = jnp.asarray(jax_grid(N, H, W, PATCH // 2))
    patches = jax_extract(jnp.asarray(images), centers, PATCH)
    logits = np.asarray(jmodel.apply(variables, patches, train=False))
    med, std = float(np.median(logits)), float(logits.std())
    head = variables["params"]["outc"]["Conv2d_0"]["conv"]
    a = 4.0 / std
    head["kernel"] = (head["kernel"] * a).astype(np.float32)
    head["bias"] = ((head["bias"] - med) * a).astype(np.float32)

    path = str(tmp_path_factory.mktemp("split") / "test_eye_dataset.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("images", data=images)
        f.create_dataset("masks", data=masks)
        f.create_dataset("labels", data=labels)
        f.create_dataset("filenames", data=np.array(
            [f"{i}_test.tif" for i in range(N)],
            dtype=h5py.special_dtype(vlen=str)))

    def jax_forward(batch):
        return jax.nn.sigmoid(jmodel.apply(variables, batch, train=False))

    jax_maps = np.asarray(jax_tiled_predict(
        jax_forward, jnp.asarray(images), PATCH, BATCH))
    return dict(jmodel=jmodel, variables=variables, port=port_unet(variables),
                images=images, masks=masks, labels=labels, h5=path,
                jax_maps=jax_maps)


def test_tiled_predict_matches_jax(setup):
    port = setup["port"]

    def forward(batch):
        logits = port(batch.permute(0, 3, 1, 2))
        return torch.sigmoid(logits).permute(0, 2, 3, 1)

    with torch.no_grad():
        got = tiled_predict(forward, torch.from_numpy(setup["images"]),
                            PATCH, BATCH)
    assert got.shape == (N, H, W)
    np.testing.assert_allclose(got.numpy(), setup["jax_maps"], atol=1e-5,
                               rtol=0)
    # the stitched maps are not degenerate: both sides of the 0.5 cut
    fov = setup["jax_maps"][setup["masks"] > 0]
    assert (fov > 0.5).mean() > 0.05 and (fov < 0.5).mean() > 0.05


def test_eval_model_matches_jax(setup, tmp_path):
    masked = setup["jax_maps"] * setup["masks"]
    # a pixel this close to the cut could binarize differently on the two
    # sides within their f32 agreement; the chosen seed has none
    assert np.abs(masked - 0.5).min() > 1e-4
    j_mean, j_dice, j_auc = jax_eval_model(
        setup["jmodel"], setup["variables"], str(tmp_path / "jax"),
        input_data=setup["h5"], patch_size=PATCH,
        inference_batch_size=BATCH, compute_dtype=jnp.float32,
        visualize=False)
    before = dice_fused.counter.launches
    p_mean, p_dice, p_auc = eval_model(
        setup["port"], str(tmp_path / "port"), input_data=setup["h5"],
        patch_size=PATCH, inference_batch_size=BATCH,
        compute_dtype=torch.float32, visualize=False, device="cpu")
    assert dice_fused.counter.launches == before  # CPU: plain version
    assert len(p_dice) == N and 0.05 < min(p_dice)
    np.testing.assert_allclose(p_dice, j_dice, atol=1e-6, rtol=0)
    np.testing.assert_allclose(p_mean, j_mean, atol=1e-6, rtol=0)
    np.testing.assert_allclose(p_auc, j_auc, atol=1e-3, rtol=0)


def test_metrics_match_jax():
    rng = np.random.RandomState(11)
    scores = rng.rand(3, 20, 17).astype(np.float32)
    target = (rng.rand(3, 20, 17) > 0.7).astype(np.float32)
    mask = (rng.rand(3, 20, 17) > 0.2).astype(np.float32)
    binary = (scores > 0.5).astype(np.float32)
    got = metrics.binary_dice(torch.from_numpy(binary),
                              torch.from_numpy(target))
    want = [float(jax_metrics.binary_dice(jnp.asarray(binary[i]),
                                          jnp.asarray(target[i])))
            for i in range(3)]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    for i in range(3):
        s, t, m = (torch.from_numpy(a[i]) for a in (scores, target, mask))
        np.testing.assert_allclose(
            float(metrics.roc_auc(s, t, m)),
            float(jax_metrics.roc_auc(jnp.asarray(scores[i]),
                                      jnp.asarray(target[i]),
                                      jnp.asarray(mask[i]))), atol=1e-6)
        np.testing.assert_allclose(
            [float(v) for v in metrics.classification_metrics(
                torch.from_numpy(binary[i]), t, m)],
            [float(v) for v in jax_metrics.classification_metrics(
                jnp.asarray(binary[i]), jnp.asarray(target[i]),
                jnp.asarray(mask[i]))], atol=1e-6)
    # no positives: AUC is 0.5, as in the JAX version
    assert float(metrics.roc_auc(torch.rand(5, 5), torch.zeros(5, 5))) == 0.5


def test_cuda_default_raises_without_a_gpu(setup, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        eval_model(setup["port"], str(tmp_path), input_data=setup["h5"],
                   patch_size=PATCH, visualize=False, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(setup["port"])  # device defaults to cuda


def test_cli_runs_the_tiled_protocol(setup, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ckpt = str(tmp_path / "unet.pt")
    save_model(ckpt, "UNet.UNet", {}, setup["port"])
    pred = Predictor.from_checkpoint(
        ckpt, device="cpu", compute_dtype=torch.float32, patch_size=PATCH,
        inference_batch_size=BATCH)
    np.testing.assert_allclose(
        pred.predict_images(setup["images"]).numpy(), setup["jax_maps"],
        atol=1e-5, rtol=0)
    out_json = str(tmp_path / "metrics.json")
    port_cli.main(["-m", ckpt, "-d", setup["h5"], "-p", str(PATCH),
                   "--inference-batch-size", str(BATCH), "--dtype", "float32",
                   "--device", "cpu", "-o", str(tmp_path / "preds"),
                   "--full-metrics", "--threshold-sweep",
                   "--metrics-json", out_json])
    rec = json.loads(open(out_json).read())
    _, want, _ = eval_model(setup["port"], str(tmp_path), setup["h5"],
                            patch_size=PATCH, inference_batch_size=BATCH,
                            visualize=False, device="cpu")
    np.testing.assert_allclose(rec["per_image_dice"], want, atol=1e-7)
    assert rec["n_images"] == N and 0 <= rec["accuracy"] <= 1
    assert len(rec["threshold_sweep"]["rows"]) == 9
    assert os.path.exists(tmp_path / "preds" / "prediction_1.png")
    assert os.path.exists(tmp_path / "demo" / "label_0.png")


@pytest.mark.parametrize("flag", [["--spatial"], ["--sliding-window"],
                                  ["--tta"], ["--s2d"], ["--devices", "2"]])
def test_cli_refuses_unported_protocols(flag):
    with pytest.raises(SystemExit, match="not ported"):
        port_cli.main(["--device", "cpu", *flag])


def test_patch_larger_than_image_raises():
    with pytest.raises(ValueError, match="exceeds the image size"):
        tiled_predict(lambda b: b[..., :1], torch.zeros(1, 16, 16, 3), 32)
