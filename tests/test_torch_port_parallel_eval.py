"""The port's data-parallel evaluation and validation, and one exotic
archetype's train step, on the CPU: one 2-rank gloo job
(``parallel.spawn`` of ``parallel.jobs.run``, a module-scoped fixture)
against the port in one process and against JAX's 2-device CPU mesh.

  * ``make_val_fn`` over 2 ranks on 9 patches (an uneven split, 5 + 4)
    equals the single process's probabilities and Dice within 1e-6;
  * ``tiled_predict`` (through ``Predictor(world=...)``) with the patch
    grid split over the ranks equals the single process's maps within
    1e-6 (as tests/test_parallel.py:114-131), with and without TTA;
  * MultiResUNet in s2d mode (the phase-group BatchNorm over ranks), one
    step at batch 2, patch 32, lr 1e-6, against JAX
    ``make_batch_step_fn(mesh=make_mesh(2))`` with the bounds of
    tests/test_parallel.py:210-226;
  * ``train_arrays`` over 2 ranks (one epoch with validation): the
    last validation pass's gathered probabilities are bit-identical on
    both ranks and equal ``make_val_fn`` in one process with the trained
    weights within 1e-6, and rank 0 alone writes the checkpoint;
  * ``stitch_patches_scatter`` against JAX's;
  * the eval CLI with ``--devices 2 --device cpu`` (tiled and sliding
    window) against the CLI in one process.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jcfszxc_unet_tpu.eval.tiling import (
    stitch_patches_scatter as jax_stitch_scatter,
)
from jcfszxc_unet_tpu.ops import layers as jax_layers
from jcfszxc_unet_tpu.parallel.mesh import make_mesh, put_replicated
from jcfszxc_unet_tpu.train.optim import make_optimizer as jax_make_optimizer
from jcfszxc_unet_tpu.train.state import TrainState as JaxTrainState
from jcfszxc_unet_tpu.train.trainer import (
    make_batch_step_fn as jax_batch_step_fn,
)
from jcfszxc_unet_tpu_torch.cli import evaluate as port_cli
from jcfszxc_unet_tpu_torch.compat.from_jax import state_dict_from_jax
from jcfszxc_unet_tpu_torch.data.sampler import build_grid_sample_map
from jcfszxc_unet_tpu_torch.eval.tiling import (
    stitch_patches,
    stitch_patches_scatter,
)
from jcfszxc_unet_tpu_torch.parallel import jobs, spawn
from jcfszxc_unet_tpu_torch.train.checkpoint import save_model

from .torch_port_common import jax_model

TFN = "RetinaLiteNet.TransFuseNet"
MRU = "MultiResUNet.MultiResUNet"
N, H, W, PATCH, BATCH = 3, 48, 40, 16, 8
V, CHUNK = 9, 4
MRU_PATCH, MRU_LR = 32, 1e-6


def _images(seed=0):
    rng = np.random.RandomState(seed)
    images = rng.rand(N, H, W, 3).astype(np.float32)
    labels = (rng.rand(N, H, W) > 0.8).astype(np.float32)
    images[..., 1] += 0.5 * labels
    masks = np.zeros((N, H, W), np.float32)
    masks[:, 3:-3, 3:-3] = 1.0
    return np.clip(images, 0, 1), masks, labels


def _val(seed=1):
    rng = np.random.RandomState(seed)
    return (rng.rand(V, PATCH, PATCH, 3).astype(np.float32),
            (rng.rand(V, PATCH, PATCH, 1) > 0.7).astype(np.float32))


def _mru_batch(seed=7):
    rng = np.random.RandomState(seed)
    return [(rng.rand(2, MRU_PATCH, MRU_PATCH, 3).astype(np.float32),
             (rng.rand(2, MRU_PATCH, MRU_PATCH, 1) > 0.8).astype(np.float32))]


@pytest.fixture(scope="module")
def setup():
    """TransFuseNet from JAX (random BN statistics) with its logit head,
    whose output conv is rescaled so that the tiled maps' logits have
    median 0 and std 2 (its decoder's biased convs leave the raw head's
    probabilities within ~1e-3 of each other), and MultiResUNet (s2d)
    from JAX, with their state dicts."""
    _, tvars = jax_model(TFN, seed=1, hw=PATCH)
    mmodel, mvars = jax_model(MRU, seed=2, hw=MRU_PATCH, s2d=True)

    def sd(name, variables):
        return {k: v.numpy()
                for k, v in state_dict_from_jax(name, variables).items()}

    tfn = sd(TFN, tvars)
    p = jobs.tiled_maps(None, TFN, _images()[0], patch_size=PATCH,
                        batch_size=BATCH, state_dict=tfn,
                        model_kwargs={"logit_head": True},
                        device="cpu")["maps"]
    logits = np.log(p / (1 - p))
    a = np.float32(2.0 / logits.std())
    tfn["output_BV.weight"] = tfn["output_BV.weight"] * a
    tfn["output_BV.bias"] = (tfn["output_BV.bias"]
                             - np.float32(np.median(logits))) * a
    return dict(tfn=tfn, mmodel=mmodel, mvars=mvars, mru=sd(MRU, mvars))


def _tasks(setup, save_path):
    tiled = dict(model_name=TFN, images=_images()[0], patch_size=PATCH,
                 batch_size=BATCH, state_dict=setup["tfn"],
                 model_kwargs={"logit_head": True})
    imgs, labs = _val()
    return [
        ("validation", dict(model_name=TFN, val_imgs=imgs, val_labs=labs,
                            state_dict=setup["tfn"], chunk_size=CHUNK)),
        ("tiled_maps", tiled),
        ("tiled_maps", dict(tiled, tta=True)),
        ("train_steps", dict(model_name=MRU, batches=_mru_batch(),
                             lr=MRU_LR, state_dict=setup["mru"],
                             model_kwargs={"s2d": True})),
        ("train_run", dict(model_name=TFN, images=_images()[0],
                           masks=_images()[1], labels=_images()[2],
                           save_path=save_path, val_percent=0.34,
                           patch_size=PATCH, compute_dtype=torch.float32,
                           state_dict=setup["tfn"],
                           model_kwargs={"logit_head": True}, steps=1,
                           batch_size=4, learning_rate=1e-6, max_epochs=1,
                           visualize=False)),
    ]


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    tasks = _tasks(setup,
                   str(tmp_path_factory.mktemp("train_run") / "best.pt"))
    return (spawn(jobs.run, 2, tasks, device="cpu", join_timeout_s=600),
            jobs.run(None, tasks, device="cpu"))


def test_sharded_validation_equals_one_process(ranks):
    per_rank, single = ranks
    want = single[0]
    assert want["probs"].shape == (V, PATCH, PATCH, 1)
    assert 0.0 < want["metrics"]["dice"] < 1.0
    for r in per_rank:
        got = r[0]
        np.testing.assert_allclose(got["probs"], want["probs"], rtol=0,
                                   atol=1e-6)
        for k, v in want["metrics"].items():
            assert abs(got["metrics"][k] - v) < 1e-6, k
    # the two ranks hold the same gathered values, hence the same Dice
    assert per_rank[0][0]["metrics"] == per_rank[1][0]["metrics"]


def test_train_arrays_validation_over_ranks_equals_one_process(ranks):
    """The gathered validation probabilities of the last epoch are the
    same bits on both ranks and equal the single process's forward of
    the trained weights on the same patches; they are no constant map,
    so a rank's share that went missing would show."""
    per_rank, _ = ranks
    runs = [r[4] for r in per_rank]
    assert len({r["val_digest"] for r in runs}) == 1
    assert len({r["digest"] for r in runs}) == 1
    for r in runs:
        assert r["val_max_abs_dprob"] <= 1e-6
        lo, hi = r["val_range"]
        assert hi - lo > 0.05, r["val_range"]
    assert runs[0]["saved"] and runs[1]["saved"] == []


@pytest.mark.parametrize("task", [1, 2], ids=["tiled", "tta"])
def test_sharded_tiled_predict_equals_one_process(ranks, task):
    per_rank, single = ranks
    want = single[task]["maps"]
    assert want.shape == (N, H, W) and want.std() > 0.05, want.std()
    for r in per_rank:
        np.testing.assert_allclose(r[task]["maps"], want, rtol=1e-6,
                                   atol=1e-7)


def test_multiresunet_s2d_step_matches_jax_two_device_mesh(setup, ranks):
    """Loss within 1e-5, BN running statistics rtol 1e-4 / atol 1e-6,
    parameters rtol 1e-3 / atol 5e-5 (tests/test_parallel.py:210-226),
    and the two ranks bit-identical."""
    mmodel, mvars = setup["mmodel"], setup["mvars"]
    tx = jax_make_optimizer(MRU_LR)
    mesh = make_mesh(2)
    params = put_replicated(jax.tree.map(jnp.asarray, mvars["params"]), mesh)
    state = JaxTrainState(
        params=params,
        batch_stats=put_replicated(
            jax.tree.map(jnp.asarray, mvars["batch_stats"]), mesh),
        opt_state=put_replicated(tx.init(params), mesh),
        step=jnp.zeros((), jnp.int32))
    (x, y), = _mru_batch()
    with jax_layers.dropout_disabled():
        step = jax.jit(jax_batch_step_fn(mmodel, tx, n_classes=1, mesh=mesh))
        state, loss, ok = step(state, jnp.asarray(x), jnp.asarray(y),
                               jax.random.PRNGKey(0))
    assert bool(ok)
    want = {k: v.numpy() for k, v in state_dict_from_jax(MRU, {
        "params": jax.tree.map(np.asarray, state.params),
        "batch_stats": jax.tree.map(np.asarray, state.batch_stats)}).items()}
    per_rank, _ = ranks
    got = per_rank[0][3]
    assert got["oks"] == [True]
    assert abs(got["losses"][0] - float(loss)) < 1e-5
    assert per_rank[1][3]["digest"] == got["digest"]
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        if "running" in k:
            np.testing.assert_allclose(got["state"][k], v, rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(got["state"][k], v, rtol=1e-3,
                                       atol=5e-5, err_msg=k)


def test_stitch_patches_scatter_matches_jax():
    rng = np.random.RandomState(4)
    centers = build_grid_sample_map(N, H, W, PATCH // 2)
    probs = rng.rand(len(centers), PATCH, PATCH).astype(np.float32)
    got = stitch_patches_scatter(torch.from_numpy(probs), centers, N, H, W)
    want = np.asarray(jax_stitch_scatter(jnp.asarray(probs),
                                         jnp.asarray(centers), N, H, W))
    assert got.shape == (N, H, W)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    loop = stitch_patches(torch.from_numpy(probs), centers, N, H, W)
    np.testing.assert_allclose(got.numpy(), loop.numpy(), rtol=1e-6,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# The eval CLI over 2 ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def split(setup, tmp_path_factory):
    """The 3-image split as h5 and TransFuseNet's checkpoint (logit
    head, recorded in its model_kwargs)."""
    import h5py

    root = tmp_path_factory.mktemp("split")
    images, masks, labels = _images()
    path = str(root / "test_eye_dataset.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("images", data=images)
        f.create_dataset("masks", data=masks)
        f.create_dataset("labels", data=labels)
        f.create_dataset("filenames", data=np.array(
            [f"{i}_test.tif" for i in range(N)],
            dtype=h5py.special_dtype(vlen=str)))
    model = jobs.build_model(TFN, torch.device("cpu"),
                             state_dict=setup["tfn"],
                             model_kwargs={"logit_head": True})
    ckpt = str(root / "tfn.pt")
    save_model(ckpt, TFN, {"logit_head": True}, model)
    return path, ckpt


@pytest.mark.parametrize("protocol", [[], ["--sliding-window", "-n", "3"]],
                         ids=["tiled", "sliding"])
def test_eval_cli_over_two_ranks_equals_one_process(split, tmp_path,
                                                   monkeypatch, capfd,
                                                   protocol):
    """Rank 0 alone prints and writes; its metrics equal the one-process
    CLI's (per-image Dice and AUC within 1e-6)."""
    h5, ckpt = split
    recs = {}
    for devices in ("1", "2"):
        out = tmp_path / devices
        out.mkdir()
        monkeypatch.chdir(out)
        port_cli.main(["-m", ckpt, "-d", h5, "-p", str(PATCH),
                       "--inference-batch-size", str(BATCH), "--dtype",
                       "float32", "--device", "cpu", "--devices", devices,
                       "--dist-timeout", "60",
                       "--overlap", "0.5", "-o", str(out / "preds"),
                       "--metrics-json", str(out / "m.json"), *protocol])
        recs[devices] = json.loads(open(out / "m.json").read())
        assert (out / "preds" / "prediction_2.png").exists()
        assert capfd.readouterr().out.count("Average Dice Score") == 1
    assert recs["2"]["n_images"] == N
    np.testing.assert_allclose(recs["2"]["per_image_dice"],
                               recs["1"]["per_image_dice"], atol=1e-6)
    np.testing.assert_allclose(recs["2"]["per_image_auc"],
                               recs["1"]["per_image_auc"], atol=1e-6)
