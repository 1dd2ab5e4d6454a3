"""The port's fractal trainer against the JAX package's: one train step of
TransFuseNet plus the extractor on an explicit batch, the whole-image
validation of UNet at an odd size, the engine end to end on a tiny
dataset (checkpoints, empty validation, the seeded split) and the
train-demo CLI."""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jcfszxc_unet_tpu.ops import layers as jax_layers
from jcfszxc_unet_tpu.train import fractal as jfr
from jcfszxc_unet_tpu.train.losses import dice_coeff as jax_dice_coeff
from jcfszxc_unet_tpu.train.optim import make_optimizer as jax_make_optimizer
from jcfszxc_unet_tpu_torch.cli import train_demo
from jcfszxc_unet_tpu_torch.compat.from_jax import (
    block_state_dict_from_jax,
    state_dict_from_jax,
)
from jcfszxc_unet_tpu_torch.ops.kernels import conv_fused, dice_fused
from jcfszxc_unet_tpu_torch.train import fractal as pfr
from jcfszxc_unet_tpu_torch.train.checkpoint import load_extra, load_model_any
from jcfszxc_unet_tpu_torch.train.optim import make_optimizer

from .torch_port_common import (
    STATS_TOL,
    TRAIN_TOL,
    assert_close_to,
    jax_model,
    jax_unet,
    port_model,
    port_unet,
    silence_dropout,
)

TRANSFUSE = "RetinaLiteNet.TransFuseNet"


def _jax_extractor(seed, hw=32):
    jext = jfr.FractalFeatureExtractor(3)
    variables = jax.jit(jext.init)(jax.random.PRNGKey(seed),
                                   jnp.zeros((1, hw, hw, 3), jnp.float32))
    return jext, jax.tree.map(np.asarray, variables)


def _port_extractor(variables):
    ext = pfr.FractalFeatureExtractor(3)
    ext.load_state_dict(block_state_dict_from_jax(
        "FractalFeatureExtractor", variables), strict=True)
    return ext.to(memory_format=torch.channels_last)


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------

def test_train_step_against_jax(monkeypatch):
    """TransFuseNet + extractor, f32, lr 1e-3, batch 8 of 32^2 on an
    explicit batch, JAX's permutation for the dimension term: the loss
    within 1e-5 relative; after the step every parameter within the zoo
    train tests' tolerance (TRAIN_TOL of max |param|), the updates within
    0.1 relative L2 (tests/test_torch_port_train.py), and the BN running
    statistics within STATS_TOL.  TransFuseNet's unused ``output_OD`` head
    is held like every other parameter: its gradient is 0 in both
    frameworks, and both step it by weight decay and momentum."""
    monkeypatch.setattr(jax_layers, "TRAIN_BN_ONE_PASS_STATS", False)
    lr, b = 1e-3, 8
    jmodel, mvars = jax_model(TRANSFUSE, seed=0, hw=32)
    jext, evars = _jax_extractor(1)
    rng = np.random.RandomState(11)
    imgs = rng.rand(b, 32, 32, 3).astype(np.float32)
    tgts = (rng.rand(b, 32, 32, 1) > 0.4).astype(np.float32)
    k_frac = jax.random.PRNGKey(7)
    idx = np.asarray(jax.random.permutation(k_frac, b))[:4]

    tx = jax_make_optimizer(lr)
    params = {"model": mvars["params"], "extractor": evars["params"]}

    @jax.jit
    def jstep(params, batch_stats, x, y):
        def loss_fn(params):
            enhanced = jext.apply({"params": params["extractor"]}, x)
            out, mut = jmodel.apply(
                {"params": params["model"], "batch_stats": batch_stats},
                enhanced, train=True, mutable=["batch_stats"])
            return jfr.fractal_loss(out, y, k_frac), mut["batch_stats"]

        (loss, new_bs), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        updates, _ = tx.update(grads, tx.init(params), params)
        return loss, optax.apply_updates(params, updates), new_bs

    with jax_layers.dropout_disabled():
        loss_j, new_params, new_bs = jstep(
            params, mvars["batch_stats"], jnp.asarray(imgs),
            jnp.asarray(tgts))

    model = silence_dropout(port_model(TRANSFUSE, mvars).train())
    ext = _port_extractor(evars)
    before = {**{f"m.{k}": v.clone() for k, v in model.state_dict().items()},
              **{f"e.{k}": v.clone() for k, v in ext.state_dict().items()}}
    opt = make_optimizer(list(model.parameters()) + list(ext.parameters()),
                         lr)
    step = pfr.make_fractal_step_fn(model, ext, opt)
    loss_p, ok = step(torch.from_numpy(imgs), torch.from_numpy(tgts),
                      torch.from_numpy(idx.astype(np.int64)))
    assert ok
    np.testing.assert_allclose(float(loss_p), float(loss_j), rtol=1e-5)

    want = {**{f"m.{k}": v for k, v in state_dict_from_jax(TRANSFUSE, {
                "params": jax.tree.map(np.asarray, new_params["model"]),
                "batch_stats": jax.tree.map(np.asarray, new_bs)}).items()},
            **{f"e.{k}": v for k, v in block_state_dict_from_jax(
                "FractalFeatureExtractor", {"params": jax.tree.map(
                    np.asarray, new_params["extractor"])}).items()}}
    got = {**{f"m.{k}": v for k, v in model.state_dict().items()},
           **{f"e.{k}": v for k, v in ext.state_dict().items()}}
    assert sorted(got) == sorted(want)
    num = den = 0.0
    compared = 0
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        tol = STATS_TOL if "running" in k else TRAIN_TOL
        assert_close_to(got[k].numpy(), w.numpy(), tol)
        if "running" not in k:
            dp = (got[k] - before[k]).double()
            dj = (w - before[k]).double()
            num += float(((dp - dj) ** 2).sum())
            den += float((dj ** 2).sum())
        compared += 1
    assert compared > 40 and den > 0.0
    assert (num / den) ** 0.5 < 0.1
    # the extractor's weights moved (its gradient flows through the model)
    assert not torch.equal(got["e.fractal_conv1.weight"],
                           before["e.fractal_conv1.weight"])


def test_nan_batch_skips_the_update():
    """A NaN in the batch: ok is False, the loss 0, parameters and the
    optimizer state as they were (JAX selects the old state)."""
    _, mvars = jax_model(TRANSFUSE, seed=0, hw=32)
    _, evars = _jax_extractor(1)
    model = port_model(TRANSFUSE, mvars).train()
    ext = _port_extractor(evars)
    opt = make_optimizer(list(model.parameters()) + list(ext.parameters()),
                         1e-3)
    step = pfr.make_fractal_step_fn(model, ext, opt)
    rng = np.random.RandomState(12)
    x = torch.from_numpy(rng.rand(4, 32, 32, 3).astype(np.float32))
    y = torch.from_numpy((rng.rand(4, 32, 32, 1) > 0.5).astype(np.float32))
    idx = torch.arange(4)
    assert step(x, y, idx)[1]
    params = [p.detach().clone() for g in opt.param_groups
              for p in g["params"]]
    state = [{k: v.clone() for k, v in s.items()}
             for s in opt.state.values()]
    bad = x.clone()
    bad[1, 3, 4, 0] = float("nan")
    loss, ok = step(bad, y, idx)
    assert not ok and float(loss) == 0.0
    for p, q in zip((p for g in opt.param_groups for p in g["params"]),
                    params):
        assert torch.equal(p, q) and p.grad is None
    for s, before in zip(opt.state.values(), state):
        for k, v in before.items():
            assert torch.equal(s[k], v), k


# ---------------------------------------------------------------------------
# whole-image validation at an odd size
# ---------------------------------------------------------------------------

def test_whole_image_validation_against_jax(monkeypatch):
    """UNet + extractor on 3 whole 36 x 35 images (pools floor to 2 x 2,
    ``Up`` pads back) in chunks of 2: probabilities and the mean
    per-image Dice against the JAX val_fn's computation, to 1e-5; each
    chunk makes one call of the conv kernel's entry for the extractor and
    18 for UNet, and the Dice one call of the sums."""
    from jcfszxc_unet_tpu_torch.ops import blocks

    jmodel, mvars = jax_unet(seed=2, hw=32)
    jext, evars = _jax_extractor(3)
    rng = np.random.RandomState(13)
    vi = rng.rand(3, 36, 35, 3).astype(np.float32)
    vm = np.zeros((3, 36, 35, 1), np.float32)
    vm[:, 4:-4, 5:-5] = 1.0  # a FOV mask: the trainer's targets

    @jax.jit
    def jval(x, m):
        enhanced = jext.apply(evars, x)
        out = jmodel.apply(mvars, enhanced, train=False)
        probs = jax.nn.sigmoid(out.astype(jnp.float32))
        binary = (probs > 0.5).astype(jnp.float32)
        return jax_dice_coeff(jnp.squeeze(binary, -1), jnp.squeeze(m, -1),
                              reduce_batch_first=False), probs

    want_d, want_p = jval(jnp.asarray(vi), jnp.asarray(vm))
    model = port_unet(mvars).train()
    ext = _port_extractor(evars)
    calls, sums = [], []
    for mod, name, log in ((blocks, "conv3x3_affine_relu_kmajor", calls),
                           (pfr, "dice_coeff_hard", sums)):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, real=real, log=log, **k: (
            log.append((tuple(a[0].shape), a[1].shape[0])),
            real(*a, **k))[1])
    before = conv_fused.counter.launches + dice_fused.counter.launches
    dice, probs = pfr.make_fractal_val_fn(model, ext, chunk_size=2)(
        torch.from_numpy(vi), torch.from_numpy(vm))
    assert model.training and ext.training  # modes put back
    assert conv_fused.counter.launches + dice_fused.counter.launches == before
    assert len(calls) == 2 * 19 and len(sums) == 1
    # per chunk: the extractor's stacked 3 -> 32 conv, then UNet's 18
    assert calls[0] == ((2, 36, 35, 3), 32) and calls[19] == ((1, 36, 35, 3),
                                                              32)
    assert calls[1] == ((2, 36, 35, 3), 64)
    assert probs.shape == (3, 36, 35, 1)
    np.testing.assert_allclose(probs.numpy(), np.asarray(want_p), rtol=0,
                               atol=1e-5)
    assert 0.01 < float((probs > 0.5).float().mean()) < 0.99
    np.testing.assert_allclose(float(dice), float(want_d), rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the engine end to end, the split, the CLI
# ---------------------------------------------------------------------------

def _pickle_split(path, n=4, h=64, w=64, seed=0):
    rng = np.random.RandomState(seed)
    data = {"images": rng.rand(n, h, w, 3).astype(np.float32),
            "masks": (rng.rand(n, h, w) > 0.3).astype(np.float32),
            "labels": (rng.rand(n, h, w) > 0.8).astype(np.float32),
            "filenames": [f"{i}.tif" for i in range(n)]}
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return str(path)


KW = dict(steps=2, batch_size=8, patch_size=32, learning_rate=1e-3,
          max_epochs=1)


def test_engine_one_epoch_writes_both_checkpoints(tmp_path, capsys):
    from jcfszxc_unet_tpu_torch.models import create_model

    data = _pickle_split(tmp_path / "train.pkl")
    save, bundle = str(tmp_path / "best.ckpt"), str(tmp_path / "bundle.ckpt")
    model = create_model(TRANSFUSE)
    best = pfr.train_with_fractal_optimization(
        model, TRANSFUSE, input_data=data, val_percent=0.25,
        compute_dtype=torch.float32, visualize=False, save_path=save,
        bundle_path=bundle, device="cpu", **KW)
    assert np.isfinite(best) and best > 0.0
    out = capsys.readouterr().out
    assert "New best dice score" in out and "Epoch 1 - LR: 1.00e-03" in out
    loaded, cfg = load_model_any(save, device="cpu")
    assert cfg["model_name"] == TRANSFUSE
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    extra = load_extra(bundle)
    assert set(extra) == {"extractor", "optimizer"}
    ext = pfr.FractalFeatureExtractor(3)
    ext.load_state_dict(extra["extractor"], strict=True)
    # RMSprop over model and extractor: one state per parameter, as optax
    # steps every leaf (TransFuseNet's unused output_OD head with a zero
    # gradient)
    n_params = (sum(1 for _ in model.parameters())
                + sum(1 for _ in ext.parameters()))
    assert len(extra["optimizer"]["state"]) == n_params


def test_engine_empty_validation_reports_zero(tmp_path, capsys):
    from jcfszxc_unet_tpu_torch.models import create_model

    data = _pickle_split(tmp_path / "train.pkl", n=3, seed=1)
    best = pfr.train_with_fractal_optimization(
        create_model(TRANSFUSE), TRANSFUSE, input_data=data, val_percent=0.0,
        compute_dtype=torch.float32, visualize=False,
        save_path=str(tmp_path / "best.ckpt"),
        bundle_path=str(tmp_path / "bundle.ckpt"), device="cpu", **KW)
    assert best == 0.0
    out = capsys.readouterr().out
    assert "nan" not in out and "Dice: 0" in out
    assert not os.path.exists(tmp_path / "best.ckpt")


def test_engine_triptych_every_fifth_epoch(tmp_path, monkeypatch):
    from jcfszxc_unet_tpu_torch.models import create_model

    monkeypatch.chdir(tmp_path)
    with open(_pickle_split(tmp_path / "train.pkl", n=4, h=48, w=48,
                            seed=2), "rb") as f:
        data = pickle.load(f)
    res = pfr.fractal_train_arrays(
        create_model(TRANSFUSE), data["images"], data["masks"], steps=1,
        batch_size=4, patch_size=16, learning_rate=1e-3, val_percent=0.5,
        max_epochs=5, compute_dtype=torch.float32,
        save_path=str(tmp_path / "b.ckpt"),
        bundle_path=str(tmp_path / "f.ckpt"), async_checkpoints=False,
        device="cpu")
    assert [r["epoch"] for r in res["history"]] == [1, 2, 3, 4, 5]
    ends = [r["train_end_seconds"] for r in res["history"]]
    assert ends[0] >= res["history"][0]["train_seconds"]
    assert all(a < b for a, b in zip(ends, ends[1:]))
    assert all(r["skipped_steps"] == 0 and np.isfinite(r["loss"])
               for r in res["history"])
    assert len(list((tmp_path / "visualizations").glob(
        "fractal_005_*.png"))) == 1


class _Stop(Exception):
    pass


def _train_masks(module, call, monkeypatch):
    """The masks (in train order) the trainer builds its sample maps from:
    the split, read where the maps are built."""
    seen = []

    def spy(masks, patch_size, *a, **k):
        seen.append(np.array(masks))
        raise _Stop

    monkeypatch.setattr(module, "build_fractal_sample_maps", spy)
    with pytest.raises(_Stop):
        call()
    return seen[0]


@pytest.mark.parametrize("val_percent", [0.25, 0.5])
def test_split_equals_jax(tmp_path, monkeypatch, val_percent):
    from jcfszxc_unet_tpu.models import create_model as jax_create
    from jcfszxc_unet_tpu_torch.models import create_model

    data = _pickle_split(tmp_path / "train.pkl", n=8, h=16, w=16, seed=3)
    kw = dict(input_data=data, val_percent=val_percent, seed=5,
              visualize=False)
    got = _train_masks(pfr, lambda: pfr.train_with_fractal_optimization(
        create_model(TRANSFUSE), TRANSFUSE, device="cpu", **kw), monkeypatch)
    want = _train_masks(jfr, lambda: jfr.train_with_fractal_optimization(
        jax_create(TRANSFUSE), TRANSFUSE, **kw), monkeypatch)
    assert got.shape[0] == 8 - int(8 * val_percent)
    np.testing.assert_array_equal(got, want)


def test_train_demo_cli(tmp_path, monkeypatch, capsys):
    """``cli.train_demo`` on the CPU writes both checkpoints in the working
    directory; ``--load`` takes them back through ``load_model_any``, here
    with ``--sync-checkpoints``."""
    monkeypatch.chdir(tmp_path)
    data = _pickle_split(tmp_path / "train.pkl", seed=4)
    args = ["-d", data, "--device", "cpu", "-m", TRANSFUSE, "-p", "32",
            "-b", "8", "-s", "2", "--max-epochs", "1", "--dtype", "float32",
            "-v", "25", "-l", "1e-3"]
    train_demo.main(args)
    assert os.path.exists("best_model.ckpt")
    assert set(load_extra("best_fractal_model.ckpt")) == {"extractor",
                                                          "optimizer"}
    assert os.path.isdir("visualizations")
    os.rename("best_model.ckpt", "start.ckpt")
    os.remove("best_fractal_model.ckpt")
    train_demo.main(args + ["-f", "start.ckpt", "--sync-checkpoints"])
    assert "Epoch 1 - " in capsys.readouterr().out
    assert os.path.exists("best_model.ckpt")
    assert set(load_extra("best_fractal_model.ckpt")) == {"extractor",
                                                          "optimizer"}


def test_train_demo_cli_refuses_unknown_model_and_needs_a_card():
    with pytest.raises(SystemExit, match="UNet.UNet"):
        train_demo.main(["--device", "cpu", "-m", "NoSuch.Net"])
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_demo.main(["-m", TRANSFUSE])
