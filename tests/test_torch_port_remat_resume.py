"""``--remat`` and ``--resume`` from a JAX ``.ckpt`` in the port's trainer,
against the JAX package (CPU, f32):

* a remat step (``make_batch_step_fn(remat=True)``: the whole train-mode
  forward checkpointed, its activations recomputed in the backward)
  against a plain step, with dropout live, and against JAX's remat step
  on an explicit batch;
* the optax state of a JAX ``--latest-path`` file mapped to torch's
  RMSprop (``compat/optax_state.py``), one step from it in each framework
  on the same batch, and the progress the trainer restores.

The JAX ``--latest-path`` fixture, ``tests/torch_port_data/
transfusenet_jax_latest.ckpt``, is written by the JAX package's train CLI
(:func:`write_jax_latest_fixture`; ``python -m
tests.test_torch_port_remat_resume`` rewrites it).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from jcfszxc_unet_tpu.models import create_model as jax_create_model
from jcfszxc_unet_tpu.ops import layers as jax_layers
from jcfszxc_unet_tpu.train import checkpoint as jax_ckpt
from jcfszxc_unet_tpu.train.optim import make_optimizer as jax_make_optimizer
from jcfszxc_unet_tpu.train.state import TrainState as JaxTrainState
from jcfszxc_unet_tpu.train.trainer import (
    make_batch_step_fn as jax_batch_step_fn,
)
from jcfszxc_unet_tpu_torch.cli import train as port_cli
from jcfszxc_unet_tpu_torch.compat.from_jax import state_dict_from_jax
from jcfszxc_unet_tpu_torch.compat.optax_state import rmsprop_state_dict
from jcfszxc_unet_tpu_torch.models import create_model
from jcfszxc_unet_tpu_torch.ops.layers import reset_parameters
from jcfszxc_unet_tpu_torch.train import checkpoint as ckpt
from jcfszxc_unet_tpu_torch.train.optim import clip_and_step, make_optimizer
from jcfszxc_unet_tpu_torch.train.state import TrainState
from jcfszxc_unet_tpu_torch.train.trainer import make_batch_step_fn

from .test_e2e import make_synthetic_drive
from .torch_port_common import (
    DATA_DIR,
    FIXTURE_MODEL,
    jax_unet,
    port_unet,
    silence_dropout,
)

JAX_LATEST = DATA_DIR / "transfusenet_jax_latest.ckpt"
LATEST_LR, LATEST_PATCH = 1e-4, 32
SZ, B, LR = 32, 2, 1e-6  # the batch step tests of test_torch_port_train.py


def write_jax_latest_fixture(path=JAX_LATEST, workdir=None):
    """The JAX train CLI's ``--latest-path`` file after one epoch of two
    steps: TransFuseNet with its logit head on the synthetic DRIVE split
    (batch 2, patch 32, f32, lr 1e-4, 50 % validation)."""
    import tempfile

    from jcfszxc_unet_tpu.cli.train import train_model
    from jcfszxc_unet_tpu.data.preprocess import preprocess_dataset

    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        make_synthetic_drive(f"{tmp}/raw")
        info = preprocess_dataset(dataset_path=f"{tmp}/raw",
                                  output_dir=f"{tmp}/data",
                                  save_method="h5", include_test=False)
        model = jax_create_model(FIXTURE_MODEL, dtype=jnp.float32,
                                 logit_head=True)
        train_model(model, FIXTURE_MODEL, {"logit_head": True},
                    input_data=info["train"]["output_file"], steps=2,
                    batch_size=2, patch_size=LATEST_PATCH,
                    learning_rate=LATEST_LR, val_percent=0.5, max_epochs=1,
                    compute_dtype=jnp.float32, visualize=False,
                    save_path=f"{tmp}/best.ckpt", latest_path=str(path),
                    async_checkpoints=False)


def _batch(seed, sz=SZ):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, sz, sz, 3).astype(np.float32)
    y = (rng.rand(B, sz, sz, 1) > 0.7).astype(np.float32)
    return x, y


def _opt_state_equal(a, b, tol=0.0):
    sa, sb = a.state_dict()["state"], b.state_dict()["state"]
    assert sorted(sa) == sorted(sb)
    for i in sa:
        for k in ("step", "square_avg", "momentum_buffer"):
            np.testing.assert_allclose(sa[i][k].numpy(), sb[i][k].numpy(),
                                       rtol=tol, atol=tol, err_msg=(i, k))


# ---------------------------------------------------------------------------
# --remat
# ---------------------------------------------------------------------------

def _unet_and_batch():
    _, variables = jax_unet(seed=5, hw=SZ)
    return variables, _batch(6)


def _frunet_s2d_live_dropout():
    g = torch.Generator().manual_seed(11)
    model = create_model("FRUNet.FRUNet", s2d=True)
    reset_parameters(model, g)
    return model.state_dict(), _batch(12)


@pytest.mark.parametrize("case", ["unet", "frunet_s2d_dropout"])
def test_remat_step_equals_the_plain_step(case):
    """One step each way from the same state and RNG: parameters, BN
    running statistics, batch counts (once per step) and RMSprop state
    within 1e-6.  FRUNet in s2d mode keeps its Dropout2d live, so the
    recomputation must draw the first pass's masks again."""
    if case == "unet":
        variables, (x, y) = _unet_and_batch()

        def build():
            return port_unet(variables).train()
    else:
        sd, (x, y) = _frunet_s2d_live_dropout()

        def build():
            m = create_model("FRUNet.FRUNet", s2d=True)
            m.load_state_dict(sd, strict=True)
            return m.train()
    states = []
    for remat in (False, True):
        model = build()
        state = TrainState(model, make_optimizer(model.parameters(), 1e-3))
        step = make_batch_step_fn(n_classes=1, remat=remat)
        torch.manual_seed(7)
        loss, ok = step(state, torch.from_numpy(x), torch.from_numpy(y))
        assert ok and np.isfinite(float(loss))
        states.append((float(loss), state))
    (loss_p, plain), (loss_r, remat) = states
    assert abs(loss_p - loss_r) <= 1e-6
    sd_p, sd_r = plain.model.state_dict(), remat.model.state_dict()
    for k, v in sd_p.items():
        if k.endswith("num_batches_tracked"):
            assert int(v) == int(sd_r[k]) == 1, k
        else:
            np.testing.assert_allclose(sd_r[k].numpy(), v.numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    _opt_state_equal(plain.optimizer, remat.optimizer, 1e-6)


def test_remat_step_matches_jax_remat_step():
    """UNet at 32^2, batch 2, f32, lr 1e-6: one remat step in each
    framework on an explicit batch, with the tolerances of the plain
    3-step trajectory test (loss 1e-5, parameter deltas 0.1 relative L2,
    running statistics 1e-3)."""
    jmodel, variables = jax_unet(seed=5, hw=SZ)
    tx = jax_make_optimizer(LR)
    jstep = jax.jit(jax_batch_step_fn(jmodel, tx, n_classes=1, remat=True))
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = JaxTrainState(
        params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    x, y = _batch(6)
    jstate, loss_j, ok_j = jstep(jstate, jnp.asarray(x), jnp.asarray(y),
                                 jax.random.PRNGKey(0))
    model = port_unet(variables).train()
    state = TrainState(model, make_optimizer(model.parameters(), LR))
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    loss_p, ok_p = make_batch_step_fn(n_classes=1, remat=True)(
        state, torch.from_numpy(x), torch.from_numpy(y))
    assert bool(ok_j) and ok_p
    assert abs(float(loss_p) - float(loss_j)) < 1e-5
    sd_j = state_dict_from_jax("UNet.UNet", {
        "params": jax.tree.map(np.asarray, jstate.params),
        "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)})
    sd_p = model.state_dict()
    num = den = 0.0
    for k, _ in model.named_parameters():
        dp, dj = (sd_p[k] - sd0[k]).double(), (sd_j[k] - sd0[k]).double()
        num += float(((dp - dj) ** 2).sum())
        den += float((dj ** 2).sum())
    assert den > 0.0 and (num / den) ** 0.5 < 0.1
    for k in sd_p:
        if "running" in k:
            np.testing.assert_allclose(sd_p[k].numpy(), sd_j[k].numpy(),
                                       rtol=1e-3, atol=1e-3, err_msg=k)
        elif k.endswith("num_batches_tracked"):
            assert int(sd_p[k]) == 1, k


# ---------------------------------------------------------------------------
# --resume from a JAX --latest-path file
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def latest():
    """The fixture read by the JAX package: (config, variables, extra)."""
    model, variables, config = jax_ckpt.load_model(str(JAX_LATEST))
    return (config, jax.tree.map(np.asarray, variables),
            jax_ckpt.load_extra(str(JAX_LATEST)))


def _port_resumed(path=str(JAX_LATEST)):
    model, config = ckpt.load_model_any(path, device="cpu")
    model.train()
    opt = make_optimizer(model.parameters(), 1e-6)
    extra = ckpt.resume_state(path, config["model_name"], model, opt)
    opt.load_state_dict(extra["optimizer"])
    return model, opt, extra


def test_optax_state_maps_leaf_for_leaf(latest):
    """nu -> square_avg, trace -> momentum_buffer (through the weights'
    key rules and transposes, bit for bit), count -> step, the injected
    learning rate -> lr."""
    config, variables, extra = latest
    assert config == {"model_name": FIXTURE_MODEL,
                      "model_kwargs": {"logit_head": True}}
    opt_state = extra["opt_state"]
    model, opt, _ = _port_resumed()
    assert opt.param_groups[0]["lr"] == pytest.approx(LATEST_LR, rel=1e-6)
    inner = opt_state["inner_state"]
    want = {
        field: state_dict_from_jax(FIXTURE_MODEL, {
            "params": next(e[field] for e in inner.values() if field in e),
            "batch_stats": variables["batch_stats"]})
        for field in ("nu", "trace")}
    names = dict(model.named_parameters())
    assert len(opt.state) == len(names)
    for name, p in names.items():
        st = opt.state[p]
        assert float(st["step"]) == int(opt_state["count"]) == 2
        assert torch.equal(st["square_avg"], want["nu"][name]), name
        assert torch.equal(st["momentum_buffer"], want["trace"][name]), name
    assert float(sum(float(s["square_avg"].abs().sum())
                     for s in opt.state.values())) > 0


def _jax_resumed(variables, extra):
    """(JAX TrainState restored from the file as the JAX CLI restores it,
    its optimizer, the JAX model)."""
    jmodel = jax_create_model(FIXTURE_MODEL, logit_head=True)
    tx = jax_make_optimizer(1e-6)
    params = jax.tree.map(jnp.asarray, variables["params"])
    opt_state = serialization.from_state_dict(tx.init(params),
                                              extra["opt_state"])
    return JaxTrainState(
        params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=opt_state, step=jnp.zeros((), jnp.int32)), tx, jmodel


def _by_torch_name(tree, variables):
    return state_dict_from_jax(FIXTURE_MODEL, {
        "params": jax.tree.map(np.asarray, tree),
        "batch_stats": variables["batch_stats"]})


def _check_against(model, opt, jstate, variables, step, tol):
    """The port's parameters and RMSprop state against a JAX state."""
    want = _by_torch_name(jstate.params, variables)
    inner = serialization.to_state_dict(jstate.opt_state)["inner_state"]
    nu = _by_torch_name(inner["2"]["nu"], variables)
    trace = _by_torch_name(inner["3"]["trace"], variables)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=tol, err_msg=name)
        st = opt.state[p]
        assert float(st["step"]) == step
        for got, w in ((st["square_avg"], nu[name]),
                       (st["momentum_buffer"], trace[name])):
            np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=1e-5,
                                       atol=tol * float(w.abs().max()),
                                       err_msg=name)


def test_one_update_from_the_resumed_state_matches_optax(latest):
    """From the file, JAX's gradients on one batch applied by each
    framework's optimizer (clip, weight decay, RMSprop with momentum at
    the file's lr): parameters within 1e-6, RMSprop state within 1e-5
    relative."""
    _, variables, extra = latest
    jstate, tx, _ = _jax_resumed(variables, extra)
    rng = np.random.RandomState(22)
    grads = jax.tree.map(
        lambda a: jnp.asarray(rng.randn(*a.shape).astype(np.float32)),
        jstate.params)
    updates, opt_state = tx.update(grads, jstate.opt_state, jstate.params)
    import optax

    jstate = jstate.replace(params=optax.apply_updates(jstate.params,
                                                       updates),
                            opt_state=opt_state)
    model, opt, _ = _port_resumed()
    g = _by_torch_name(grads, variables)
    for name, p in model.named_parameters():
        p.grad = g[name].clone()
    clip_and_step(opt, 1.0)
    _check_against(model, opt, jstate, variables, 3, 1e-6)


def test_one_step_from_the_resumed_state_matches_jax(latest, monkeypatch):
    """From the file, one train step in each framework on the same batch
    (dropout silenced, JAX's two-pass BN variance), at the file's lr 1e-4:
    the loss within 1e-5 and the step's parameter deltas within 1e-3
    relative L2.  (A conv bias before a train-mode BN has a gradient that
    is f32 rounding noise, which RMSprop scales up to the size of a real
    update, so elementwise agreement holds only for the other
    parameters; the update itself is held at 1e-6 above.)  The unused
    ``output_OD`` head, whose gradient is 0, is stepped in both by weight
    decay and momentum and is held like every other parameter."""
    _, variables, extra = latest
    jstate, tx, jmodel = _jax_resumed(variables, extra)
    x, y = _batch(21, LATEST_PATCH)
    monkeypatch.setattr(jax_layers, "TRAIN_BN_ONE_PASS_STATS", False)
    with jax_layers.dropout_disabled():
        jstep = jax.jit(jax_batch_step_fn(jmodel, tx, n_classes=1))
        jstate, loss_j, ok_j = jstep(jstate, jnp.asarray(x), jnp.asarray(y),
                                     jax.random.PRNGKey(0))
    model, opt, _ = _port_resumed()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    silence_dropout(model)
    loss_p, ok_p = make_batch_step_fn(n_classes=1)(
        TrainState(model, opt), torch.from_numpy(x), torch.from_numpy(y))
    assert bool(ok_j) and ok_p
    assert abs(float(loss_p) - float(loss_j)) < 1e-5
    want = _by_torch_name(jstate.params, variables)
    num = den = 0.0
    for name, p in model.named_parameters():
        dp = (p.detach() - before[name]).double()
        dj = (want[name] - before[name]).double()
        num += float(((dp - dj) ** 2).sum())
        den += float((dj ** 2).sum())
        assert float(opt.state[p]["step"]) == 3
        if name.startswith("output_OD."):
            # the unused head: a zero gradient in both, stepped by weight
            # decay and momentum alone
            assert torch.count_nonzero(p.grad) == 0
            np.testing.assert_allclose(p.detach().numpy(),
                                       want[name].numpy(), rtol=0,
                                       atol=1e-6, err_msg=name)
    assert den > 0.0 and (num / den) ** 0.5 < 1e-3


def test_a_flattened_or_unknown_opt_state_raises(latest):
    _, _, extra = latest
    model, _ = ckpt.load_model_any(str(JAX_LATEST), device="cpu")
    opt = make_optimizer(model.parameters(), 1e-6)
    flat = json.loads(json.dumps(extra["opt_state"], default=lambda a: 0))
    flat["inner_state"]["2"]["nu"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="flattened optax state"):
        rmsprop_state_dict(FIXTURE_MODEL, flat, model, opt)
    with pytest.raises(ValueError, match="is not the per-leaf"):
        rmsprop_state_dict(FIXTURE_MODEL, {"mu": {}}, model, opt)


@pytest.fixture(scope="module")
def train_h5(tmp_path_factory):
    from jcfszxc_unet_tpu.data.preprocess import preprocess_dataset

    root = tmp_path_factory.mktemp("drive")
    make_synthetic_drive(str(root / "raw"))
    info = preprocess_dataset(dataset_path=str(root / "raw"),
                              output_dir=str(root / "data"),
                              save_method="h5", include_test=False)
    return info["train"]["output_file"]


def test_train_cli_resumes_a_jax_latest_file(train_h5, latest, tmp_path,
                                             monkeypatch, capsys):
    """``--resume <jax .ckpt>``: the weights, the RMSprop state and lr, and
    the progress (epoch, best Dice, patience, the scheduler's counters)
    come from the file, so a run capped at epoch 2 runs epoch 2 only, and
    its own --latest-path file carries the restored schedule on."""
    _, _, extra = latest
    prog = {k: float(v) for k, v in extra["progress"].items()}
    assert prog["epoch"] == 1 and prog["best_dice"] > 0
    monkeypatch.chdir(tmp_path)
    out_latest = str(tmp_path / "latest.pt")
    port_cli.main(["-d", train_h5, "--device", "cpu", "-p",
                   str(LATEST_PATCH), "-b", "2", "-s", "2", "--dtype",
                   "float32", "-v", "50", "--max-epochs", "2",
                   "--resume", str(JAX_LATEST), "--latest-path", out_latest,
                   "--save-path", str(tmp_path / "best.pt")])
    out = capsys.readouterr().out
    assert "Epoch 2 - LR: 1.00e-04" in out and "Epoch 1 - " not in out
    got = ckpt.load_extra(out_latest)
    assert got["progress"]["epoch"] == 2
    assert got["progress"]["best_dice"] >= prog["best_dice"]
    assert got["progress"]["scheduler_best"] >= prog["scheduler_best"]
    state = got["optimizer"]["state"]
    # 2 + 2 steps, the unused output_OD head's too (a zero gradient)
    assert sorted({float(s["step"]) for s in state.values()}) == [4.0]
    # a run capped at the file's epoch trains nothing and keeps its best
    model, _ = ckpt.load_model_any(str(JAX_LATEST), device="cpu")
    res = port_cli.train_arrays(
        model, *_h5_arrays(train_h5), model_name=FIXTURE_MODEL,
        patch_size=LATEST_PATCH, batch_size=2, steps=2, val_percent=0.5,
        max_epochs=1, resume_from=str(JAX_LATEST), visualize=False,
        save_path=str(tmp_path / "b.pt"), compute_dtype=torch.float32,
        device="cpu")
    assert res["history"] == []
    assert res["best_dice"] == pytest.approx(prog["best_dice"])


def _h5_arrays(path):
    from jcfszxc_unet_tpu_torch.data.loading import load_preprocessed_data

    d = load_preprocessed_data(path)
    return d["images"], d["masks"], d["labels"]


if __name__ == "__main__":
    # Rewrite the fixture: python -m tests.test_torch_port_remat_resume
    write_jax_latest_fixture()
    print(f"wrote {JAX_LATEST}")
