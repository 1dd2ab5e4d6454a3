"""The port's training slice against the JAX package: losses, optimizer,
plateau schedule, train-side sampling, the batch step (a 3-step UNet
trajectory and the NaN guard), validation, precise BN, the val split and
the train CLI end to end.

Inputs come from numpy with fixed seeds and everything runs in f32 on the
CPU, where the kernel wrappers run their plain versions.  RNG streams
differ between the packages, so batches, centers and augmentation bits
are handed to both sides explicitly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jcfszxc_unet_tpu.cli import train as jax_cli
from jcfszxc_unet_tpu.data import sampler as jax_sampler
from jcfszxc_unet_tpu.data.preprocess import preprocess_dataset
from jcfszxc_unet_tpu.train import losses as jax_losses
from jcfszxc_unet_tpu.train.optim import ReduceLROnPlateau as JaxPlateau
from jcfszxc_unet_tpu.train.optim import make_optimizer as jax_make_optimizer
from jcfszxc_unet_tpu.train.state import TrainState as JaxTrainState
from jcfszxc_unet_tpu.train.trainer import (
    make_batch_step_fn as jax_batch_step_fn,
    make_precise_bn_fn as jax_precise_bn_fn,
    make_val_fn as jax_val_fn,
)
from jcfszxc_unet_tpu_torch.cli import train as port_cli
from jcfszxc_unet_tpu_torch.compat.from_jax import state_dict_from_jax
from jcfszxc_unet_tpu_torch.data import sampler
from jcfszxc_unet_tpu_torch.ops.kernels import conv_fused, dice_fused
from jcfszxc_unet_tpu_torch.train import losses
from jcfszxc_unet_tpu_torch.train.checkpoint import load_extra, load_model
from jcfszxc_unet_tpu_torch.train.optim import (
    ReduceLROnPlateau,
    clip_and_step,
    get_current_lr,
    make_optimizer,
    set_current_lr,
)
from jcfszxc_unet_tpu_torch.train.state import TrainState
from jcfszxc_unet_tpu_torch.train.trainer import (
    make_batch_step_fn,
    make_val_fn,
    precise_bn,
)

from .test_e2e import make_synthetic_drive
from .torch_port_common import jax_model, jax_unet, port_model, port_unet

SZ, B, STEPS, LR = 32, 2, 3, 1e-6  # as tests/test_train_step_torch_parity.py


def _both(fn_port, fn_jax, *arrays, **kw):
    got = fn_port(*map(torch.from_numpy, arrays), **kw)
    want = fn_jax(*map(jnp.asarray, arrays), **kw)
    return got, want


# ---------------------------------------------------------------------------
# Losses: f32 on both sides, the same formulas; within 1e-6.
# ---------------------------------------------------------------------------


def _probs_and_mask(shape, seed=0, empty=True):
    rng = np.random.RandomState(seed)
    p = (rng.rand(*shape) * 1.4 - 0.2).astype(np.float32)  # beyond [0, 1]
    t = (rng.rand(*shape) > 0.6).astype(np.float32)
    if empty and len(shape) >= 3:  # empty-mask sample: the guard's case
        p[1] = -0.3
        t[1] = 0.0
    return p, t


@pytest.mark.parametrize("shape,reduce_batch_first", [
    ((3, 5, 6), False), ((3, 5, 6), True), ((5, 6), False)])
def test_dice_coeff_matches_jax(shape, reduce_batch_first):
    p, t = _probs_and_mask(shape)
    got, want = _both(losses.dice_coeff, jax_losses.dice_coeff, p, t,
                      reduce_batch_first=reduce_batch_first)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


def test_dice_coeff_empty_mask_guard():
    p = np.zeros((2, 4, 4), np.float32)
    t = np.zeros((2, 4, 4), np.float32)
    got, want = _both(losses.dice_coeff, jax_losses.dice_coeff, p, t)
    assert float(got) == float(want) == 1.0  # sets_sum < eps -> inter


@pytest.mark.parametrize("multiclass", [False, True])
def test_dice_loss_matches_jax(multiclass):
    shape = (2, 3, 5, 6) if multiclass else (3, 5, 6)
    p, t = _probs_and_mask(shape, seed=1)
    got, want = _both(losses.dice_loss, jax_losses.dice_loss, p, t,
                      multiclass=multiclass)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)
    got, want = _both(losses.multiclass_dice_coeff,
                      jax_losses.multiclass_dice_coeff,
                      *_probs_and_mask((2, 3, 5, 6), seed=2))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


def test_bce_and_soft_cross_entropy_match_jax():
    rng = np.random.RandomState(3)
    z = (4 * rng.randn(2, 5, 6, 1)).astype(np.float32)
    t = (rng.rand(2, 5, 6, 1) > 0.7).astype(np.float32)
    got, want = _both(losses.bce_with_logits, jax_losses.bce_with_logits, z, t)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)
    z4 = (3 * rng.randn(2, 5, 6, 4)).astype(np.float32)
    t4 = rng.dirichlet(np.ones(4), size=(2, 5, 6)).astype(np.float32)
    got, want = _both(losses.soft_cross_entropy,
                      jax_losses.soft_cross_entropy, z4, t4)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n_classes", [1, 2])
def test_combined_loss_matches_jax(n_classes):
    rng = np.random.RandomState(4)
    z = (3 * rng.randn(2, 6, 5, 1)).astype(np.float32)
    t = (rng.rand(2, 6, 5, 1) > 0.7).astype(np.float32)
    got, want = _both(losses.combined_loss, jax_losses.combined_loss, z, t,
                      n_classes=n_classes)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6, atol=1e-6)
    if n_classes > 1:  # one logit channel: the soft CE is identically 0
        assert float(got[1]) == 0.0
    # bf16 logits: the loss math still runs in f32
    loss = losses.combined_loss(torch.from_numpy(z).bfloat16(),
                                torch.from_numpy(t))[0]
    assert loss.dtype == torch.float32


# ---------------------------------------------------------------------------
# Optimizer and schedule
# ---------------------------------------------------------------------------


def test_five_rmsprop_updates_match_optax():
    """Clip by global norm 1.0, weight decay, RMSprop with momentum: five
    updates on fixed gradients, some above the clip norm and some below;
    the parameter deltas agree within 1e-6 relative (f32 rounding, and
    torch's 1e-6 in the clip denominator)."""
    rng = np.random.RandomState(5)
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 2, 3)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    lr = 1e-2
    tx = jax_make_optimizer(lr)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    opt = make_optimizer(tp.values(), lr)
    for scale in (0.3, 2.5, 0.8, 4.0, 1.5):
        grads = {k: rng.randn(*s).astype(np.float32) for k, s in
                 shapes.items()}
        norm = np.sqrt(sum(float((g ** 2).sum()) for g in grads.values()))
        grads = {k: (g * (scale / norm)).astype(np.float32)
                 for k, g in grads.items()}
        updates, opt_state = tx.update(
            {k: jnp.asarray(g) for k, g in grads.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(grads[k])
        clip_and_step(opt, 1.0)
    for k in shapes:
        dj = np.asarray(jp[k]) - p0[k]
        dt = tp[k].detach().numpy() - p0[k]
        assert np.abs(dt).max() > 1e-2  # the updates are not negligible
        np.testing.assert_allclose(dt, dj, rtol=1e-6,
                                   atol=1e-6 * np.abs(dj).max())
    assert get_current_lr(opt) == lr
    set_current_lr(opt, 3e-3)
    assert get_current_lr(opt) == 3e-3


def test_rmsprop_steps_transfusenets_unused_head_as_optax():
    """One clipped RMSprop step of TransFuseNet from transplanted weights
    (f32, lr 1e-3) on JAX's gradients, where the unused ``output_OD`` head
    has none: optax steps it by weight decay (a zero gradient), and so
    does the port (``clip_and_step`` gives it a zero gradient), within
    1e-6; every other parameter too."""
    name = "RetinaLiteNet.TransFuseNet"
    _, variables = jax_model(name, seed=0, hw=32)
    params = variables["params"]
    rng = np.random.RandomState(7)
    grads = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32),
                         params)
    grads["output_OD"] = jax.tree.map(np.zeros_like, grads["output_OD"])
    tx = jax_make_optimizer(1e-3)
    updates, _ = tx.update(grads, tx.init(params), params)
    moved = jax.tree.map(np.asarray, optax.apply_updates(params, updates))
    stats = variables["batch_stats"]
    want = state_dict_from_jax(name, {"params": moved, "batch_stats": stats})
    g = state_dict_from_jax(name, {"params": grads, "batch_stats": stats})
    port = port_model(name, variables)
    before = {k: p.detach().clone() for k, p in port.named_parameters()}
    opt = make_optimizer(port.parameters(), 1e-3)
    for k, p in port.named_parameters():
        p.grad = None if k.startswith("output_OD.") else g[k].clone()
    clip_and_step(opt, 1.0)
    head = [k for k, _ in port.named_parameters()
            if k.startswith("output_OD.")]
    assert head == ["output_OD.weight", "output_OD.bias"]
    for k, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[k].numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)
    for k in head:  # it moved, as optax moves it
        assert not torch.equal(port.get_parameter(k).detach(), before[k])


def test_plateau_scheduler_matches_jax_exactly():
    rng = np.random.RandomState(6)
    metrics = list(np.round(np.cumsum(rng.rand(40) - 0.45) / 10, 3))
    metrics += [0.5, 0.5, 0.49, 0.5, 0.5, 0.5, 0.5, 0.5, 0.5, 0.9, 0.5]
    port, ref = ReduceLROnPlateau(), JaxPlateau()
    lr_p = lr_j = 1e-3
    for m in metrics:
        lr_p, lr_j = port.step(m, lr_p), ref.step(m, lr_j)
        assert lr_p == lr_j
        assert (port.best, port.num_bad_epochs, port.cooldown_counter) == (
            ref.best, ref.num_bad_epochs, ref.cooldown_counter)
    assert lr_p < 1e-3  # the sequence does reach a reduction


@pytest.mark.parametrize("history,mean_prob", [
    ([0.5, 0.6, 0.01], None), ([0.5, 0.6, 0.01], 0.5),
    ([0.5, 0.6, 0.01], 0.99), ([0.1, 0.2, 0.01], None),
    ([0.5, 0.01, 0.01], None), ([0.5, float("nan"), 0.01], None)])
def test_bn_saturation_signature_matches_jax(history, mean_prob):
    assert port_cli.bn_saturation_signature(history, mean_prob) == \
        jax_cli.bn_saturation_signature(history, mean_prob)


# ---------------------------------------------------------------------------
# Train-side sampling: exact
# ---------------------------------------------------------------------------


def test_build_train_sample_map_matches_jax():
    rng = np.random.RandomState(7)
    masks = (rng.rand(3, 20, 17) > 0.4).astype(np.float32)
    got = sampler.build_train_sample_map(masks, 4)
    want = jax_sampler.build_train_sample_map(masks, 4)
    assert got.dtype == np.int32 and np.array_equal(got, want)


def test_sample_batch_on_explicit_centers_matches_jax():
    rng = np.random.RandomState(8)
    images = rng.rand(3, 20, 17, 3).astype(np.float32)
    labels = (rng.rand(3, 20, 17, 1) > 0.5).astype(np.float32)
    smap = sampler.build_train_sample_map(np.ones((3, 20, 17)), 4)
    centers = smap[rng.randint(0, len(smap), 6)]
    for pool in (images, labels):
        got = sampler.extract_patches(torch.from_numpy(pool), centers, 8)
        want = jax_sampler.extract_patches(jnp.asarray(pool),
                                           jnp.asarray(centers), 8)
        assert np.array_equal(got.numpy(), np.asarray(want))
    # drawn centers are rows of the map; the batch has the JAX shapes
    g = torch.Generator().manual_seed(0)
    smap_t = torch.from_numpy(smap).long()
    drawn = sampler.sample_centers(g, smap_t, 64)
    rows = {tuple(r) for r in smap.tolist()}
    assert all(tuple(r) in rows for r in drawn.tolist())
    imgs, labs = sampler.sample_batch(g, torch.from_numpy(images),
                                      torch.from_numpy(labels), smap_t, 5, 8)
    assert imgs.shape == (5, 8, 8, 3) and labs.shape == (5, 8, 8, 1)


def test_apply_dihedral_matches_jax_augment_batch():
    rng = np.random.RandomState(9)
    imgs = rng.rand(16, 6, 6, 3).astype(np.float32)
    labs = rng.rand(16, 6, 6, 1).astype(np.float32)
    key = jax.random.PRNGKey(11)
    bits = np.array(jax.random.bernoulli(key, 0.5, (3, imgs.shape[0])))
    assert bits.any(axis=1).all() and (~bits).any(axis=1).all()
    want = jax_sampler.augment_batch(key, jnp.asarray(imgs),
                                     jnp.asarray(labs))
    for x, w in zip((imgs, labs), want):
        got = sampler.apply_dihedral(torch.from_numpy(x),
                                     torch.from_numpy(bits))
        assert np.array_equal(got.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# The batch step against make_batch_step_fn
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def unet():
    """JAX UNet (random weights and BN statistics) and its jitted batch
    step at lr 1e-6, shared by the trajectory and NaN-guard tests."""
    jmodel, variables = jax_unet(seed=3, hw=SZ)
    tx = jax_make_optimizer(LR)
    step = jax.jit(jax_batch_step_fn(jmodel, tx, n_classes=1))
    return jmodel, variables, tx, step


def _batch(rng):
    x = rng.rand(B, SZ, SZ, 3).astype(np.float32)
    y = (rng.rand(B, SZ, SZ, 1) > 0.7).astype(np.float32)
    return x, y


def _jax_state(variables, tx):
    params = jax.tree.map(jnp.asarray, variables["params"])
    return JaxTrainState(params=params,
                         batch_stats=jax.tree.map(jnp.asarray,
                                                  variables["batch_stats"]),
                         opt_state=tx.init(params),
                         step=jnp.zeros((), jnp.int32))


def _port_state(variables):
    model = port_unet(variables).train()
    return TrainState(model, make_optimizer(model.parameters(), LR))


def _jax_state_dict(state):
    return state_dict_from_jax("UNet.UNet", {
        "params": jax.tree.map(np.asarray, state.params),
        "batch_stats": jax.tree.map(np.asarray, state.batch_stats)})


def test_three_step_trajectory_matches_jax(unet):
    """Full-width UNet at 32^2, batch 2, f32, lr 1e-6, weights carried
    over by state_dict_from_jax.  Tolerances of
    tests/test_train_step_torch_parity.py: loss within 1e-5 per step,
    3-step parameter deltas within 0.1 relative L2 (BN backward through
    batch statistics is ill-conditioned in f32), BN running statistics
    within 1e-3."""
    jmodel, variables, tx, jstep = unet
    jstate = _jax_state(variables, tx)
    pstate = _port_state(variables)
    step = make_batch_step_fn(n_classes=1, compute_dtype=torch.float32)
    sd0 = {k: v.clone() for k, v in pstate.model.state_dict().items()}
    rng = np.random.RandomState(3)
    for s in range(STEPS):
        x, y = _batch(rng)
        jstate, loss_j, ok_j = jstep(jstate, jnp.asarray(x), jnp.asarray(y),
                                     jax.random.PRNGKey(s))
        loss_p, ok_p = step(pstate, torch.from_numpy(x), torch.from_numpy(y))
        assert bool(ok_j) and ok_p
        assert abs(float(loss_p) - float(loss_j)) < 1e-5, (s, float(loss_p),
                                                           float(loss_j))
    assert pstate.step == STEPS
    sd_j = _jax_state_dict(jstate)
    sd_p = pstate.model.state_dict()
    num = den = 0.0
    for k, _ in pstate.model.named_parameters():
        dp = (sd_p[k] - sd0[k]).double()
        dj = (sd_j[k] - sd0[k]).double()
        num += float(((dp - dj) ** 2).sum())
        den += float((dj ** 2).sum())
    assert den > 0.0
    assert (num / den) ** 0.5 < 0.1
    for k in sd_p:
        if "running" in k:
            np.testing.assert_allclose(sd_p[k].numpy(), sd_j[k].numpy(),
                                       rtol=1e-3, atol=1e-3, err_msg=k)


def test_nan_guard_skips_the_update_on_both_sides(unet):
    """A batch holding a NaN: ok is false and the loss 0 on both sides,
    parameters and optimizer state unchanged (after one good step, so
    the optimizer state is not empty)."""
    jmodel, variables, tx, jstep = unet
    rng = np.random.RandomState(4)
    x, y = _batch(rng)
    bad = x.copy()
    bad[0, 3, 4, 1] = np.nan
    jstate = _jax_state(variables, tx)
    pstate = _port_state(variables)
    step = make_batch_step_fn(n_classes=1)
    jstate, _, _ = jstep(jstate, jnp.asarray(x), jnp.asarray(y),
                         jax.random.PRNGKey(0))
    step(pstate, torch.from_numpy(x), torch.from_numpy(y))
    params_j = jax.tree.map(np.asarray, jstate.params)
    opt_j = jax.tree.map(np.asarray, jstate.opt_state)
    params_p = {k: p.detach().clone()
                for k, p in pstate.model.named_parameters()}
    opt_p = [{k: v.clone() for k, v in s.items() if torch.is_tensor(v)}
             for s in pstate.optimizer.state.values()]

    jstate, loss_j, ok_j = jstep(jstate, jnp.asarray(bad), jnp.asarray(y),
                                 jax.random.PRNGKey(1))
    loss_p, ok_p = step(pstate, torch.from_numpy(bad), torch.from_numpy(y))
    assert not bool(ok_j) and not ok_p
    assert float(loss_j) == 0.0 and float(loss_p) == 0.0
    jax.tree.map(np.testing.assert_array_equal, params_j,
                 jax.tree.map(np.asarray, jstate.params))
    jax.tree.map(np.testing.assert_array_equal, opt_j,
                 jax.tree.map(np.asarray, jstate.opt_state))
    for k, p in pstate.model.named_parameters():
        assert torch.equal(p, params_p[k]), k
        assert p.grad is None, k  # the non-finite gradients were dropped
    for before, s in zip(opt_p, pstate.optimizer.state.values()):
        for k, v in before.items():
            assert torch.equal(s[k], v), k
    assert pstate.step == 2


# ---------------------------------------------------------------------------
# Validation and precise BN
# ---------------------------------------------------------------------------


def test_val_fn_matches_jax():
    """V = 5 patches in chunks of 2 (the last one short): probabilities
    within 1e-4 (the eval forward's tolerance, tests/test_torch_port_unet),
    the four Dice scores within 1e-6.  The validation runs the eval-mode
    forward on a model in train mode and leaves it in train mode."""
    jmodel, variables = jax_unet(seed=5, hw=SZ)
    rng = np.random.RandomState(12)
    imgs = rng.rand(5, SZ, SZ, 3).astype(np.float32)
    labs = (rng.rand(5, SZ, SZ, 1) > 0.7).astype(np.float32)
    jfn = jax_val_fn(jmodel, patch_size=SZ, chunk_size=2)
    want, want_p = jfn(variables["params"], variables["batch_stats"],
                       jnp.asarray(imgs), jnp.asarray(labs))
    model = port_unet(variables).train()
    before = dice_fused.counter.launches
    got, got_p = make_val_fn(model, chunk_size=2)(
        torch.from_numpy(imgs), torch.from_numpy(labs))
    assert model.training
    assert dice_fused.counter.launches == before  # plain version on the CPU
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0,
                               atol=1e-4)
    assert 0.01 < float((got_p > 0.5).float().mean()) < 0.99  # both sides
    for k in ("dice", "dice_bg", "dice_fg", "dice_avg"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    # an empty split gives zeros, as in the JAX package
    zero, probs = make_val_fn(model)(
        torch.zeros((0, SZ, SZ, 3)), torch.zeros((0, SZ, SZ, 1)))
    assert all(float(v) == 0.0 for v in zero.values())
    assert probs.shape == (0, SZ, SZ, 1)


def test_precise_bn_matches_jax():
    """The port recalibrates on the batches at the centers that JAX's key
    draws (trainer.py:213-216); BN statistics within 1e-4 (f32 sums in
    another order, one-pass against two-pass variance)."""
    jmodel, variables = jax_unet(seed=6, hw=SZ)
    rng = np.random.RandomState(13)
    images = rng.rand(2, 40, 36, 3).astype(np.float32)
    labels = (rng.rand(2, 40, 36, 1) > 0.7).astype(np.float32)
    smap = sampler.build_train_sample_map(np.ones((2, 40, 36)), SZ // 2)
    key, k_batches = jax.random.PRNGKey(21), 3
    fn = jax_precise_bn_fn(jmodel, batch_size=B, patch_size=SZ,
                           k_batches=k_batches)
    want = fn(variables["params"], variables["batch_stats"],
              jnp.asarray(images), jnp.asarray(labels), jnp.asarray(smap),
              key)
    centers = [jax_sampler.sample_centers(jax.random.split(k)[0],
                                          jnp.asarray(smap), B)
               for k in jax.random.split(key, k_batches)]
    model = port_unet(variables).train()
    pool = torch.from_numpy(images)
    precise_bn(model, [sampler.extract_patches(pool, np.asarray(c), SZ)
                       for c in centers])
    assert model.training
    sd_j = state_dict_from_jax("UNet.UNet", {
        "params": variables["params"],
        "batch_stats": jax.tree.map(np.asarray, want)})
    sd_p = model.state_dict()
    n = 0
    for k in sd_p:
        if "running" in k:
            np.testing.assert_allclose(sd_p[k].numpy(), sd_j[k].numpy(),
                                       rtol=1e-4, atol=1e-4, err_msg=k)
            n += 1
        if "num_batches_tracked" in k:
            assert int(sd_p[k]) == 0  # restored: not a training step
    assert n == 36  # 18 BatchNorms
    bn = model.inc.double_conv[1]
    assert bn.momentum == 0.1


# ---------------------------------------------------------------------------
# The CLI: val split, end to end, refusals
# ---------------------------------------------------------------------------


class _Captured(Exception):
    pass


def _val_images(cli, monkeypatch, val_percent, n=20, **kwargs):
    """The val split that ``cli.train_model`` makes, read off the images
    it hands to build_val_patches (image i is filled with the value i)."""
    images = np.broadcast_to(np.arange(n, dtype=np.float32)[:, None, None,
                                                            None],
                             (n, 8, 8, 3)).copy()
    dataset = {"images": images, "masks": np.ones((n, 8, 8), np.float32),
               "labels": np.zeros((n, 8, 8), np.float32),
               "filenames": [f"{i}.tif" for i in range(n)]}

    def capture(val_images, *args, **kwargs):
        raise _Captured(np.asarray(val_images)[:, 0, 0, 0].astype(int))

    monkeypatch.setattr(cli, "load_preprocessed_data", lambda path: dataset)
    monkeypatch.setattr(cli, "build_val_patches", capture)
    with pytest.raises(_Captured) as info:
        cli.train_model(None, "UNet.UNet", {}, input_data="x.h5",
                        val_percent=val_percent, patch_size=4, seed=42,
                        visualize=False, **kwargs)
    return list(info.value.args[0])


@pytest.mark.parametrize("val_percent", [0.1, 0.25])
def test_val_split_equals_the_jax_cli(monkeypatch, val_percent):
    got = _val_images(port_cli, monkeypatch, val_percent, device="cpu")
    want = _val_images(jax_cli, monkeypatch, val_percent)
    assert got == want and len(got) == int(20 * val_percent)


@pytest.fixture(scope="module")
def train_h5(tmp_path_factory):
    root = tmp_path_factory.mktemp("drive")
    make_synthetic_drive(str(root / "raw"))
    info = preprocess_dataset(dataset_path=str(root / "raw"),
                              output_dir=str(root / "data"),
                              save_method="h5", include_test=False)
    return info["train"]["output_file"]


def test_train_cli_end_to_end(train_h5, tmp_path, monkeypatch, capsys):
    """Two epochs on the synthetic split, then an exact resume for a third
    from the --latest-path checkpoint."""
    monkeypatch.chdir(tmp_path)
    best, latest = str(tmp_path / "best.pt"), str(tmp_path / "latest.pt")
    metrics = str(tmp_path / "metrics.jsonl")
    args = ["-d", train_h5, "--device", "cpu", "-p", "32", "-b", "4", "-s",
            "2", "--dtype", "float32", "-v", "50", "--save-path", best,
            "--latest-path", latest, "--metrics-file", metrics]
    before = conv_fused.counter.launches
    port_cli.main(args + ["--max-epochs", "2"])
    out = capsys.readouterr().out
    assert "Epoch 1 - LR: 1.00e-06" in out and "Epoch 2 - " in out
    assert conv_fused.counter.launches == before  # plain versions on the CPU
    recs = [json.loads(line) for line in open(metrics)]
    assert [r["epoch"] for r in recs] == [1, 2]
    assert all(np.isfinite(r["loss"]) and 0 <= r["dice"] <= 1 for r in recs)
    model, cfg = load_model(best, device="cpu")  # strict=True
    assert cfg["model_name"] == "UNet.UNet"
    extra = load_extra(latest)
    assert extra["progress"]["epoch"] == 2
    assert extra["optimizer"]["state"]  # RMSprop buffers are saved
    assert len(list((tmp_path / "visualizations").glob("00*.png"))) == 2

    port_cli.main(args + ["--resume", latest, "--max-epochs", "3"])
    out = capsys.readouterr().out
    assert "Resumed" not in out  # logged, not printed
    assert "Epoch 3 - " in out and "Epoch 1 - " not in out
    assert [json.loads(line)["epoch"] for line in open(metrics)] == [1, 2, 3]
    assert load_extra(latest)["progress"]["epoch"] == 3


@pytest.mark.parametrize("flag", [["--s2d"], ["--logit-head"],
                                  ["--devices", "64", "--profile-dir", "trace",
                                   "--device", "cuda"],
                                  ["--devices", "2", "--device", "cuda:0"]])
def test_train_cli_refuses_unported_flags(flag):
    # --logit-head and --s2d are ported; UNet has neither a sigmoid head
    # nor an s2d mode, and each refusal names the models that take it.
    # --devices is ported (tests/test_torch_port_parallel_cli.py): more
    # cards than are visible, or several ranks on one named card, exit
    # with a message before any rank starts; --profile-dir lets neither
    # through.
    match = {"--logit-head": "not supported by UNet.UNet.*BCDU_net_D1",
             "--s2d": "not supported by UNet.UNet; supported: FRUNet.FRUNet, "
                      "MultiResUNet.MultiResUNet, UNetPP.NestedUNet",
             "64": "needs 64 CUDA devices",
             "2": "one rank per card"}[flag[-1] if len(flag) == 1
                                       else flag[1]]
    with pytest.raises(SystemExit, match=match):
        port_cli.main(["--device", "cpu", *flag])


def test_train_cli_trains_in_s2d_under_the_profiler(train_h5, tmp_path,
                                                     monkeypatch):
    """--s2d on FRUNet with --profile-dir: two steps, ``s2d`` recorded in
    the checkpoint, which reloads (strict) in s2d mode, and a trace."""
    monkeypatch.chdir(tmp_path)
    best, metrics = str(tmp_path / "fr.pt"), str(tmp_path / "m.jsonl")
    port_cli.main(["-d", train_h5, "--device", "cpu", "--model",
                   "FRUNet.FRUNet", "--s2d", "-p", "32", "-b", "2", "-s", "2",
                   "--max-epochs", "1", "--dtype", "float32", "-v", "50",
                   "--save-path", best, "--metrics-file", metrics,
                   "--profile-dir", str(tmp_path / "trace")])
    (rec,) = [json.loads(line) for line in open(metrics)]
    assert rec["skipped_steps"] == 0 and np.isfinite(rec["loss"])
    model, cfg = load_model(best, device="cpu")
    assert cfg == {"model_name": "FRUNet.FRUNet",
                   "model_kwargs": {"s2d": True}}
    assert model.s2d and model.block1_3.s2d and not model.block2_2.s2d
    assert list((tmp_path / "trace").glob("trace_*.json"))


def test_train_cli_trains_with_remat(train_h5, tmp_path, monkeypatch):
    """--remat: the same epoch as without it (the loss and the val Dice
    of one seeded epoch agree), in f32 on the CPU."""
    monkeypatch.chdir(tmp_path)
    recs = []
    for flags in ([], ["--remat"]):
        metrics = str(tmp_path / f"m{len(recs)}.jsonl")
        port_cli.main(["-d", train_h5, "--device", "cpu", "-p", "32", "-b",
                       "2", "-s", "2", "--max-epochs", "1", "--dtype",
                       "float32", "-v", "50", "--save-path",
                       str(tmp_path / "u.pt"), "--metrics-file", metrics,
                       *flags])
        recs.append(json.loads(open(metrics).read()))
    assert recs[1]["skipped_steps"] == 0
    np.testing.assert_allclose(recs[1]["loss"], recs[0]["loss"], rtol=1e-5)
    np.testing.assert_allclose(recs[1]["dice"], recs[0]["dice"], atol=1e-4)


def test_train_arrays_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli.train_arrays(None, np.zeros((2, 8, 8, 3)),
                              np.ones((2, 8, 8)), np.zeros((2, 8, 8)))
