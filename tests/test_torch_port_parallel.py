"""The port's data-parallel training (``jcfszxc_unet_tpu_torch/parallel``)
against the JAX package's mesh semantics, on the CPU: gloo ranks in
separate processes (``parallel.spawn``), held against JAX's 4-device CPU
mesh (``tests/conftest.py`` gives JAX 8 CPU devices) and against the
port in one process.

One 4-rank job (a module-scoped fixture) runs every multi-rank check of
this file through ``parallel.jobs.run``:
  * 2 train steps of TransFuseNet, JAX's ``_tiny_setup`` geometry (batch
    8, patch 16, f32, lr 1e-3), transplanted weights, dropout silenced,
    explicit batches: against JAX ``make_batch_step_fn(mesh=make_mesh(4))``
    with the bounds of ``tests/test_parallel.py:55-74`` (loss 1e-3,
    params rtol 2e-3 / atol 1e-5), against the 1-process port, and
    bit-identical across the ranks; the same with ``remat``;
  * the NaN guard: every rank skips the step whose global batch holds a
    NaN, and the parameters stay as they were;
  * the global BatchNorm (``BatchNorm2d``, its ``.s2d``, ``BatchNorm1d``)
    and the global Dice against the single process on the whole batch;
  * precise BN over the ranks, and the device meshes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jcfszxc_unet_tpu.ops import layers as jax_layers
from jcfszxc_unet_tpu.parallel.mesh import make_mesh, put_replicated
from jcfszxc_unet_tpu.train.optim import make_optimizer as jax_make_optimizer
from jcfszxc_unet_tpu.train.state import TrainState as JaxTrainState
from jcfszxc_unet_tpu.train.trainer import (
    make_batch_step_fn as jax_batch_step_fn,
)
from jcfszxc_unet_tpu_torch.compat.from_jax import state_dict_from_jax
from jcfszxc_unet_tpu_torch.parallel import (
    World,
    gather_rows,
    jobs,
    row_bounds,
    shard_rows,
    spawn,
)
from jcfszxc_unet_tpu_torch.parallel.mesh import backend_for, rank_device
from jcfszxc_unet_tpu_torch.utils.device import resolve_device_count

from .torch_port_common import jax_model

NAME = "RetinaLiteNet.TransFuseNet"
RANKS, BATCH, PATCH, STEPS, LR = 4, 8, 16, 2, 1e-3


def _batches(seed=0, steps=STEPS):
    rng = np.random.RandomState(seed)
    return [(rng.rand(BATCH, PATCH, PATCH, 3).astype(np.float32),
             (rng.rand(BATCH, PATCH, PATCH, 1) > 0.8).astype(np.float32))
            for _ in range(steps)]


def _nan_batches():
    (x, y), (bad, y2) = _batches(seed=3)
    bad = bad.copy()
    bad[5, 3, 4, 1] = np.nan  # a row of rank 2
    return [(x, y), (bad, y2)]


def _bn_inputs():
    rng = np.random.RandomState(11)
    x2 = (1.5 + 2 * rng.randn(RANKS * 2, 8, 6, 5)).astype(np.float32)
    x1 = (0.5 + rng.randn(RANKS * 2, 6)).astype(np.float32)
    return dict(x2d=x2, x1d=x1,
                gy2d=rng.randn(*x2.shape).astype(np.float32),
                gy1d=rng.randn(*x1.shape).astype(np.float32),
                gys2d=rng.randn(*x2.shape).astype(np.float32))


def _dice_inputs():
    rng = np.random.RandomState(12)
    z = (3 * rng.randn(RANKS * 2, 6, 5, 1)).astype(np.float32)
    t = (rng.rand(RANKS * 2, 6, 5, 1) > 0.7).astype(np.float32)
    return dict(logits=z, target=t)


def _precise_batches():
    rng = np.random.RandomState(13)
    return [rng.rand(BATCH, PATCH, PATCH, 3).astype(np.float32)
            for _ in range(3)]


@pytest.fixture(scope="module")
def setup():
    """TransFuseNet's JAX variables (random BN statistics) and its
    transplanted state dict."""
    jmodel, variables = jax_model(NAME, seed=0, hw=PATCH)
    sd = {k: v.numpy() for k, v in state_dict_from_jax(NAME,
                                                       variables).items()}
    return jmodel, variables, sd


def _tasks(sd):
    steps = dict(model_name=NAME, batches=_batches(), lr=LR, state_dict=sd)
    return [
        ("train_steps", steps),
        ("train_steps", dict(steps, remat=True)),
        ("train_steps", dict(steps, batches=_nan_batches())),
        ("batch_norm_grads", _bn_inputs()),
        ("dice_grads", _dice_inputs()),
        ("precise_batch_norm", dict(model_name=NAME, state_dict=sd,
                                    batches=_precise_batches())),
        ("meshes", {}),
        ("train_steps", dict(steps, batches=_nan_batches()[:1])),
    ]


@pytest.fixture(scope="module")
def ranks(setup):
    """The 4-rank job's results, per rank, and the same tasks in one
    process (without ``meshes``, which needs a job)."""
    tasks = _tasks(setup[2])
    per_rank = spawn(jobs.run, RANKS, tasks, device="cpu",
                     join_timeout_s=600)
    single = jobs.run(None, tasks[:6], device="cpu")
    return per_rank, single


def _jax_steps(jmodel, variables, batches, mesh):
    tx = jax_make_optimizer(LR)
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    opt_state = tx.init(params)
    if mesh is not None:
        params, stats, opt_state = (put_replicated(t, mesh)
                                    for t in (params, stats, opt_state))
    state = JaxTrainState(params=params, batch_stats=stats,
                          opt_state=opt_state, step=jnp.zeros((), jnp.int32))
    losses = []
    with jax_layers.dropout_disabled():
        step = jax.jit(jax_batch_step_fn(jmodel, tx, n_classes=1, mesh=mesh))
        for s, (x, y) in enumerate(batches):
            state, loss, ok = step(state, jnp.asarray(x), jnp.asarray(y),
                                   jax.random.PRNGKey(s))
            assert bool(ok)
            losses.append(float(loss))
    sd = state_dict_from_jax(NAME, {
        "params": jax.tree.map(np.asarray, state.params),
        "batch_stats": jax.tree.map(np.asarray, state.batch_stats)})
    return losses, {k: v.numpy() for k, v in sd.items()}


def _param_keys(sd):
    return [k for k in sd if not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]


def _assert_params_close(got, want, jax_runs):
    """Every parameter within rtol 2e-3 / atol 1e-5 of ``want``
    (tests/test_parallel.py:55-74), or, for an element where JAX's own
    1-device and 4-device steps differ by more than that, within twice
    their difference.  (Here one element of ``conv_block1.0.bias``: a conv
    bias before ReLU, max-pool and a train-mode BN, whose channel passes
    the ReLU whole, so its gradient is f32 summation noise that RMSprop
    scales up; JAX's two runs differ there by 4.5e-5.)"""
    (_, jax1), (_, jax4) = jax_runs
    for k in _param_keys(want):
        bound = np.maximum(1e-5 + 2e-3 * np.abs(want[k]),
                           2 * np.abs(jax1[k] - jax4[k]))
        bad = np.abs(got[k] - want[k]) > bound
        assert not bad.any(), (k, got[k][bad], want[k][bad], bound[bad])


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_runs(setup):
    """JAX's 2 steps on one device and on the 4-device mesh: (losses,
    state dict) each."""
    jmodel, variables, _ = setup
    return (_jax_steps(jmodel, variables, _batches(), None),
            _jax_steps(jmodel, variables, _batches(), make_mesh(4)))


def test_four_rank_step_matches_jax_four_device_mesh(ranks, jax_runs):
    """The port's 4 gloo ranks against JAX's 4-device mesh step: losses
    within 1e-3, parameters as :func:`_assert_params_close`, BN running
    statistics within rtol 1e-4 / atol 1e-6 (tests/test_parallel.py:55-74,
    214-221)."""
    losses_j, sd_j = jax_runs[1]
    got = ranks[0][0][0]
    assert got["oks"] == [True] * STEPS
    for lp, lj in zip(got["losses"], losses_j):
        assert abs(lp - lj) < 1e-3, (got["losses"], losses_j)
    _assert_params_close(got["state"], sd_j, jax_runs)
    for k in sd_j:
        if "running" in k:
            np.testing.assert_allclose(got["state"][k], sd_j[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_four_rank_step_matches_one_process_port(ranks, jax_runs):
    """The same job in one process of the port (stock BatchNorm, one
    Dice): losses within 1e-5, parameters as :func:`_assert_params_close`,
    and the step count and batch counts of every BatchNorm equal."""
    per_rank, single = ranks
    got, want = per_rank[0][0], single[0]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    _assert_params_close(got["state"], want["state"], jax_runs)
    assert got["step"] == want["step"] == STEPS
    for k, v in want["state"].items():
        if k.endswith("num_batches_tracked"):
            assert int(got["state"][k]) == int(v) == STEPS, k


@pytest.mark.parametrize("task", [0, 1, 2], ids=["plain", "remat", "nan"])
def test_parameters_are_bit_identical_across_ranks(ranks, task):
    per_rank, _ = ranks
    digests = {r[task]["digest"] for r in per_rank}
    assert len(digests) == 1
    assert len({tuple(r[task]["losses"]) for r in per_rank}) == 1
    for r in per_rank[1:]:
        for k, v in per_rank[0][task]["state"].items():
            assert np.array_equal(r[task]["state"][k], v, equal_nan=True), k


def test_remat_step_equals_plain_step_over_ranks(ranks):
    """A checkpointed forward repeats every BatchNorm all-reduce in its
    recomputation; the ranks recompute in one order, so the remat run
    gives the plain run's losses and parameters (within f32 noise) and
    counts each BatchNorm once per step."""
    got, want = ranks[0][0][1], ranks[0][0][0]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
    for k, v in want["state"].items():
        np.testing.assert_allclose(got["state"][k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_nan_guard_skips_on_every_rank(ranks):
    """A NaN in rank 2's rows of the second batch: every rank reports the
    step skipped with loss 0, and the parameters are bit for bit those of
    the same job after the first batch alone (the BN running statistics
    take the NaN batch, as in JAX and the reference)."""
    per_rank, single = ranks
    for r in per_rank:
        res, after_one = r[2], r[7]
        assert res["oks"] == [True, False] and res["losses"][1] == 0.0
        assert res["step"] == 2 and after_one["oks"] == [True]
        for k in _param_keys(after_one["state"]):
            assert np.array_equal(res["state"][k], after_one["state"][k]), k
    assert single[2]["oks"] == [True, False]


# ---------------------------------------------------------------------------
# BatchNorm, loss and gradients over the ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["2d", "s2d", "1d"])
def test_global_batch_norm_matches_the_whole_batch(ranks, kind):
    """Each rank's outputs and input gradients are its rows of the single
    process's on the whole batch, within 1e-5; the running statistics are
    the whole batch's (Bessel's factor over the global count) on every
    rank, and the parameters' gradients summed over the ranks are the
    single process's."""
    per_rank, single = ranks
    want = single[3][kind]
    for f in ("y", "gx"):
        got = np.concatenate([r[3][kind][f] for r in per_rank])
        np.testing.assert_allclose(got, want[f], rtol=1e-5, atol=1e-5,
                                   err_msg=f)
    for r in per_rank:
        for f in ("running_mean", "running_var"):
            np.testing.assert_allclose(r[3][kind][f], want[f], rtol=1e-5,
                                       atol=1e-6, err_msg=f)
    for f in ("gweight", "gbias"):
        got = sum(r[3][kind][f] for r in per_rank)
        scale = float(np.abs(want[f]).max())
        np.testing.assert_allclose(got, want[f], rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=f)


def test_global_dice_gradient_matches_one_process(ranks):
    """1/2 BCE of the rank's rows + 1/2 Dice of the global sums: the
    all-reduced loss is the single process's, the averaged gradient is
    the single process's within 1e-6, and each rank's own logit gradient
    carries the W copies of the global term the module doc derives (W x
    the single process's rows)."""
    per_rank, single = ranks
    want = single[4]
    for r in per_rank:
        got = r[4]
        assert abs(got["loss"] - want["loss"]) < 1e-6
        np.testing.assert_allclose(got["grad_w"], want["grad_w"], rtol=1e-6,
                                   atol=1e-6)
    gz = np.concatenate([r[4]["grad_z"] for r in per_rank]) / RANKS
    np.testing.assert_allclose(gz, want["grad_z"], rtol=1e-5, atol=1e-8)


def test_precise_bn_over_ranks_matches_one_process(ranks):
    per_rank, single = ranks
    want = single[5]["state"]
    assert want
    for r in per_rank:
        for k, v in want.items():
            np.testing.assert_allclose(r[5]["state"][k], v, rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_device_meshes_span_the_job(ranks):
    for r in ranks[0]:
        got = r[6]
        assert got["size"] == RANKS and got["names"] == ("data",)
        assert got["shape_2d"] == (RANKS, 1)
        assert got["names_2d"] == ("data", "model")


# ---------------------------------------------------------------------------
# Helpers in one process, the launcher's failures, --devices
# ---------------------------------------------------------------------------


def test_row_split_and_gather_in_one_process():
    w = [World(rank=r, size=3, device=torch.device("cpu"), backend="gloo")
         for r in range(3)]
    assert [row_bounds(10, x) for x in w] == [(0, 4), (4, 7), (7, 10)]
    assert row_bounds(10, None) == (0, 10)
    x = torch.arange(12.0).view(6, 2)
    assert torch.equal(shard_rows(x, w[1]), x[2:4])
    assert shard_rows(x, None) is x
    with pytest.raises(ValueError, match="does not divide"):
        shard_rows(torch.zeros(7, 2), w[0])
    assert gather_rows(x, 6, None) is x


def test_backend_rule():
    assert backend_for(torch.device("cpu")) == "gloo"
    assert backend_for(torch.device("cuda", 0)) == "nccl"
    assert backend_for(torch.device("cuda", 0), "gloo") == "gloo"
    assert rank_device("cuda", 3) == torch.device("cuda", 3)
    assert rank_device("cuda:0", 3) == torch.device("cuda", 0)
    assert rank_device("cpu", 3) == torch.device("cpu")


def test_devices_zero_means_every_visible_device(monkeypatch):
    assert resolve_device_count(0, "cpu") == 1
    assert resolve_device_count(3, "cpu") == 3  # gloo ranks share the host
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert resolve_device_count(0, "cuda") == 4
    assert resolve_device_count(2, "cuda") == 2
    with pytest.raises(SystemExit, match="needs 5 CUDA devices; 4 visible"):
        resolve_device_count(5, "cuda")
    with pytest.raises(SystemExit, match="one rank per card"):
        resolve_device_count(2, "cuda:1")


def test_devices_zero_with_a_named_card_is_one_rank(monkeypatch):
    """``--device cuda:N`` with the default ``--devices 0`` runs one
    process on card N, however many cards are visible."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert resolve_device_count(0, "cuda:1") == 1
    assert resolve_device_count(1, "cuda:3") == 1


def test_launcher_and_jobs_default_to_the_card(monkeypatch):
    """Without ``device`` the launcher and the jobs ask for CUDA, and
    raise where it is missing instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spawn(jobs.run, 2, [], join_timeout_s=60)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        jobs.run(None, [("dice_grads", _dice_inputs())])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        jobs.dice_grads(None, **_dice_inputs())


def test_a_failing_rank_fails_the_job():
    with pytest.raises(RuntimeError, match="KeyError: 'no_such_job'"):
        spawn(jobs.run, 2, [("no_such_job", {})], device="cpu",
              join_timeout_s=120)


def test_a_hung_collective_fails_the_job_after_its_timeout():
    """Rank 1 sleeps 60 s instead of joining rank 0's all-reduce: the
    group's 3 s timeout fails rank 0, and the job ends long before rank
    1 would have."""
    import time

    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="rank 0 of 2 failed"):
        spawn(jobs.run, 2, [("stall", dict(rank=1, seconds=60.0))],
              device="cpu", timeout_s=3.0, join_timeout_s=120)
    assert time.perf_counter() - t0 < 45
