"""The train step's CUDA graph (``train/step_graph.py`` through
``train/trainer.make_batch_step_fn``).

On the CPU: the step runs eagerly and counts why (the device, ``remat``,
a ``world``), with the numbers of the plain eager step; the graph's key
moves with a replaced parameter, a moved model and a new batch shape, and
the schedule re-keys on it; an epoch's ``step_losses`` hold each step's
own loss.

On the card (``python3 -m pytest tests/test_torch_port_train_graph.py -m
cuda``): graph against eager epochs of UNet from one state, a NaN batch
under the graph, a re-capture after ``model.to``, NestedUNet and a model
with dropout, the fallbacks on a synchronising model and on a capture
that raises, and the replayed kernels in a ``torch.profiler`` capture.
The eager side of each comparison is the step function with a one-rank
``world``, which takes the eager path and runs no collective."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch import nn

from jcfszxc_unet_tpu_torch.data.sampler import build_train_sample_map
from jcfszxc_unet_tpu_torch.models import MODEL_REGISTRY
from jcfszxc_unet_tpu_torch.parallel.mesh import World
from jcfszxc_unet_tpu_torch.train import step_graph
from jcfszxc_unet_tpu_torch.train.optim import make_optimizer
from jcfszxc_unet_tpu_torch.train.state import TrainState
from jcfszxc_unet_tpu_torch.train.step_graph import StepGraph, graph_key
from jcfszxc_unet_tpu_torch.train.trainer import (
    make_batch_step_fn,
    make_epoch_fn,
)


class Tiny(nn.Module):
    """conv3x3-BN-ReLU then a 1x1 head: NCHW in, one logit out."""

    def __init__(self, width: int = 4):
        super().__init__()
        self.n_classes = 1
        self.conv = nn.Conv2d(3, width, 3, padding=1)
        self.bn = nn.BatchNorm2d(width)
        self.head = nn.Conv2d(width, 1, 1)

    def forward(self, x):
        return self.head(torch.relu(self.bn(self.conv(x))))


def _state(seed=0, device="cpu", model=None):
    torch.manual_seed(seed)
    model = (model or Tiny()).to(device, memory_format=torch.channels_last)
    return TrainState(model=model.train(),
                      optimizer=make_optimizer(model.parameters(), 1e-3))


def _batches(n, b=2, p=16, seed=1, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return [(torch.rand((b, p, p, 3), generator=g).to(device),
             (torch.rand((b, p, p, 1), generator=g) > 0.7).float().to(device))
            for _ in range(n)]


def _one_rank(device) -> World:
    """A world of one rank: the step takes its eager path and runs no
    collective."""
    return World(rank=0, size=1, device=torch.device(device), backend="gloo")


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reason", ["device", "remat", "world"])
def test_eager_steps_count_their_reason_and_keep_the_eager_numbers(reason):
    """Three steps of each eager route: the counter names the reason for
    every step, nothing is captured, and the losses and parameters are
    those of the plain eager step (to the last bit, but for ``remat``,
    whose recomputed forward may round differently)."""
    kwargs = {"device": {}, "remat": {"remat": True},
              "world": {"world": _one_rank("cpu")}}[reason]
    runs = []
    for kw in ({}, kwargs):
        state = _state()
        step = make_batch_step_fn(n_classes=1, **kw)
        losses = [float(step(state, x, y)[0]) for x, y in _batches(3)]
        runs.append((losses, [p.detach().clone()
                              for p in state.model.parameters()], step))
    (want_l, want_p, _), (got_l, got_p, step) = runs
    c = step.counter
    assert (c.captures, c.replays, c.eager) == (0, 0, 3)
    assert c.reasons == {reason: 3}
    tol = {"rtol": 1e-6, "atol": 1e-7} if reason == "remat" else {
        "rtol": 0, "atol": 0}
    torch.testing.assert_close(got_l, want_l, **tol)
    for g, w in zip(got_p, want_p):
        torch.testing.assert_close(g, w, **tol)


def test_graph_key_moves_with_what_the_capture_depends_on():
    model = Tiny().to(memory_format=torch.channels_last)
    x, y = _batches(1)[0]
    key = graph_key(model, x, y)
    assert graph_key(model, x.clone(), y.clone()) == key  # new batch data
    model.load_state_dict(Tiny().state_dict())  # in place
    assert graph_key(model, x, y) == key
    with torch.no_grad():
        model.conv.weight.add_(1.0)  # an optimizer's in-place update
    assert graph_key(model, x, y) == key
    assert graph_key(model, x[:1], y[:1]) != key  # a new batch shape
    assert graph_key(model, x.double(), y) != key  # a new dtype
    assert graph_key(Tiny(), x, y) != key  # another model
    moved = graph_key(model.to(memory_format=torch.contiguous_format), x, y)
    assert moved != key  # model.to: new storages
    model.head.bias = nn.Parameter(torch.zeros(1))  # a replaced parameter
    assert graph_key(model, x, y) != moved


def _fake_capture(sg, key, holds=True):
    """What a successful capture leaves, without a card."""
    sg.captured = SimpleNamespace(key=key, holds_grads=lambda: holds)


def test_schedule_re_keys_on_a_new_key_and_on_lost_gradients():
    """The schedule behind ``StepGraph.route``: ``WARMUP_STEPS`` warm-up
    steps, then the capture, then replays while the key holds; a new key
    (a replaced parameter, a new batch shape) drops the graph and warms up
    again, and so does a gradient that is no longer the capture's."""
    model = Tiny().to(memory_format=torch.channels_last)
    x, y = _batches(1)[0]
    sg = StepGraph()
    key = graph_key(model, x, y)
    routes = []
    for _ in range(step_graph.WARMUP_STEPS):
        routes.append(sg.schedule(key))
        sg.warmed += 1  # what StepGraph.warm_up counts
    assert routes == ["warm-up"] * step_graph.WARMUP_STEPS
    assert sg.schedule(key) == "capture"
    _fake_capture(sg, key)
    assert [sg.schedule(key) for _ in range(3)] == ["replay"] * 3

    model.head.bias = nn.Parameter(torch.zeros(1))
    new = graph_key(model, x, y)
    assert sg.schedule(new) == "warm-up" and sg.captured is None
    sg.warmed = step_graph.WARMUP_STEPS
    _fake_capture(sg, new)
    assert sg.schedule(new) == "replay"
    assert sg.schedule(graph_key(model, x[:1], y[:1])) == "warm-up"
    assert sg.captured is None

    _fake_capture(sg, new, holds=False)
    assert sg.schedule(new) == "warm-up" and sg.captured is None


def test_captured_gradients_are_held_until_one_is_dropped():
    state = _state()
    step = make_batch_step_fn(n_classes=1)
    step(state, *_batches(1)[0])
    params = list(state.model.parameters())
    c = SimpleNamespace(grads=[(p, p.grad.data_ptr()) for p in params])
    assert step_graph._Captured.holds_grads(c)
    params[0].grad.data = params[0].grad.clone()  # new memory, same .grad
    assert not step_graph._Captured.holds_grads(c)
    c.grads[0] = (params[0], params[0].grad.data_ptr())
    assert step_graph._Captured.holds_grads(c)
    state.optimizer.zero_grad(set_to_none=True)
    assert not step_graph._Captured.holds_grads(c)


def test_route_on_the_cpu_is_eager_whatever_the_schedule():
    sg = StepGraph()
    model = Tiny()
    x, y = _batches(1)[0]
    _fake_capture(sg, graph_key(model, x, y))
    assert sg.route(model, x, y) == "device"
    assert sg.captured is None  # an eager step drops a graph it would stale
    assert StepGraph(remat=True).route(model, x, y) == "remat"
    assert StepGraph(world=_one_rank("cpu")).route(model, x, y) == "world"


def _epoch_inputs(device="cpu", n=4, hw=48, seed=2):
    rng = np.random.default_rng(seed)
    images = torch.as_tensor(rng.random((n, hw, hw, 3), dtype=np.float32),
                             device=device)
    labels = torch.as_tensor(
        (rng.random((n, hw, hw, 1)) > 0.8).astype(np.float32), device=device)
    masks = np.ones((n, hw, hw), np.float32)
    return images, labels, masks


def test_step_losses_hold_each_steps_own_loss():
    images, labels, masks = _epoch_inputs()
    smap = torch.as_tensor(build_train_sample_map(masks, 8)).long()
    state = _state()
    fn = make_epoch_fn(n_classes=1, batch_size=2, patch_size=16, steps=5)
    out = fn(state, images, labels, smap, torch.Generator().manual_seed(0))
    losses = out["step_losses"].tolist()
    assert len(set(losses)) == 5, losses
    torch.testing.assert_close(out["step_losses"].sum(), out["epoch_loss"],
                               rtol=1e-6, atol=0)
    assert fn.counter.reasons == {"device": 5}


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _zoo_state(name, seed, device):
    from jcfszxc_unet_tpu_torch.models import create_model
    from jcfszxc_unet_tpu_torch.ops.layers import reset_parameters

    model = create_model(name)
    reset_parameters(model, torch.Generator().manual_seed(seed))
    model = model.to(device, memory_format=torch.channels_last).train()
    return TrainState(model=model, optimizer=make_optimizer(
        model.parameters(), 1e-4, 1e-8, 0.999))


def _snapshot(state) -> dict:
    """Parameters, RMSprop's state and the buffers, on the host."""
    model, opt = state.model, state.optimizer
    out = {f"param.{n}": p.detach().float().cpu()
           for n, p in model.named_parameters()}
    out.update({f"buffer.{n}": b.detach().double().cpu()
                for n, b in model.named_buffers()})
    for i, p in enumerate(model.parameters()):
        for k, v in opt.state.get(p, {}).items():
            if torch.is_tensor(v):
                out[f"opt.{i}.{k}"] = v.detach().double().cpu()
    return out


def _train(name, device, steps, *, eager, seed=0, batch=8, patch=64,
           epochs=1, between=None):
    """``epochs`` epochs of ``steps`` steps of a seeded zoo model on
    batches sampled on the card, through one epoch function
    (``between(state)`` runs after the first epoch); (step losses,
    snapshot, counter)."""
    images, labels, masks = _epoch_inputs(device, n=6, hw=2 * patch)
    smap = torch.as_tensor(build_train_sample_map(masks, patch // 2),
                           device=device).long()
    state = _zoo_state(name, seed, device)
    fn = make_epoch_fn(n_classes=state.model.n_classes, batch_size=batch,
                       patch_size=patch, steps=steps,
                       compute_dtype=torch.bfloat16,
                       world=_one_rank(device) if eager else None)
    g = torch.Generator(device=device).manual_seed(seed + 1)
    torch.manual_seed(seed + 2)  # dropout
    losses = []
    for epoch in range(epochs):
        if epoch == 1 and between is not None:
            between(state)
        losses.append(fn(state, images, labels, smap, g)["step_losses"])
    torch.cuda.synchronize()
    return torch.cat(losses).double().cpu(), _snapshot(state), fn.counter


def _as_tight_as_eager(eagers, graph):
    """The graph run against the first of the eager runs: each loss and
    tensor equal where the eager runs are all equal; where they are not (a
    backward's atomics), the graph's gap within 3x the widest gap between
    two eager runs, over each group of them (losses, parameters, buffers,
    RMSprop's state) as one vector."""
    runs = [dict(snap, losses=losses) for losses, snap, _ in eagers]
    g = dict(graph[1], losses=graph[0])
    a = runs[0]
    assert a.keys() == g.keys()
    unequal = {k for k in a if any(not torch.equal(a[k], r[k])
                                   for r in runs[1:])}
    differ = [k for k in a if k not in unequal and not torch.equal(a[k], g[k])]
    assert not differ, differ[:10]

    def gap(x, y, keys):
        return sum(float((x[k] - y[k]).double().pow(2).sum())
                   for k in keys) ** 0.5

    for group in ("losses", "param.", "buffer.", "opt."):
        keys = [k for k in unequal if k.startswith(group)]
        if not keys:
            continue
        own = max(gap(x, y, keys) for i, x in enumerate(runs)
                  for y in runs[i + 1:])
        got = gap(a, g, keys)
        print(f"{group} {len(keys)} unequal: eager {own:.3e}, graph {got:.3e}")
        assert got <= 3 * own, (group, own, got)


@pytest.mark.cuda
def test_unet_graph_epochs_match_eager_epochs(cuda_device):
    """UNet, bf16, batch 32 of 128^2, 20 steps from one state: two eager
    epochs and one graph epoch."""
    runs = [_train("UNet.UNet", cuda_device, 20, eager=e, batch=32,
                   patch=128) for e in (True, True, False)]
    c = runs[2][2]
    assert (c.captures, c.replays) == (1, 20 - step_graph.WARMUP_STEPS)
    assert c.reasons == {"warm-up": step_graph.WARMUP_STEPS}
    assert runs[0][2].reasons == {"world": 20}
    assert len(set(runs[2][0].tolist())) == 20  # each step's own loss
    _as_tight_as_eager(runs[:2], runs[2])


@pytest.mark.cuda
def test_nan_batch_under_the_graph_skips_and_later_steps_resume(cuda_device):
    state = _zoo_state("UNet.UNet", 0, cuda_device)
    step = make_batch_step_fn(n_classes=1, compute_dtype=torch.bfloat16)
    good = _batches(6, b=4, p=64, device=cuda_device)
    for x, y in good[:4]:
        assert step(state, x, y)[1]
    assert (step.counter.captures, step.counter.replays) == (1, 2)
    before = _snapshot(state)
    bad = good[4][0].clone()
    bad[0, 3, 4, 1] = float("nan")
    loss, ok = step(state, bad, good[4][1])
    assert not ok and float(loss) == 0.0
    after = _snapshot(state)
    for k, v in before.items():
        if not k.startswith("buffer."):  # BN keeps the forward's update
            assert torch.equal(after[k], v), k
    # The gradients stay the graph's, for the next replay to overwrite.
    assert step.counter.replays == 3
    loss, ok = step(state, *good[5])
    assert ok and bool(torch.isfinite(loss))
    assert (step.counter.captures, step.counter.replays) == (1, 4)
    assert any(not torch.equal(_snapshot(state)[k], v)
               for k, v in after.items() if k.startswith("param."))


@pytest.mark.cuda
def test_model_to_re_captures(cuda_device):
    """Two epochs of 5 steps, the model moved to the host and back between
    them: the graph is captured again, and the run agrees with eager."""
    def move(state):
        state.model.cpu().to(cuda_device, memory_format=torch.channels_last)

    runs = [_train("UNet.UNet", cuda_device, 5, eager=e, epochs=2,
                   between=move) for e in (True, True, False)]
    c = runs[2][2]
    assert c.captures == 2
    assert c.reasons == {"warm-up": 2 * step_graph.WARMUP_STEPS}
    _as_tight_as_eager(runs[:2], runs[2])


@pytest.mark.cuda
@pytest.mark.parametrize("name", [n for n in MODEL_REGISTRY
                                  if n != "UNet.UNet"])
def test_other_models_replay_correctly_or_train_eagerly(cuda_device, name):
    """The zoo's other fifteen models, NestedUNet and the two with dropout
    (FRUNet, BCDU_net_D1) among them: either captured and as close to
    eager as eager is to itself, or eager with the counter's reason."""
    runs = [_train(name, cuda_device, 6, eager=e, patch=64)
            for e in (True, True, True, False)]
    c = runs[3][2]
    print(name, vars(c))
    if c.captures:
        assert c.replays == 6 - step_graph.WARMUP_STEPS
    else:
        assert set(c.reasons) - {"warm-up"} <= {"sync seen", "capture error"}
    _as_tight_as_eager(runs[:3], runs[3])


class _SyncsWhen(nn.Module):
    """A Tiny that reads a value on the host in its forward: always
    (``always``), or only under a capture, where the read raises."""

    def __init__(self, always: bool):
        super().__init__()
        self.inner, self.always = Tiny(), always
        self.n_classes = 1

    def forward(self, x):
        if self.always or torch.cuda.is_current_stream_capturing():
            float(x.mean())
        return self.inner(x)


@pytest.mark.cuda
@pytest.mark.parametrize("always,reason", [(True, "sync seen"),
                                           (False, "capture error")])
def test_uncapturable_model_trains_eagerly_losing_no_step(cuda_device,
                                                          always, reason):
    batches = _batches(6, device=cuda_device)
    runs = []
    for kw in ({"world": _one_rank(cuda_device)},) * 2 + ({},):
        state = _state(device=cuda_device, model=_SyncsWhen(always))
        step = make_batch_step_fn(n_classes=1, **kw)
        losses = torch.stack([step(state, x, y)[0] for x, y in batches])
        runs.append((losses.double().cpu(), _snapshot(state), step.counter))
    c = runs[2][2]
    assert (c.captures, c.replays, c.eager) == (0, 0, 6)
    n_warm = 1 if always else step_graph.WARMUP_STEPS
    assert c.reasons == {"warm-up": n_warm, reason: 6 - n_warm}
    assert bool((runs[2][0] > 0).all())  # no step lost
    _as_tight_as_eager(runs[:2], runs[2])


DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def _kernels(prof) -> tuple:
    """(events, busy us) of a capture's device work (kernels, copies,
    sets; not the spans the profiler mirrors onto the device's timeline):
    their count and the length of the union of their intervals."""
    spans = []
    for e in prof.profiler.kineto_results.events():
        if hasattr(e, "activity_type"):
            if e.activity_type() not in DEVICE_WORK:
                continue
        elif "CUDA" not in str(e.device_type()) or e.is_user_annotation():
            continue
        spans.append((e.start_ns() / 1e3,
                      (e.start_ns() + e.duration_ns()) / 1e3))
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        busy += max(0.0, hi - max(lo, end))
        end = max(end, hi)
    return len(spans), busy


@pytest.mark.cuda
def test_replayed_kernels_appear_under_the_profiler(cuda_device):
    """Three replayed steps under ``torch.profiler`` hold as many device
    events and as much busy time as three eager steps, within a tenth."""
    batches = _batches(8, b=32, p=128, device=cuda_device)
    seen = []
    for kw in ({"world": _one_rank(cuda_device)}, {}):
        state = _zoo_state("UNet.UNet", 0, cuda_device)
        step = make_batch_step_fn(n_classes=1, compute_dtype=torch.bfloat16,
                                  **kw)
        for x, y in batches[:5]:
            step(state, x, y)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for x, y in batches[5:]:
                step(state, x, y)
            torch.cuda.synchronize()
        seen.append(_kernels(prof))
    (n_eager, us_eager), (n_graph, us_graph) = seen
    print("eager", seen[0], "graph", seen[1])
    assert n_graph >= 0.9 * n_eager
    assert abs(us_graph - us_eager) <= 0.1 * us_eager
