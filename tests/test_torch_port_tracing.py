"""The port's spans (``utils.profiling.annotate``) on the CPU, on tiny
models: the evaluation protocol's and the train step's spans and their
nesting, the ``unet.sync`` spans around each host sync, the epoch's
per-step record, the null context with no profiler running, and results
that do not depend on a profiler running."""

import json

import numpy as np
import pytest
import torch
from torch import nn

from jcfszxc_unet_tpu_torch.cli import evaluate as port_eval
from jcfszxc_unet_tpu_torch.train.optim import make_optimizer
from jcfszxc_unet_tpu_torch.train.state import TrainState
from jcfszxc_unet_tpu_torch.train.trainer import make_epoch_fn
from jcfszxc_unet_tpu_torch.utils import profiling

from .torch_port_common import synthetic_train_h5

EVAL_STEPS = ("unet.eval.copy_in", "unet.eval.gather", "unet.eval.forward",
              "unet.eval.stitch", "unet.eval.auc", "unet.eval.dice",
              "unet.eval.copy_out")
TRAIN_STEPS = ("unet.train.sample", "unet.train.forward",
               "unet.train.backward", "unet.train.nan_guard",
               "unet.train.optimizer")


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


def _tiny(seed=0):
    torch.manual_seed(seed)
    return Tiny().to(memory_format=torch.channels_last)


def _split(n=2, h=28, w=24, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.random((n, h, w, 3), dtype=np.float32),
            (rng.random((n, h, w)) > 0.2).astype(np.float32),
            (rng.random((n, h, w)) > 0.7).astype(np.float32))


def _evaluate(model, split):
    # patch 16 over 28 x 24: a grid of 3 x 2 centres an image, 12 patches
    # in chunks of 5 (the last one short)
    return port_eval.evaluate_arrays(model, *split, patch_size=16,
                                     inference_batch_size=5, device="cpu")


def _spans(prof) -> list:
    """(start, end, name) of the ``unet.`` spans of a CPU capture."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("unet."))


def _within(span, outer) -> bool:
    return outer[0] <= span[0] and span[1] <= outer[1]


def _parent(span, spans):
    """The innermost other span that holds ``span``."""
    holders = [o for o in spans if o is not span and _within(span, o)]
    return max(holders, key=lambda o: o[0])[2] if holders else None


def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def test_evaluate_arrays_spans_nest_and_count_the_syncs():
    model, split = _tiny(), _split()
    _, spans = _profiled(lambda: _evaluate(model, split))
    (top,) = [s for s in spans if s[2] == "unet.eval"]
    names = [s[2] for s in spans]
    assert set(EVAL_STEPS) <= set(names)
    for s in spans:
        if s[2] != "unet.eval":
            assert _within(s, top), s[2]
        if s[2] in EVAL_STEPS:
            assert _parent(s, spans) == "unet.eval", s[2]
    assert names.count("unet.eval.forward") == 3  # 12 patches, chunks of 5
    syncs = [s for s in spans if s[2] == "unet.sync"]
    # 3 copies in, the grid's copy, 2 AUCs, the Dice, the maps' copy out
    assert len(syncs) == 3 + 1 + 2 + 1 + 1
    parents = [_parent(s, spans) for s in syncs]
    assert parents == (["unet.eval.copy_in"] * 3 + ["unet.eval.gather"]
                       + ["unet.eval.auc"] * 2
                       + ["unet.eval.dice", "unet.eval.copy_out"])


def _epoch(steps=2, seed=3, nan=False):
    model = _tiny(seed).train()
    state = TrainState(model=model,
                       optimizer=make_optimizer(model.parameters(), 1e-3))
    rng = np.random.default_rng(seed)
    images = torch.as_tensor(rng.random((2, 24, 24, 3), dtype=np.float32))
    labels = torch.as_tensor(
        (rng.random((2, 24, 24, 1)) > 0.7).astype(np.float32))
    if nan:  # every step's loss is NaN
        images[...] = float("nan")
    smap = torch.tensor([[i, x, y] for i in range(2) for x in (8, 12, 16)
                         for y in (8, 16)])
    fn = make_epoch_fn(n_classes=1, batch_size=2, patch_size=16, steps=steps)
    g = torch.Generator().manual_seed(seed)
    return lambda: fn(state, images, labels, smap, g)


def test_epoch_fn_spans_and_per_step_record():
    out, spans = _profiled(_epoch())
    steps = [s for s in spans if s[2] == "unet.train.step"]
    assert len(steps) == 2
    for step in steps:
        inner = [s for s in spans if _parent(s, spans) == "unet.train.step"
                 and _within(s, step)]
        assert [s[2] for s in inner] == list(TRAIN_STEPS)
    syncs = [s for s in spans if s[2] == "unet.sync"]
    assert len(syncs) == 2
    assert all(_parent(s, spans) == "unet.train.nan_guard" for s in syncs)
    losses = out["step_losses"]
    assert losses.shape == (2,) and losses.dtype == torch.float32
    assert bool((losses > 0).all())
    torch.testing.assert_close(losses.sum(), out["epoch_loss"], rtol=1e-6,
                               atol=0)
    ends = out["step_end_s"]
    assert len(ends) == 2 and ends[0] < ends[1]
    assert out["skipped"] == 0


def test_epoch_fn_reads_zero_for_a_skipped_step():
    out = _epoch(nan=True)()
    assert out["skipped"] == 2
    assert out["step_losses"].tolist() == [0.0, 0.0]
    assert float(out["epoch_loss"]) == 0.0


def test_annotate_is_one_null_context_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built")

    assert not torch.autograd._profiler_enabled()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first = profiling.annotate("unet.eval")
    assert profiling.annotate("unet.sync") is first
    with first, profiling.annotate("unet.sync"):
        pass
    _evaluate(_tiny(), _split())  # every span of both paths is the null one
    _epoch(steps=1)()


def test_results_do_not_depend_on_a_profiler():
    split = _split()
    plain = _evaluate(_tiny(), split)
    traced, _ = _profiled(lambda: _evaluate(_tiny(), split))
    np.testing.assert_array_equal(plain["pred_maps"], traced["pred_maps"])
    assert plain["dice"] == traced["dice"] and plain["auc"] == traced["auc"]
    plain = _epoch()()
    traced, _ = _profiled(_epoch())
    assert torch.equal(plain["epoch_loss"], traced["epoch_loss"])
    assert torch.equal(plain["step_losses"], traced["step_losses"])


@pytest.mark.parametrize("flag", [[], ["--profile-dir", "prof"]])
def test_evaluate_cli_profile_dir_writes_the_eval_spans(tmp_path, monkeypatch,
                                                        flag):
    monkeypatch.chdir(tmp_path)
    h5 = synthetic_train_h5(tmp_path)
    ckpt = tmp_path / "tiny.pt"
    from jcfszxc_unet_tpu_torch.train import checkpoint

    monkeypatch.setattr(checkpoint, "load_model_any",
                        lambda path, device, **kw: (_tiny(), {}))
    port_eval.main(["-m", str(ckpt), "-d", h5, "--device", "cpu", "-p", "16",
                    "--inference-batch-size", "8", "--dtype", "float32",
                    "-o", str(tmp_path / "pred")] + flag)
    traces = list((tmp_path / "prof").glob("trace_*.json"))
    if not flag:
        assert not traces
        return
    (path,) = traces
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"unet.eval", "unet.sync", *EVAL_STEPS} <= names
