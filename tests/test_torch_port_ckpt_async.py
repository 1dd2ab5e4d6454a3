"""The port's background checkpoint writer
(``train/checkpoint.AsyncCheckpointWriter``), counterparts of the JAX
package's ``tests/test_checkpoint_async.py``, plus what the port must add:
the snapshot is taken at ``submit``, since torch tensors change in place,
and ``train_arrays`` writes the same checkpoints with it as without."""

import copy
import os
import time

import numpy as np
import pytest
import torch

from jcfszxc_unet_tpu_torch.cli.train import train_arrays
from jcfszxc_unet_tpu_torch.models import create_model
from jcfszxc_unet_tpu_torch.train import checkpoint as ckpt

from .torch_port_common import FIXTURE_MODEL


def read(path):
    return torch.load(path, weights_only=True)


def test_writes_land_in_submission_order(tmp_path):
    path = str(tmp_path / "best.pt")
    with ckpt.AsyncCheckpointWriter() as writer:
        for i in range(4):
            writer.submit(ckpt.save_state, path, "UNet.UNet", {},
                          {"w": torch.full((3,), float(i))})
    payload = read(path)  # after close, the last submission is the file
    assert payload["model_name"] == "UNet.UNet"
    assert torch.equal(payload["state_dict"]["w"], torch.full((3,), 3.0))


def test_worker_exception_surfaces_on_next_call(tmp_path):
    def boom():
        raise RuntimeError("disk full")

    writer = ckpt.AsyncCheckpointWriter()
    writer.submit(boom)
    with pytest.raises(RuntimeError, match="disk full"):
        writer.wait()
    writer.submit(boom)
    with pytest.raises(RuntimeError, match="disk full"):
        writer.submit(lambda: None)  # submit waits for the previous write
    ok = str(tmp_path / "ok.pt")  # still usable after a failed write
    writer.submit(ckpt.save_state, ok, "UNet.UNet", {}, {"w": torch.ones(2)})
    writer.close()
    assert os.path.exists(ok)


def test_close_waits_for_inflight_write(tmp_path):
    path = str(tmp_path / "slow.pt")

    def slow_save():
        time.sleep(0.2)
        ckpt.save_state(path, "UNet.UNet", {}, {"w": torch.zeros(1)})

    writer = ckpt.AsyncCheckpointWriter()
    writer.submit(slow_save)
    writer.close()
    assert os.path.exists(path)


def test_the_snapshot_is_the_state_at_submit(tmp_path):
    """Parameters changed in place right after ``submit`` (what the next
    optimizer step does) do not reach the file."""
    torch.manual_seed(0)
    model = create_model(FIXTURE_MODEL)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    path = str(tmp_path / "snap.pt")

    def slow_save(*args):
        time.sleep(0.2)  # the writes below happen before this one
        ckpt.save_state(path, *args)

    with ckpt.AsyncCheckpointWriter() as writer:
        writer.submit(slow_save, FIXTURE_MODEL, {}, model.state_dict())
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    got = read(path)["state_dict"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    now = model.state_dict()
    assert not any(torch.equal(got[k], now[k])
                   for k, _ in model.named_parameters())


def _train(model, root, async_checkpoints):
    rng = np.random.RandomState(0)
    images = rng.rand(4, 48, 48, 3).astype(np.float32)
    masks = np.ones((4, 48, 48), np.float32)
    labels = (rng.rand(4, 48, 48) > 0.7).astype(np.float32)
    paths = {"best": str(root / f"best_{async_checkpoints}.pt"),
             "latest": str(root / f"latest_{async_checkpoints}.pt")}
    train_arrays(model, images, masks, labels, model_name=FIXTURE_MODEL,
                 steps=2, batch_size=2, learning_rate=1e-3, val_percent=0.5,
                 patch_size=32, seed=0, save_path=paths["best"],
                 compute_dtype=torch.float32, max_epochs=2, visualize=False,
                 latest_path=paths["latest"], device="cpu",
                 async_checkpoints=async_checkpoints)
    return {k: read(p) for k, p in paths.items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_train_arrays_writes_the_same_checkpoints_in_both_modes(tmp_path):
    torch.manual_seed(3)
    model = create_model(FIXTURE_MODEL)
    sync = _train(copy.deepcopy(model), tmp_path, False)
    background = _train(model, tmp_path, True)
    assert sync["latest"]["extra"]["progress"]["epoch"] == 2
    assert "optimizer" in sync["latest"]["extra"]
    for which in ("best", "latest"):
        want, got = dict(_flat(sync[which])), dict(_flat(background[which]))
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(got[k], v), (which, k)
            else:
                assert got[k] == v, (which, k)
