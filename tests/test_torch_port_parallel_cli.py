"""The port's train CLI with ``--devices 2 --device cpu`` (two gloo ranks
spawned by the CLI) on the synthetic DRIVE split, against the same CLI in
one process: rank 0 alone writes the checkpoints, the metrics file and
the epoch lines; the checkpoint loads strict and is close to the
one-process run's; the flags compose (``--logit-head``, ``--remat``,
``--augment``, ``--precise-bn``, ``--resume``, ``--s2d``)."""

import json

import numpy as np
import pytest

from jcfszxc_unet_tpu_torch.cli import train as port_cli
from jcfszxc_unet_tpu_torch.train.checkpoint import load_extra, load_model

from .torch_port_common import synthetic_train_h5

TFN = "RetinaLiteNet.TransFuseNet"


@pytest.fixture(scope="module")
def train_h5(tmp_path_factory):
    return synthetic_train_h5(tmp_path_factory.mktemp("drive"))


def _run(train_h5, out, devices, *flags):
    """One CLI run in ``out``; returns its metrics records and the
    output it printed."""
    out.mkdir(exist_ok=True)
    port_cli.main(["-d", train_h5, "--device", "cpu", "--devices", devices,
                   "--dist-timeout", "60",
                   "-p", "32", "-b", "4", "-s", "2", "--dtype", "float32",
                   "-v", "50", "--save-path", str(out / "best.pt"),
                   "--latest-path", str(out / "latest.pt"),
                   "--metrics-file", str(out / "m.jsonl"), *flags])
    return [json.loads(line) for line in open(out / "m.jsonl")]


def _assert_close_runs(one, two, recs1, recs2):
    """Two runs of the same flags, in one process and over two ranks:
    the same epochs, losses within 1e-4 relative, val Dice within 1e-3
    (a pixel at the 0.5 cut may flip on f32 noise), parameters and
    running statistics within rtol 1e-3 / atol 5e-5 (the bounds of
    tests/test_parallel.py:222-226 at lr 1e-6)."""
    assert [r["epoch"] for r in recs1] == [r["epoch"] for r in recs2]
    for a, b in zip(recs1, recs2):
        assert b["skipped_steps"] == a["skipped_steps"] == 0
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-4)
        assert abs(b["dice"] - a["dice"]) < 1e-3
    m1, cfg1 = load_model(str(one / "best.pt"), device="cpu")
    m2, cfg2 = load_model(str(two / "best.pt"), device="cpu")  # strict
    assert cfg1 == cfg2
    sd1 = m1.state_dict()
    for k, v in m2.state_dict().items():
        np.testing.assert_allclose(v.numpy(), sd1[k].numpy(), rtol=1e-3,
                                   atol=5e-5, err_msg=k)


def test_train_cli_over_two_ranks_matches_one_process(train_h5, tmp_path,
                                                      monkeypatch, capfd):
    """TransFuseNet with its logit head, 2 epochs of 2 steps at global
    batch 4; then ``--resume`` of the two-rank run's latest file over two
    ranks runs epoch 3 alone."""
    monkeypatch.chdir(tmp_path)
    flags = ["--model", TFN, "--logit-head", "--max-epochs", "2"]
    recs1 = _run(train_h5, tmp_path / "one", "1", *flags)
    capfd.readouterr()
    recs2 = _run(train_h5, tmp_path / "two", "2", *flags)
    printed = capfd.readouterr().out
    assert printed.count("Epoch 1 - ") == 1 and printed.count(
        "Epoch 2 - ") == 1  # rank 0 alone prints the epoch lines
    assert len(recs2) == 2  # and writes the metrics file
    _assert_close_runs(tmp_path / "one", tmp_path / "two", recs1, recs2)
    assert load_extra(str(tmp_path / "two" / "latest.pt"))[
        "progress"]["epoch"] == 2

    recs3 = _run(train_h5, tmp_path / "two", "2", "--resume",
                 str(tmp_path / "two" / "latest.pt"), "--max-epochs", "3")
    assert [r["epoch"] for r in recs3] == [1, 2, 3]
    assert load_extra(str(tmp_path / "two" / "latest.pt"))[
        "progress"]["epoch"] == 3


def test_train_cli_flags_compose_over_two_ranks(train_h5, tmp_path,
                                                monkeypatch):
    """``--remat --augment --precise-bn 2`` over two ranks: the batch and
    its augmentation drawn whole on each rank, the recomputed forward's
    BatchNorm all-reduces and precise BN's global statistics give the
    one-process run's numbers."""
    monkeypatch.chdir(tmp_path)
    flags = ["--model", TFN, "--logit-head", "--max-epochs", "1", "--remat",
             "--augment", "--precise-bn", "2"]
    recs1 = _run(train_h5, tmp_path / "one", "1", *flags)
    recs2 = _run(train_h5, tmp_path / "two", "2", *flags)
    _assert_close_runs(tmp_path / "one", tmp_path / "two", recs1, recs2)


def test_train_cli_trains_frunet_in_s2d_over_two_ranks(train_h5, tmp_path,
                                                      monkeypatch):
    """FRUNet with ``--s2d`` (its dropout draws one stream a rank, so the
    run is not held against one process): one epoch, a finite loss, and
    a checkpoint that records ``s2d`` and loads strict."""
    monkeypatch.chdir(tmp_path)
    (rec,) = _run(train_h5, tmp_path, "2", "--model", "FRUNet.FRUNet",
                  "--s2d", "--max-epochs", "1")
    assert rec["skipped_steps"] == 0 and np.isfinite(rec["loss"])
    model, cfg = load_model(str(tmp_path / "best.pt"), device="cpu")
    assert cfg == {"model_name": "FRUNet.FRUNet",
                   "model_kwargs": {"s2d": True}}
