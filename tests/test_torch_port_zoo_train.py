"""The port's train CLI on each of the eleven zoo models beside UNet (CPU,
f32): two steps of one epoch on the synthetic DRIVE split at patch 32,
then the best checkpoint reloads with ``strict=True`` under the model's
registry name.  The models run at full width (the JAX package has no
width knob); their forwards are held against JAX in the
``test_torch_port_zoo_*`` files of each family."""

import json

import numpy as np
import pytest

from jcfszxc_unet_tpu.data.preprocess import preprocess_dataset
from jcfszxc_unet_tpu_torch.cli import train as port_cli
from jcfszxc_unet_tpu_torch.ops.kernels import conv_fused
from jcfszxc_unet_tpu_torch.train.checkpoint import load_model

from .test_e2e import make_synthetic_drive

ZOO = ["ResUNet.ResUNet", "SegNet.SegNet", "UNetPP.NestedUNet",
       "AttentionUNet.AttentionUNet", "R2UNet.R2UNet",
       "R2AttentionUNet.R2AttentionUNet", "BCDUNet.BCDU_net_D3",
       "BCDUNet.BCDU_net_D1", "MultiResUNet.MultiResUNet",
       "DenseUNet.DenseUNet", "FRUNet.FRUNet"]


@pytest.fixture(scope="module")
def train_h5(tmp_path_factory):
    root = tmp_path_factory.mktemp("drive")
    make_synthetic_drive(str(root / "raw"))
    info = preprocess_dataset(dataset_path=str(root / "raw"),
                              output_dir=str(root / "data"),
                              save_method="h5", include_test=False)
    return info["train"]["output_file"]


@pytest.mark.parametrize("name", ZOO)
def test_train_cli_trains_each_zoo_model_two_steps(name, train_h5, tmp_path,
                                                   monkeypatch):
    monkeypatch.chdir(tmp_path)
    best, metrics = str(tmp_path / "best.pt"), str(tmp_path / "m.jsonl")
    before = conv_fused.counter.launches
    port_cli.main(["-d", train_h5, "--device", "cpu", "--model", name,
                   "-p", "32", "-b", "2", "-s", "2", "--max-epochs", "1",
                   "--dtype", "float32", "-v", "50", "--save-path", best,
                   "--metrics-file", metrics])
    assert conv_fused.counter.launches == before  # plain versions on the CPU
    (rec,) = [json.loads(line) for line in open(metrics)]
    assert rec["epoch"] == 1 and rec["skipped_steps"] == 0
    assert np.isfinite(rec["loss"]) and 0 <= rec["dice"] <= 1
    model, cfg = load_model(best, device="cpu")  # strict=True
    assert cfg["model_name"] == name and not model.training


def test_train_cli_logit_head_is_recorded_and_reloads(train_h5, tmp_path,
                                                      monkeypatch):
    from jcfszxc_unet_tpu_torch.cli import evaluate as eval_cli

    monkeypatch.chdir(tmp_path)
    best = str(tmp_path / "best.pt")
    base = ["-d", train_h5, "--device", "cpu", "-p", "32", "-b", "2", "-s",
            "1", "--max-epochs", "1", "--dtype", "float32", "-v", "50",
            "--save-path", best, "--logit-head"]
    port_cli.main(base + ["--model", "BCDU_net_D3"])  # the bare-class alias
    model, cfg = load_model(best, device="cpu")  # strict=True
    assert cfg["model_name"] == "BCDUNet.BCDU_net_D3"
    assert cfg["model_kwargs"] == {"N": 32, "logit_head": True}
    assert model.logit_head
    out_json = str(tmp_path / "metrics.json")
    eval_cli.main(["-m", best, "-d", train_h5, "-p", "32", "-n", "1",
                   "--dtype", "float32", "--device", "cpu",
                   "--metrics-json", out_json])
    rec = json.loads(open(out_json).read())
    assert rec["n_images"] == 4 and 0 <= rec["mean_dice"] <= 1
    with pytest.raises(SystemExit, match="not supported by UNet.UNet.*"
                       "BCDUNet.BCDU_net_D1, BCDUNet.BCDU_net_D3"):
        port_cli.main(base + ["--model", "UNet.UNet"])
