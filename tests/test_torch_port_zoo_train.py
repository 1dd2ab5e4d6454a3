"""The port's train CLI on each of the eleven zoo models beside UNet that
came before the attention family (CPU, f32): two steps of one epoch on the synthetic DRIVE split at patch 32,
then the best checkpoint reloads with ``strict=True`` under the model's
registry name.  The attention family (BARUNet, BIARUNet, MCUNet and
TransFuseNet) takes the same check in its own files, so that
``--dist loadfile`` spreads the runs over the workers.  The models run at
full width (the JAX package has no width knob); their forwards are held
against JAX in the ``test_torch_port_zoo_*`` files of each family."""

import json

import pytest

from jcfszxc_unet_tpu_torch.cli import train as port_cli
from jcfszxc_unet_tpu_torch.train.checkpoint import load_model

from .torch_port_common import check_train_cli, synthetic_train_h5

ZOO = ["ResUNet.ResUNet", "SegNet.SegNet", "UNetPP.NestedUNet",
       "AttentionUNet.AttentionUNet", "R2UNet.R2UNet",
       "R2AttentionUNet.R2AttentionUNet", "BCDUNet.BCDU_net_D3",
       "BCDUNet.BCDU_net_D1", "MultiResUNet.MultiResUNet",
       "DenseUNet.DenseUNet", "FRUNet.FRUNet"]


@pytest.fixture(scope="module")
def train_h5(tmp_path_factory):
    return synthetic_train_h5(tmp_path_factory.mktemp("drive"))


@pytest.mark.parametrize("name", ZOO)
def test_train_cli_trains_each_zoo_model_two_steps(name, train_h5, tmp_path,
                                                   monkeypatch):
    check_train_cli(name, train_h5, tmp_path, monkeypatch)


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
