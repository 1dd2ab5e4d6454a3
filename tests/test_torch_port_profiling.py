"""The port's profiling tools (``utils/profiling.py``) on the CPU: a
trace file with the annotated regions, anomaly mode, and the train CLI's
``--profile-dir``."""

import json

import pytest
import torch

from jcfszxc_unet_tpu_torch.cli import train as port_cli
from jcfszxc_unet_tpu_torch.utils import profiling

from .torch_port_common import synthetic_train_h5


def _events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def test_trace_writes_a_chrome_trace_with_annotations(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)):
        with profiling.annotate("fractal_region"):
            torch.relu(torch.randn(64, 64)) @ torch.randn(64, 64)
    (path,) = logdir.glob("trace_*.json")
    names = {e.get("name") for e in _events(path)}
    assert "fractal_region" in names
    assert any(n and n.startswith("aten::") for n in names)


def test_trace_writes_its_file_when_the_region_raises(tmp_path):
    try:
        with profiling.trace(str(tmp_path)):
            torch.ones(3).sum()
            raise KeyError("stop")
    except KeyError:
        pass
    assert len(list(tmp_path.glob("trace_*.json"))) == 1


def test_enable_nan_debugging_toggles_anomaly_mode():
    try:
        profiling.enable_nan_debugging()
        assert torch.is_anomaly_enabled()
        x = torch.zeros(1, requires_grad=True)
        # anomaly mode warns with the forward's traceback, then raises
        with pytest.warns(UserWarning, match="SqrtBackward"), \
                pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x - 1).sum().backward()  # NaN in the backward
    finally:
        profiling.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()


def test_train_cli_profile_dir_writes_a_trace(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    train_h5 = synthetic_train_h5(tmp_path)
    port_cli.main(["-d", train_h5, "--device", "cpu", "-p", "32", "-b", "2",
                   "-s", "1", "--max-epochs", "1", "--dtype", "float32",
                   "-v", "50", "--save-path", str(tmp_path / "best.pt"),
                   "--profile-dir", str(tmp_path / "prof")])
    (path,) = (tmp_path / "prof").glob("trace_*.json")
    names = {e.get("name") for e in _events(path)}
    assert "aten::convolution" in names  # the train step ran inside it
