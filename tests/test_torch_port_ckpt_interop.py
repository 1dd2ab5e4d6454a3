"""Checkpoint interop of the PyTorch port against the JAX package's readers
and writers: JAX msgpack ``.ckpt`` files into the port, reference ``.pth``
files (whole module, bare state dict, bundle) into the port, and the
port's ``.pth`` export (``train/checkpoint.load_model_any``,
``compat/torch_import.py``, ``compat/torch_export.py``).

Forwards are compared on TransFuseNet only (the JAX fixture in
``tests/torch_port_data/``); the other models are compared by their
state dicts, bit for bit.  The ``.pth`` fixtures are the port's own
modules pickled under the reference's class identity
(``UNetFamily.<Module>.<Class>``), which is what a reference
``torch.save(model, "best_model.pth")`` holds.
"""

import json
import logging
import sys
import types

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from jcfszxc_unet_tpu.compat.torch_import import (
    load_pth_state_dict as jax_load_pth_state_dict,
)
from jcfszxc_unet_tpu.compat.torch_import import variables_from_state_dict
from jcfszxc_unet_tpu.compat.torch_mapping import variables_to_state_dict
from jcfszxc_unet_tpu.train.checkpoint import load_model_any as jax_load_any
from jcfszxc_unet_tpu.train.checkpoint import save_model as jax_save_model
from jcfszxc_unet_tpu_torch.cli import train as port_train_cli
from jcfszxc_unet_tpu_torch.compat import torch_export, torch_import
from jcfszxc_unet_tpu_torch.compat.from_jax import state_dict_from_jax
from jcfszxc_unet_tpu_torch.models import MODEL_REGISTRY
from jcfszxc_unet_tpu_torch.train import checkpoint as ckpt

from .torch_port_common import (
    EVAL_TOL,
    FIXTURE_MODEL,
    JAX_FIXTURE,
    JAX_FIXTURE_OUT,
    assert_close_to,
    assert_same_tree,
    fixture_input,
    jax_fixture,
    jax_model,
    port_model,
    random_variables,
    to_nhwc,
    to_port,
)

# The fixture's conv and projection kernels are scaled by this: at the
# init's scale the BatchNorm-free decoder flattens TransFuseNet's logits
# to a std of 2.9e-3; scaled 3x their std is ~0.35.
FIXTURE_KERNEL_SCALE = 3.0


def write_jax_fixture(ckpt_path=JAX_FIXTURE, out_path=JAX_FIXTURE_OUT):
    """Write the JAX ``.ckpt`` fixture: TransFuseNet with its logit head,
    seed 0, random BatchNorm statistics, kernels scaled by
    ``FIXTURE_KERNEL_SCALE``, through the JAX package's ``save_model``;
    and its f32 output on ``fixture_input()`` as ``.npy``."""
    model, variables = jax_model(FIXTURE_MODEL, seed=0, hw=64,
                                 logit_head=True)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, a: a * np.float32(FIXTURE_KERNEL_SCALE)
        if path[-1].key == "kernel" else a, variables)
    jax_save_model(str(ckpt_path), FIXTURE_MODEL, {"logit_head": True},
                   variables["params"], variables["batch_stats"])
    out = jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, fixture_input())
    np.save(str(out_path), np.asarray(out))


@pytest.fixture(scope="module")
def fixture():
    """(JAX module, numpy variables, JAX f32 output on fixture_input())."""
    model, variables, config = jax_fixture()
    assert config["model_kwargs"] == {"logit_head": True}
    out = jax.jit(lambda v, x: model.apply(v, x, train=False))(
        variables, fixture_input())
    return model, variables, np.asarray(out)


# ---------------------------------------------------------------------------
# JAX .ckpt -> port
# ---------------------------------------------------------------------------

def test_jax_fixture_holds_against_the_jax_package(fixture):
    model, variables, out = fixture
    raw = JAX_FIXTURE.read_bytes()
    assert_same_tree(ckpt.read_jax_ckpt(str(JAX_FIXTURE)),
                     dict(serialization.msgpack_restore(raw),
                          config=json.loads(
                              serialization.msgpack_restore(raw)["config"])))
    np.testing.assert_allclose(out, np.load(str(JAX_FIXTURE_OUT)), rtol=0,
                               atol=1e-5)
    assert out.std() > 1e-2  # the comparison on the card can fail


def test_jax_ckpt_forward_matches_jax(fixture):
    _, _, want = fixture
    model, config = ckpt.load_model_any(str(JAX_FIXTURE), device="cpu")
    assert config == {"model_name": FIXTURE_MODEL,
                      "model_kwargs": {"logit_head": True}}
    assert not model.training and model.logit_head
    with torch.no_grad():
        got = to_nhwc(model(to_port(fixture_input())))
    assert_close_to(got, want, EVAL_TOL)


def test_jax_ckpt_with_s2d_loads_without_it(tmp_path, caplog):
    name = "MultiResUNet.MultiResUNet"
    _, variables = random_variables(name)
    path = str(tmp_path / "mres.ckpt")
    jax_save_model(path, name, {"s2d": True}, variables["params"],
                   variables["batch_stats"])
    with caplog.at_level(logging.INFO):
        model, config = ckpt.load_model_any(path, device="cpu")
    assert config["model_kwargs"] == {"s2d": True}  # as the file has it
    assert any("without s2d" in r.message for r in caplog.records)
    want = state_dict_from_jax(name, variables)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_resume_refuses_a_jax_ckpt():
    with pytest.raises(SystemExit, match="--load takes it, --resume needs "
                                         "a port checkpoint"):
        port_train_cli.main(["--resume", str(JAX_FIXTURE), "--device", "cpu"])


def test_a_file_of_no_known_format_raises(tmp_path):
    path = tmp_path / "notes.ckpt"
    path.write_bytes(b"hello, not a checkpoint")
    with pytest.raises(ValueError, match="none of the checkpoint formats.*"
                                         "tried: a torch zip"):
        ckpt.load_model_any(str(path), device="cpu")


def test_a_failing_reader_does_not_fall_through(tmp_path):
    """A msgpack map that is no JAX checkpoint raises from the msgpack
    route; it is not handed to torch.load."""
    path = tmp_path / "map.ckpt"
    path.write_bytes(bytes([0x81, 0xa1, 0x61, 0xc1]))  # {"a": <0xc1>}
    with pytest.raises(ValueError, match="tag 0xc1"):
        ckpt.load_model_any(str(path), device="cpu")


# ---------------------------------------------------------------------------
# Reference .pth -> port
# ---------------------------------------------------------------------------

def reference_class(name):
    """A subclass of the port's model ``name`` under the reference's class
    identity, e.g. ``UNetFamily.UNet.UNet``."""
    module, cls_name = name.split(".")
    return type(cls_name, (MODEL_REGISTRY[name],),
                {"__module__": f"UNetFamily.{module}",
                 "__qualname__": cls_name})


def save_whole_module(model, path):
    """``torch.save(model)`` with its class registered in ``sys.modules``
    under its module's name for the pickling only (a reference user's
    process has it; the loading process has not)."""
    cls = type(model)
    names = ["UNetFamily", cls.__module__]
    saved = {n: sys.modules.get(n) for n in names}
    sys.modules["UNetFamily"] = types.ModuleType("UNetFamily")
    mod = types.ModuleType(cls.__module__)
    setattr(mod, cls.__name__, cls)
    sys.modules[cls.__module__] = mod
    try:
        torch.save(model, str(path))
    finally:
        for n, m in saved.items():
            if m is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = m


def reference_model(name, seed=0, **kwargs):
    """The port's model ``name`` under the reference's class identity,
    with seeded weights and random BatchNorm running statistics."""
    torch.manual_seed(seed)
    model = reference_class(name)(**kwargs)
    g = torch.Generator().manual_seed(seed + 1)
    for key, buf in model.named_buffers():
        if key.endswith(("running_mean", "running_var")):
            buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
    return model.eval()


# FRUNet: its dead reference keys (a top-level ``fuse`` head, and a
# ``fuse`` in a grid block with in_c == out_c) added to the pickled module.
def _add_dead_fuse(model):
    model.fuse = torch.nn.Conv2d(2, 1, 1)
    model.block1_2.fuse = torch.nn.Sequential(torch.nn.Conv2d(4, 4, 3))
    return model


PTH_CASES = {
    "UNet.UNet": ({}, None),
    "BCDUNet.BCDU_net_D1": ({"N": 32}, None),
    "FRUNet.FRUNet": ({}, _add_dead_fuse),
}


@pytest.mark.parametrize("name", sorted(PTH_CASES))
def test_whole_module_pth_loads_strict_with_identical_tensors(tmp_path, name):
    kwargs, edit = PTH_CASES[name]
    model = reference_model(name, **kwargs)
    want = {k: v.clone() for k, v in model.state_dict().items()}
    if edit is not None:
        edit(model)
        dead = sorted(set(model.state_dict()) - set(want))
        assert dead and all("fuse" in k for k in dead)
    path = tmp_path / "best_model.pth"
    save_whole_module(model, path)
    assert "UNetFamily" not in sys.modules
    assert torch_import.detect_pth_model_name(str(path)) == name
    got_model, config = ckpt.load_model_any(str(path), device="cpu",
                                            patch_size=32)
    assert config == {"model_name": name, "model_kwargs": kwargs}
    assert type(got_model) is MODEL_REGISTRY[name]
    got = got_model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("bundle", [False, True], ids=["bare", "bundle"])
def test_state_dict_pth_loads_strict_with_identical_tensors(tmp_path, bundle):
    want = reference_model("UNet.UNet").state_dict()
    path = str(tmp_path / "sd.pth")
    torch.save({"model_state_dict": want, "epoch": 3} if bundle else want,
               path)
    sd = torch_import.load_pth_state_dict(path)
    assert sorted(sd) == sorted(want)
    assert torch_import.detect_pth_model_name(path) is None
    model, config = ckpt.load_model_any(path, device="cpu")
    assert config == {"model_name": "UNet.UNet", "model_kwargs": {}}
    got = model.state_dict()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_an_unexpected_key_raises_and_names_it(tmp_path):
    model = reference_model("UNet.UNet")
    model.head_extra = torch.nn.Linear(2, 2)
    path = tmp_path / "extra.pth"
    save_whole_module(model, path)
    with pytest.raises(ValueError, match=r"unexpected keys \['head_extra"
                                         r"\.bias', 'head_extra\.weight'\]"):
        ckpt.load_model_any(str(path), device="cpu")


def test_transfuse_pth_matches_the_jax_packages_reader(tmp_path, fixture):
    """The port's and the JAX package's load_model_any on the same
    whole-module .pth give the same forward."""
    port, _ = ckpt.load_model_any(str(JAX_FIXTURE), device="cpu")
    ref = reference_class(FIXTURE_MODEL)()  # the reference has no logit head
    ref.load_state_dict(port.state_dict(), strict=True)
    path = tmp_path / "transfuse.pth"
    save_whole_module(ref.eval(), path)
    x = fixture_input()
    jmodel, jvars, jconfig = jax_load_any(str(path), patch_size=64)
    assert jconfig["model_name"] == FIXTURE_MODEL
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        jvars, x))
    got_model, config = ckpt.load_model_any(str(path), device="cpu")
    assert config == {"model_name": FIXTURE_MODEL, "model_kwargs": {}}
    with torch.no_grad():
        got = to_nhwc(got_model(to_port(x)))
    assert want.std() > 1e-2
    assert_close_to(got, want, EVAL_TOL)


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["UNet.UNet", "FRUNet.FRUNet",
                                  FIXTURE_MODEL])
def test_export_equals_variables_to_state_dict(tmp_path, name, fixture):
    if name == FIXTURE_MODEL:
        variables = fixture[1]
    else:
        variables = random_variables(name)[1]
    path = str(tmp_path / "export.pth")
    torch_export.export_torch_state_dict(port_model(name, variables), path)
    got = torch.load(path, weights_only=True)
    want = variables_to_state_dict(name, variables)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].device.type == "cpu" and got[k].is_contiguous(), k
        assert got[k].numpy().dtype == v.dtype, k
        # variables_to_state_dict's np.ascontiguousarray makes the 0-d
        # num_batches_tracked 1-d; the port writes the module's shape
        # (torch's load_state_dict takes both)
        assert tuple(got[k].shape) == (
            () if k.endswith("num_batches_tracked") else v.shape), k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_exported_pth_gives_the_jax_forward(tmp_path, fixture):
    jmodel, _, _ = fixture
    port, _ = ckpt.load_model_any(str(JAX_FIXTURE), device="cpu")
    path = str(tmp_path / "export.pth")
    torch_export.export_torch_checkpoint(str(JAX_FIXTURE), path)
    _, variables = variables_from_state_dict(
        FIXTURE_MODEL, jax_load_pth_state_dict(path), {"logit_head": True},
        input_hw=64)
    x = fixture_input()
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        variables, x))
    with torch.no_grad():
        got = to_nhwc(port(to_port(x)))
    assert_close_to(got, want, EVAL_TOL)


def test_pth_to_port_checkpoint_to_pth_is_bit_exact(tmp_path, capsys):
    want = reference_model("UNet.UNet").state_dict()
    src, mid, out = (str(tmp_path / n) for n in ("in.pth", "mid.pt",
                                                  "out.pth"))
    torch.save(want, src)
    torch_import.main(["--pth", src, "--model", "UNet.UNet", "--out", mid])
    torch_export.main(["--ckpt", mid, "--out", out])
    assert capsys.readouterr().out.count("wrote") == 2
    model, config = ckpt.load_model(mid, device="cpu")
    assert config == {"model_name": "UNet.UNet", "model_kwargs": {}}
    got = torch.load(out, weights_only=True)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


if __name__ == "__main__":
    # Rewrite the fixture: python -m tests.test_torch_port_ckpt_interop
    write_jax_fixture()
    print(f"wrote {JAX_FIXTURE} and {JAX_FIXTURE_OUT}")
