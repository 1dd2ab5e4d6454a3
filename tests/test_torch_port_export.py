"""Model export of the PyTorch port (``jcfszxc_unet_tpu_torch/eval/export.py``)
against the JAX package's ``eval/export.py``: the port's artifact
(``torch.export``) and JAX's (``jax.export``) of the same weights give the
same probabilities (f32, batch 2 of 32^2, within the zoo checks'
tolerance, 1e-4 of max |output|) for UNet, SegNet, TransFuseNet (the model
of the JAX package's own export tests) and FRUNet in s2d mode;
``export_checkpoint`` from the JAX ``.ckpt`` fixture, a port checkpoint
and a state-dict ``.pth``; a process that holds only torch and the port
loads an artifact; an export leaves the s2d selector's cache real; and the
kernel-1 operator nodes of the three s2d modes
(``tests/test_torch_port_ops_library.py`` has the 16 plain ones, and the
``cuda`` test of the exported UNet on the card).  On the CPU the operators
run their plain versions."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jcfszxc_unet_tpu.eval.export import export_forward as jax_export_forward
from jcfszxc_unet_tpu.eval.export import load_exported as jax_load_exported
from jcfszxc_unet_tpu_torch.compat import torch_export
from jcfszxc_unet_tpu_torch.eval.export import (
    export_checkpoint,
    export_forward,
    export_program,
    load_exported,
)
from jcfszxc_unet_tpu_torch.eval.predictor import Predictor, sigmoid_forward
from jcfszxc_unet_tpu_torch.models import create_model
from jcfszxc_unet_tpu_torch.ops import s2d
from jcfszxc_unet_tpu_torch.ops.kernels import conv_fused
from jcfszxc_unet_tpu_torch.ops.layers import reset_parameters
from jcfszxc_unet_tpu_torch.train import checkpoint as ckpt

from .torch_port_common import (
    EVAL_TOL,
    EXPORT_TOL,
    FIXTURE_MODEL,
    JAX_FIXTURE,
    JAX_FIXTURE_OUT,
    REPO_ROOT,
    assert_close_to,
    check_export_graph,
    fixture_input,
    jax_fixture,
    jax_model,
    kernel_nodes,
    port_model,
)


def _sigmoid(a):
    return 1.0 / (1.0 + np.exp(-a))


@pytest.mark.parametrize("name,kwargs", [
    ("UNet.UNet", {}), ("SegNet.SegNet", {}), (FIXTURE_MODEL, {}),
    ("FRUNet.FRUNet", {"s2d": True})], ids=lambda v: str(v))
def test_exported_forward_matches_the_jax_export(name, kwargs):
    """Each framework's export -> load round trip on the same weights
    (TransFuseNet: the JAX fixture's, whose logits vary; the others: the
    init's with random BatchNorm statistics)."""
    if name == FIXTURE_MODEL:
        jmodel, variables, config = jax_fixture()
        kwargs = config["model_kwargs"]
    else:
        jmodel, variables = jax_model(name, seed=31, **kwargs)
    x = np.random.RandomState(32).rand(2, 32, 32, 3).astype(np.float32)
    want = np.asarray(jax_load_exported(jax_export_forward(
        jmodel, variables, batch_size=2, patch_size=32,
        compute_dtype=jnp.float32))(jnp.asarray(x)))
    fn = load_exported(export_forward(
        port_model(name, variables, **kwargs), 2, 32,
        compute_dtype=torch.float32, device="cpu"))
    got = fn(torch.from_numpy(x))
    assert got.shape == (2, 32, 32, 1) and got.dtype == torch.float32
    assert_close_to(got.numpy(), want, EVAL_TOL)
    # the comparison can fail: the map varies by 10x the tolerance
    assert want.std() > 10 * EVAL_TOL * np.abs(want).max()


def test_export_checkpoint_of_the_jax_fixture_gives_the_jax_output(tmp_path):
    """The JAX ``.ckpt`` (TransFuseNet with its recorded logit head) ->
    artifact -> the sigmoid of the JAX package's output on
    fixture_input()."""
    out = export_checkpoint(str(JAX_FIXTURE), str(tmp_path / "t.pt2"),
                            batch_size=2, patch_size=64,
                            compute_dtype=torch.float32, device="cpu")
    with open(out, "rb") as f:
        fn = load_exported(f.read())
    got = fn(torch.from_numpy(fixture_input())).numpy()
    assert_close_to(got, _sigmoid(np.load(str(JAX_FIXTURE_OUT))), EVAL_TOL)


@pytest.mark.parametrize("fmt", ["port", "pth"])
def test_export_checkpoint_of_a_port_file_and_a_pth(tmp_path, fmt):
    """A port checkpoint (config recorded) and a bare state-dict ``.pth``
    (model named by its keys, as ``load_model_any`` names it): each
    artifact reproduces the eager forward of the model the file loads
    to."""
    model, config = ckpt.load_model_any(str(JAX_FIXTURE), device="cpu")
    path = str(tmp_path / f"m.{fmt}")
    if fmt == "port":
        ckpt.save_model(path, config["model_name"], config["model_kwargs"],
                        model)
    else:
        torch_export.export_torch_state_dict(model, path)
    out = export_checkpoint(path, str(tmp_path / "m.pt2"), batch_size=2,
                            patch_size=64, compute_dtype=torch.float32,
                            device="cpu")
    with open(out, "rb") as f:
        fn = load_exported(f.read())
    x = torch.from_numpy(fixture_input())
    want = Predictor.from_checkpoint(path, device="cpu",
                                     compute_dtype=torch.float32,
                                     patch_size=64).predict_patches(x)
    got = fn(x)
    assert float((got - want).abs().max()) <= EXPORT_TOL
    if fmt == "port":  # the logit head came with the config
        assert_close_to(got.numpy(), _sigmoid(np.load(str(JAX_FIXTURE_OUT))),
                        EVAL_TOL)


def test_export_checkpoint_takes_the_recorded_s2d_mode(tmp_path, monkeypatch):
    """A checkpoint that records ``s2d`` exports in that mode: the
    program's convs include the s2d-only 12 -> 128 at 16^2."""
    model = create_model("FRUNet.FRUNet", s2d=True)
    reset_parameters(model, torch.Generator().manual_seed(3))
    path = str(tmp_path / "fr.pt")
    ckpt.save_model(path, "FRUNet.FRUNet", {"s2d": True}, model)
    out = export_checkpoint(path, str(tmp_path / "fr.pt2"), batch_size=1,
                            patch_size=32, compute_dtype=torch.float32,
                            device="cpu")
    with open(out, "rb") as f:
        fn = load_exported(f.read())
    shapes = {(tuple(n.args[0].meta["val"].shape[1:]),
               n.args[1].meta["val"].shape[0])
              for n in kernel_nodes(fn.program)}
    assert ((16, 16, 12), 128) in shapes and len(kernel_nodes(
        fn.program)) == 44


def test_loaded_forward_refuses_another_shape_dtype_or_device():
    model = create_model(FIXTURE_MODEL)
    fn = load_exported(export_forward(model, 2, 16,
                                      compute_dtype=torch.float32,
                                      device="cpu"))
    x = torch.rand(2, 16, 16, 3)
    assert fn(x).shape == (2, 16, 16, 1)
    for bad in (x[:1], x.double(), x.to("meta"), x[..., :1]):
        with pytest.raises(ValueError, match="exported forward takes"):
            fn(bad)


def test_export_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the test is for one without")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export_forward(create_model(FIXTURE_MODEL), 1, 16)


def test_a_process_with_only_torch_and_the_port_loads_an_artifact(tmp_path):
    """Load in a fresh interpreter with jax and the JAX package blocked:
    the same probabilities, bit for bit."""
    jmodel, variables, config = jax_fixture()
    model = port_model(FIXTURE_MODEL, variables, **config["model_kwargs"])
    art = tmp_path / "t.pt2"
    art.write_bytes(export_forward(model, 2, 32, compute_dtype=torch.float32,
                                   device="cpu"))
    x = np.random.RandomState(33).rand(2, 32, 32, 3).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    want = load_exported(art.read_bytes())(torch.from_numpy(x)).numpy()
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'jcfszxc_unet_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "from jcfszxc_unet_tpu_torch.eval.export import load_exported\n"
        f"fn = load_exported(open({str(art)!r}, 'rb').read())\n"
        f"y = fn(torch.from_numpy(np.load({str(tmp_path / 'x.npy')!r})))\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in\n"
        "          ('jax', 'jaxlib', 'flax', 'jcfszxc_unet_tpu')\n"
        "          and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        f"np.save({str(tmp_path / 'y.npy')!r}, y.numpy())\n")
    subprocess.run([sys.executable, "-c", code], cwd=str(REPO_ROOT),
                   check=True, timeout=300,
                   env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO_ROOT),
                        "OMP_NUM_THREADS": "1"})
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"), want)


def test_an_export_leaves_the_s2d_cache_real():
    """Exporting an s2d model traces ``s2d._selector_tensor``; an eager
    forward afterwards in the same process returns real tensors, equal to
    those of a fresh cache, and a second s2d model exports too."""
    x = torch.from_numpy(np.random.RandomState(34).rand(
        1, 32, 32, 3).astype(np.float32))
    for name in ("FRUNet.FRUNet", "UNetPP.NestedUNet"):
        model = create_model(name, s2d=True)
        reset_parameters(model, torch.Generator().manual_seed(4))
        model = model.to(memory_format=torch.channels_last).eval()
        s2d._selector_tensor.cache_clear()
        program = export_program(model, 1, 32, compute_dtype=torch.float32,
                                 device="cpu")
        with torch.inference_mode():
            after = sigmoid_forward(model, x, torch.float32).numpy()
            s2d._selector_tensor.cache_clear()
            fresh = sigmoid_forward(model, x, torch.float32).numpy()
            traced = program.module()(x).numpy()
        np.testing.assert_array_equal(after, fresh)
        np.testing.assert_array_equal(traced, fresh)


@pytest.mark.parametrize("name", ["FRUNet.FRUNet",
                                  "MultiResUNet.MultiResUNet",
                                  "UNetPP.NestedUNet"])
def test_s2d_exported_graph_holds_one_operator_node_per_kernel_call(
        name, monkeypatch):
    """The plain mode's counts (an s2d 3x3 is a 3x3 on 4x the channels)."""
    program = check_export_graph(name, monkeypatch, s2d=True)
    assert len(kernel_nodes(program)) == {
        "FRUNet.FRUNet": 44, "MultiResUNet.MultiResUNet": 37,
        "UNetPP.NestedUNet": 30}[name]

