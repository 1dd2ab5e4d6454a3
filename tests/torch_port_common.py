"""Shared set-up of the PyTorch-port tests: a JAX UNet with random weights
and random BatchNorm statistics, drawn with numpy from a seed, and its
weights carried into the port."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from jcfszxc_unet_tpu.models import create_model as jax_create_model
from jcfszxc_unet_tpu_torch.compat.from_jax import state_dict_from_jax
from jcfszxc_unet_tpu_torch.models import create_model

# The tests run in several xdist workers at once (six in ROADMAP.md's
# tier-1 command).  torch's default of one intra-op thread per core in each
# worker oversubscribes the cores, and its OpenMP threads spin while they
# wait: on an 8-core host the zoo files took 296 s under six workers with
# the default and 59 s with one thread each.  Every worker collects this
# module, so the setting holds for the whole run.
torch.set_num_threads(1)


def randomize_bn(variables, seed):
    """Random gamma/beta and running mean/var for every BatchNorm of a JAX
    variables tree (numpy, from ``seed``); returns a new tree of numpy
    arrays."""
    rng = np.random.RandomState(seed)
    tree = jax.tree.map(np.asarray, variables)

    def walk(params, stats):
        for k, v in params.items():
            if k == "bn":
                c = v["scale"].shape[0]
                v["scale"] = (0.5 + rng.rand(c)).astype(np.float32)
                v["bias"] = (0.1 * rng.randn(c)).astype(np.float32)
                stats[k]["mean"] = (0.2 * rng.randn(c)).astype(np.float32)
                stats[k]["var"] = (0.5 + rng.rand(c)).astype(np.float32)
            elif isinstance(v, dict):
                walk(v, stats.get(k, {}))

    walk(tree["params"], tree["batch_stats"])
    return tree


def jax_init(model, seed, hw):
    """``model.init`` on a (1, hw, hw, 3) input as one jitted program: XLA
    compiles the whole init once instead of each op on its own."""
    return jax.jit(lambda key, x: model.init(key, x, train=False))(
        jax.random.PRNGKey(seed), jnp.zeros((1, hw, hw, 3), jnp.float32))


def jax_apply(model, variables, x, **kwargs):
    """``model.apply(variables, x, **kwargs)`` as one jitted program, traced
    at this call (so under the caller's ``dropout_disabled()`` and BN
    flags)."""
    return jax.jit(lambda v, x: model.apply(v, x, **kwargs))(
        variables, jnp.asarray(x))


def jax_unet(seed=0, hw=32):
    """(JAX UNet module, numpy variables) with random BN statistics."""
    model = jax_create_model("UNet.UNet")
    variables = model.init(jax.random.PRNGKey(seed),
                           jnp.zeros((1, hw, hw, 3), jnp.float32), train=False)
    return model, randomize_bn(variables, seed + 1)


def port_unet(variables):
    """The port's UNet, eval mode, channels_last, with ``variables``."""
    model = create_model("UNet.UNet")
    model.load_state_dict(state_dict_from_jax("UNet.UNet", variables),
                          strict=True)
    return model.to(memory_format=torch.channels_last).eval()


# ---------------------------------------------------------------------------
# The zoo: a JAX model and its port on the same weights, held against each
# other in eval and train mode (tests/test_torch_port_zoo_*.py).
# ---------------------------------------------------------------------------

# Eval-mode forwards agree to f32 summation order: atol = rtol = 1e-4 of
# max |JAX output|.
EVAL_TOL = 1e-4
# Train mode normalizes every conv by its batch statistics (BN over as few
# as 2 x 1 x 1 values at 32^2), which amplifies the f32 summation-order
# differences of the conv layers below it; through R2UNet's 58 convs they
# reach ~1e-3 of max |output|.  The updated running statistics agree to
# ~1e-5 relative.
TRAIN_TOL, STATS_TOL = 2e-3, 1e-4


def jax_model(name, seed=0, hw=32, **kwargs):
    """(JAX module of registry ``name``, numpy variables with random BN
    statistics)."""
    model = jax_create_model(name, **kwargs)
    return model, randomize_bn(jax_init(model, seed, hw), seed + 1)


def port_model(name, variables, **kwargs):
    """The port's model ``name`` with ``variables`` (loaded strict), eval
    mode, channels_last."""
    model = create_model(name, **kwargs)
    model.load_state_dict(state_dict_from_jax(name, variables), strict=True)
    return model.to(memory_format=torch.channels_last).eval()


def to_port(x):
    """NHWC numpy -> NCHW channels_last torch view."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def to_nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def assert_close_to(got, want, tol):
    """|got - want| <= tol * max|want| + tol * |want|."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def check_bridge(name, variables):
    """state_dict_from_jax equals the JAX package's variables_to_state_dict
    key for key, dtype for dtype and value for value, and loads strict."""
    from jcfszxc_unet_tpu.compat.torch_mapping import variables_to_state_dict

    got = state_dict_from_jax(name, variables)
    want = variables_to_state_dict(name, variables)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].numpy().dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert sorted(port_model(name, variables).state_dict()) == sorted(want)


def check_eval(jmodel, variables, port, x):
    want = np.asarray(jax_apply(jmodel, variables, x, train=False))
    with torch.no_grad():
        got = port(to_port(x))
    assert got.shape == (x.shape[0], 1, x.shape[1], x.shape[2])
    assert_close_to(to_nhwc(got), want, EVAL_TOL)
    return want


def silence_dropout(port):
    """Put the port's dropout modules in eval mode (the identity) while the
    rest keeps its mode: dropout masks cannot match across frameworks, so
    train parity runs JAX under ``ops.layers.dropout_disabled()`` and the
    port so."""
    for m in port.modules():
        if isinstance(m, (torch.nn.Dropout, torch.nn.Dropout2d)):
            m.eval()
    return port


def check_train(name, jmodel, variables, x, monkeypatch, **kwargs):
    """One train-mode forward: the output and every updated running
    statistic against JAX's ``mutable=["batch_stats"]`` apply, with the
    JAX BatchNorm's two-pass variance (its one-pass form trades f32
    precision for a TPU memory pass) and dropout silenced on both
    sides.  ``kwargs``: the port model's, as ``jmodel`` was built."""
    from jcfszxc_unet_tpu.compat.torch_mapping import variables_to_state_dict
    from jcfszxc_unet_tpu.ops import layers as jax_layers

    monkeypatch.setattr(jax_layers, "TRAIN_BN_ONE_PASS_STATS", False)
    with jax_layers.dropout_disabled():
        want, upd = jax_apply(jmodel, variables, x, train=True,
                              mutable=["batch_stats"])
    new_stats = variables_to_state_dict(name, {
        "params": variables["params"],
        "batch_stats": jax.tree.map(np.asarray, upd["batch_stats"])})
    port = silence_dropout(port_model(name, variables, **kwargs).train())
    with torch.no_grad():
        got = port(to_port(x))
    assert_close_to(to_nhwc(got), want, TRAIN_TOL)
    sd, loaded = port.state_dict(), state_dict_from_jax(name, variables)
    stats = [k for k in new_stats if k.endswith(("running_mean",
                                                 "running_var"))]
    assert stats
    for k in stats:
        assert_close_to(sd[k].numpy(), new_stats[k], STATS_TOL)
        # the update happened: the stats moved from the loaded ones
        assert not np.array_equal(new_stats[k], loaded[k].numpy())


def kernel_calls(port, x, monkeypatch):
    """Eval forward of ``port`` on ``x`` (NHWC numpy) counting the calls of
    the fused conv entry by the body a bf16 call of that shape would
    launch on the card (``conv_plan.plan_conv``).  On the CPU the entry
    runs the plain version; the count is that of the kernel launches the
    same forward makes on a CUDA tensor."""
    from jcfszxc_unet_tpu_torch.ops import blocks
    from jcfszxc_unet_tpu_torch.ops.kernels import conv_plan

    bodies = {}
    real = blocks.conv3x3_affine_relu_kmajor

    def counting(xh, w_km, scale, shift, relu=True):
        b, h, w, cin = xh.shape
        body = conv_plan.plan_conv(b, h, w, cin, w_km.shape[0],
                                   torch.bfloat16, True).body
        bodies[body] = bodies.get(body, 0) + 1
        return real(xh, w_km, scale, shift, relu)

    monkeypatch.setattr(blocks, "conv3x3_affine_relu_kmajor", counting)
    with torch.no_grad():
        port.eval()(to_port(x))
    return bodies


# ---------------------------------------------------------------------------
# The port's train CLI on a zoo model (tests/test_torch_port_zoo_train.py
# and the attention family's files).
# ---------------------------------------------------------------------------

def synthetic_train_h5(root):
    """The synthetic DRIVE split under ``root``, preprocessed to the h5 file
    that the train CLI reads; returns its path."""
    from jcfszxc_unet_tpu.data.preprocess import preprocess_dataset

    from .test_e2e import make_synthetic_drive

    make_synthetic_drive(str(root / "raw"))
    info = preprocess_dataset(dataset_path=str(root / "raw"),
                              output_dir=str(root / "data"),
                              save_method="h5", include_test=False)
    return info["train"]["output_file"]


def check_train_cli(name, train_h5, tmp_path, monkeypatch):
    """Two steps of one epoch of the port's train CLI on model ``name``
    (CPU, f32, patch 32): no conv-kernel launch, one finite metrics
    record, and the best checkpoint reloads with ``strict=True`` under
    the registry name."""
    import json

    from jcfszxc_unet_tpu_torch.cli import train as port_cli
    from jcfszxc_unet_tpu_torch.ops.kernels import conv_fused
    from jcfszxc_unet_tpu_torch.train.checkpoint import load_model

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


# ---------------------------------------------------------------------------
# The JAX .ckpt fixture (tests/torch_port_data/): a TransFuseNet written by
# the JAX package's save_model, and the JAX output on fixture_input().
# test_torch_port_ckpt_interop.write_jax_fixture rewrites both.
# ---------------------------------------------------------------------------

DATA_DIR = Path(__file__).resolve().parent / "torch_port_data"
JAX_FIXTURE = DATA_DIR / "transfusenet_jax.ckpt"
JAX_FIXTURE_OUT = DATA_DIR / "transfusenet_jax_out.npy"
FIXTURE_MODEL = "RetinaLiteNet.TransFuseNet"


def fixture_input():
    return np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)


def jax_fixture():
    """(JAX module, numpy variables, config) of the fixture, read by the
    JAX package (flax)."""
    from jcfszxc_unet_tpu.train.checkpoint import load_model as jax_load

    model, variables, config = jax_load(str(JAX_FIXTURE))
    return model, jax.tree.map(np.asarray, variables), config


def random_variables(name, seed=0, hw=32, **kwargs):
    """(JAX module, numpy variables) of registry ``name`` with the init's
    shapes and dtypes and values drawn with numpy: no init is compiled or
    run (for tests that compare trees, not forwards)."""
    model = jax_create_model(name, **kwargs)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, hw, hw, 3), jnp.float32),
                           train=False))
    rng = np.random.RandomState(seed)
    return model, jax.tree.map(
        lambda s: (0.5 + rng.rand(*s.shape)).astype(s.dtype), shapes)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def assert_same_tree(got, want):
    """Same keys, and each leaf of the same dtype, shape and bytes."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, np.ndarray | np.generic):
            w = np.asarray(w)
            if w.dtype.name == "bfloat16":
                assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
                assert g.view(torch.int16).numpy().tobytes() == w.tobytes(), k
                continue
            g = np.asarray(g)
            assert (g.dtype, g.shape) == (w.dtype, w.shape), k
            assert g.tobytes() == w.tobytes(), k
        else:
            assert type(g) is type(w) and g == w, k
