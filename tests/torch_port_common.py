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


def check_train(name, jmodel, variables, x, monkeypatch, tol=TRAIN_TOL,
                **kwargs):
    """One train-mode forward: the output (within ``tol``) and every
    updated running statistic against JAX's ``mutable=["batch_stats"]``
    apply, with the JAX BatchNorm's two-pass variance (its one-pass form
    trades f32 precision for a TPU memory pass) and dropout silenced on
    both sides.  ``kwargs``: the port model's, as ``jmodel`` was built."""
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
    assert_close_to(to_nhwc(got), want, tol)
    sd, loaded = port.state_dict(), state_dict_from_jax(name, variables)
    stats = [k for k in new_stats if k.endswith(("running_mean",
                                                 "running_var"))]
    assert stats
    for k in stats:
        assert_close_to(sd[k].numpy(), new_stats[k], STATS_TOL)
        # the update happened: the stats moved from the loaded ones
        assert not np.array_equal(new_stats[k], loaded[k].numpy())


def kernel_calls(port, x, monkeypatch, shapes=None):
    """Eval forward of ``port`` on ``x`` (NHWC numpy) counting the calls of
    the fused conv entry by the body a bf16 call of that shape would
    launch on the card (``conv_plan.plan_conv``).  On the CPU the entry
    runs the plain version; the count is that of the kernel launches the
    same forward makes on a CUDA tensor.  ``shapes``, a dict, receives the
    count of each call's (H, W, Cin, Cout)."""
    from jcfszxc_unet_tpu_torch.ops import blocks
    from jcfszxc_unet_tpu_torch.ops.kernels import conv_plan

    bodies = {}
    real = blocks.conv3x3_affine_relu_kmajor

    def counting(xh, w_km, scale, shift, relu=True):
        b, h, w, cin = xh.shape
        body = conv_plan.plan_conv(b, h, w, cin, w_km.shape[0],
                                   torch.bfloat16, True).body
        bodies[body] = bodies.get(body, 0) + 1
        if shapes is not None:
            key = (h, w, cin, w_km.shape[0])
            shapes[key] = shapes.get(key, 0) + 1
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

REPO_ROOT = Path(__file__).resolve().parents[1]
DATA_DIR = Path(__file__).resolve().parent / "torch_port_data"
JAX_FIXTURE = DATA_DIR / "transfusenet_jax.ckpt"
JAX_FIXTURE_OUT = DATA_DIR / "transfusenet_jax_out.npy"
# The same weights as an Orbax directory written by the JAX package's
# save_orbax (test_torch_port_orbax.write_jax_orbax_fixture rewrites it).
ORBAX_FIXTURE = DATA_DIR / "transfusenet_jax_orbax"
ORBAX_FIXTURE_STEP = 7
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


def drawn_variables(name, seed=0, hw=32, **kwargs):
    """(JAX module, numpy variables) of registry ``name``: the shapes from
    ``jax.eval_shape`` of the init (no init is compiled), the values drawn
    with numpy from ``seed`` in the distribution of torch's default
    initialisation, which the JAX package's initializers copy (kernels
    uniform in +-1/sqrt(fan-in), the fan-in being all axes but the last),
    and biases and BatchNorm parameters and statistics as
    :func:`randomize_bn` draws them (bias 0.1 N(0, 1), gamma and variance
    in [0.5, 1.5), mean 0.2 N(0, 1))."""
    model = jax_create_model(name, **kwargs)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, hw, hw, 3), jnp.float32),
                           train=False))
    rng = np.random.RandomState(seed)

    def draw(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            bound = 1.0 / np.sqrt(np.prod(s.shape[:-1]))
            v = rng.uniform(-bound, bound, s.shape)
        elif leaf in ("scale", "var"):
            v = 0.5 + rng.rand(*s.shape)
        elif leaf == "mean":
            v = 0.2 * rng.randn(*s.shape)
        else:
            v = 0.1 * rng.randn(*s.shape)
        return v.astype(s.dtype)

    return model, jax.tree_util.tree_map_with_path(draw, shapes)


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


# ---------------------------------------------------------------------------
# Export (tests/test_torch_port_export.py, tests/test_torch_port_ops_library.py):
# kernel-1 operator nodes of each model's exported forward.
# ---------------------------------------------------------------------------

# The loaded or exported program against the eager forward: the same ops
# on the same inputs (0.0 was seen on every model).
EXPORT_TOL = 1e-6


def kernel_nodes(program):
    """The ``jcfszxc_unet.conv3x3_affine_relu`` nodes of an exported
    program's graph."""
    from jcfszxc_unet_tpu_torch.ops.kernels import library

    return [n for n in program.graph.nodes
            if n.target is library.ops.conv3x3_affine_relu.default]


def check_export_graph(name, monkeypatch, s2d=False, seed=0):
    """``eval.export.export_program`` of the port's model ``name`` (seeded
    torch init, its logit head where it has one, BCDU's N = 32; f32, batch
    2 of 32^2, on the CPU): one kernel-1 operator node per kernel call of
    the eager forward (:func:`kernel_calls`), the model's count, and the
    program's output within EXPORT_TOL of the eager sigmoid forward.
    Returns the program."""
    from jcfszxc_unet_tpu_torch.eval.export import export_program
    from jcfszxc_unet_tpu_torch.eval.predictor import sigmoid_forward
    from jcfszxc_unet_tpu_torch.models import model_takes
    from jcfszxc_unet_tpu_torch.ops.layers import reset_parameters

    kwargs = {"s2d": True} if s2d else {}
    if model_takes(name, "logit_head"):
        kwargs["logit_head"] = True
    if model_takes(name, "N"):
        kwargs["N"] = 32
    model = create_model(name, **kwargs)
    reset_parameters(model, torch.Generator().manual_seed(seed))
    x = np.random.RandomState(seed).rand(2, 32, 32, 3).astype(np.float32)
    program = export_program(model, 2, 32, compute_dtype=torch.float32,
                             device="cpu")
    calls = sum(kernel_calls(model, x, monkeypatch).values())
    assert len(kernel_nodes(program)) == calls
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        got = program.module()(xt)
        want = sigmoid_forward(model, xt, torch.float32)
    assert got.shape == (2, 32, 32, 1) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= EXPORT_TOL
    return program


# ---------------------------------------------------------------------------
# The row-sharded whole-image forward against JAX
# (tests/test_torch_port_spatial_models.py, tests/test_torch_port_spatial_zoo.py).
# ---------------------------------------------------------------------------

# Against JAX: as JAX's own check of its sharded forward
# (tests/test_parallel.py ``_check_spatial``).  Against the port's own
# forward in one process on the identically padded image: the same ops on
# other slab heights, which differ in summation order alone (at most
# 3.0e-7 seen, DenseUNet).
SPATIAL_TOL, SHARDED_TOL = 1e-5, 1e-6


def _jax_spatial_reference(jmodel, variables, images, divisor, ranks, how):
    """JAX ``make_spatial_forward`` on ``make_mesh(ranks)`` ("mesh"), or
    the one-device apply of the image padded as it pads ("apply")."""
    from jcfszxc_unet_tpu.parallel.mesh import make_mesh
    from jcfszxc_unet_tpu.parallel.spatial import (
        make_spatial_forward,
        pad_to_multiple,
    )

    if how == "mesh":
        fwd = make_spatial_forward(
            jmodel, jax.tree.map(jnp.asarray, variables), make_mesh(ranks),
            divisor=divisor)
        return np.asarray(fwd(jnp.asarray(images)))
    _, h, w, _ = images.shape
    x, _ = pad_to_multiple(jnp.asarray(images), 1, ranks * divisor)
    x, _ = pad_to_multiple(x, 2, divisor)
    out = jax_apply(jmodel, variables, x, train=False)
    return np.asarray(jax.nn.sigmoid(out.astype(jnp.float32)))[:, :h, :w, 0]


def run_spatial_cases(cases, root, seed):
    """JAX's maps and the port's row-sharded maps of ``cases``: id ->
    (registry name, model kwargs, image shape (N, H, W), divisor, ranks,
    "mesh" or "apply").  Weights from :func:`drawn_variables`, carried
    across by ``state_dict_from_jax``; the port's cases of each world size
    run as one ``parallel.jobs.run`` in spawned gloo ranks on the CPU
    (``spatial_maps``).  Each case's weights go to the ranks as an
    ``.npz`` under ``root`` (the zoo holds 340 M parameters, too many to
    pickle into every rank's arguments), removed after the jobs.  Returns
    (want, single, got): id -> JAX maps, id -> the port's maps in this
    process (no world) of the image padded as the ranks pad it, id -> the
    ranks' results."""
    from jcfszxc_unet_tpu_torch.parallel import jobs, spawn

    want, single, tasks = {}, {}, {}
    for k, (cid, (name, kwargs, shape, divisor, ranks, how)) in enumerate(
            cases.items()):
        jmodel, variables = drawn_variables(name, seed=seed + k, **kwargs)
        images = np.random.RandomState(seed + k).rand(*shape, 3).astype(
            np.float32)
        want[cid] = _jax_spatial_reference(jmodel, variables, images,
                                           divisor, ranks, how)
        path = root / f"{cid}.npz"
        np.savez(path, **{key: v.numpy() for key, v in
                          state_dict_from_jax(name, variables).items()})
        task = dict(model_name=name, images=images, divisor=divisor,
                    state_dict=str(path), model_kwargs=kwargs)
        tasks.setdefault(ranks, []).append((cid, ("spatial_maps", task)))
        h = shape[1]
        padded = np.pad(images, ((0, 0), (0, -h % (ranks * divisor)),
                                 (0, 0), (0, 0)))
        single[cid] = jobs.spatial_maps(
            None, **dict(task, images=padded), device="cpu")["maps"][:, :h]
    got = {}
    try:
        for ranks, named in tasks.items():
            per_rank = spawn(jobs.run, ranks, [t for _, t in named],
                             device="cpu", join_timeout_s=600)
            for i, (cid, _) in enumerate(named):
                got[cid] = [r[i] for r in per_rank]
    finally:
        for path in root.glob("*.npz"):
            path.unlink()
    return want, single, got


def check_spatial_case(runs, cases, case):
    """Every rank holds the same maps, bit for bit; rank 0's are within
    SPATIAL_TOL of JAX's and within SHARDED_TOL of the port's in one
    process; the forward exchanged rows (halos and the output gather)
    and, on the CPU, launched no kernel."""
    want, single, got = runs
    _, _, (n, h, w), _, ranks, _ = cases[case]
    maps = [r["maps"] for r in got[case]]
    assert want[case].shape == (n, h, w) and maps[0].shape == (n, h, w)
    assert len(maps) == ranks
    for m in maps[1:]:
        np.testing.assert_array_equal(m, maps[0])
    np.testing.assert_allclose(maps[0], want[case], rtol=SPATIAL_TOL,
                               atol=SPATIAL_TOL)
    np.testing.assert_allclose(maps[0], single[case], rtol=0,
                               atol=SHARDED_TOL)
    assert got[case][0]["collectives"]["calls"] > 1
    assert got[case][0]["launches"]["conv3x3_affine_relu"] == 0
