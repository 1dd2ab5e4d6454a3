"""Orbax directory checkpoints in the PyTorch port (``train/checkpoint.py``
``save_orbax``/``restore_orbax`` over ``compat/orbax.py``,
``compat/zarr.py``, ``compat/ocdbt.py`` and ``compat/zstd.py``) against the
JAX package's ``save_orbax``/``restore_orbax`` (Orbax, tensorstore).

tensorstore and zstandard are oracles here only: the port reads the OCDBT
store, the zarr arrays and the zstd frames with its own code.  Trees cross
both ways and are compared leaf for leaf, dtypes exact and bytes equal.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from jcfszxc_unet_tpu.train.checkpoint import restore_orbax as jax_restore
from jcfszxc_unet_tpu.train.checkpoint import save_orbax as jax_save
from jcfszxc_unet_tpu_torch.compat import zstd
from jcfszxc_unet_tpu_torch.compat.from_jax import state_dict_from_jax
from jcfszxc_unet_tpu_torch.compat.ocdbt import OcdbtError, OcdbtStore
from jcfszxc_unet_tpu_torch.compat.torch_import import model_from_state_dict
from jcfszxc_unet_tpu_torch.compat.zarr import DirectoryStore, read_array
from jcfszxc_unet_tpu_torch.train import checkpoint as ckpt

from .torch_port_common import (
    EVAL_TOL,
    FIXTURE_MODEL,
    JAX_FIXTURE_OUT,
    ORBAX_FIXTURE,
    ORBAX_FIXTURE_STEP,
    assert_close_to,
    fixture_input,
    jax_apply,
    jax_fixture,
    port_model,
    random_variables,
    to_nhwc,
    to_port,
)

ts = pytest.importorskip("tensorstore")
zstandard = pytest.importorskip("zstandard")

# The fixture's f32 forward against the JAX output written beside it: the
# tolerance of the .ckpt path's (test_torch_port_ckpt_interop).
FIXTURE_TOL = 1e-5


def write_jax_orbax_fixture(path=ORBAX_FIXTURE):
    """Write the Orbax fixture: the JAX package's ``save_orbax`` of the
    ``.ckpt`` fixture's ``params`` and ``batch_stats`` (read by the JAX
    package) and ``"step": np.int32(ORBAX_FIXTURE_STEP)``: OCDBT with zstd,
    ~0.2 MB."""
    _, variables, _ = jax_fixture()
    jax_save(str(path), {"params": variables["params"],
                         "batch_stats": variables["batch_stats"],
                         "step": np.int32(ORBAX_FIXTURE_STEP)})


# ---------------------------------------------------------------------------
# Leaf-for-leaf comparison of a port tree with a JAX tree
# ---------------------------------------------------------------------------

def _flat(tree, prefix=""):
    """path -> leaf; dict keys, named-tuple fields and sequence indices
    name the levels; None and empty named tuples are the leaf None (Orbax
    writes both as a None leaf)."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        tree = tree._asdict() or None
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
        return out
    return {prefix: tree}


def _as_numpy(leaf):
    """A torch or JAX array leaf as numpy (bf16 as its int16 bits)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16", leaf.view(torch.int16).numpy()
        return str(leaf.numpy().dtype), leaf.numpy()
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        return "bfloat16", a.view(np.int16)
    return str(a.dtype), a


def assert_same_leaves(got, want):
    """The same paths; array leaves of the same dtype, shape and bytes,
    scalar leaves of the same Python type and value, None where None."""
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if w is None or isinstance(w, (bool, int, float)):
            assert type(g) is type(w) and g == w, (k, g, w)
            continue
        (gd, ga), (wd, wa) = _as_numpy(g), _as_numpy(w)
        assert (gd, ga.shape) == (wd, wa.shape), k
        assert ga.tobytes() == wa.tobytes(), k


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------

def _params():
    rng = np.random.RandomState(0)
    return {"conv": {"kernel": rng.randn(3, 3, 4, 8).astype(np.float32),
                     "bias": rng.randn(8).astype(np.float32)},
            "dense": {"kernel": rng.randn(8, 2).astype(np.float32)}}


def tree_dicts_and_lists():
    rng = np.random.RandomState(1)
    return {"params": {"w": rng.randn(3, 4).astype(np.float32),
                       "a.b": rng.randn(2).astype(np.float32)},
            "lists": [np.arange(5, dtype=np.int32),
                      [rng.randn(2, 2).astype(np.float32), None],
                      None],
            "nested": {"deep": {"x": rng.randn(7).astype(np.float32)}}}


def tree_optax_state():
    """An optax chain(clip_by_global_norm, rmsprop) state: ``None`` leaves
    (EmptyState) and ``jax.Array`` leaves, beside numpy params."""
    params = _params()
    opt = optax.chain(optax.clip_by_global_norm(1.0), optax.rmsprop(1e-3))
    state = opt.init(jax.tree.map(jnp.asarray, params))
    state = jax.tree.map(lambda a: a + 0.5, state)  # not all zeros
    return {"params": params, "opt_state": state}


def tree_bf16_and_scalars():
    rng = np.random.RandomState(2)
    return {"w": jnp.asarray(rng.randn(4, 3), jnp.bfloat16),
            "step": np.int32(7), "lr": 1.5, "count": 3, "flag": True,
            "scale": np.float32(2.0)}


def tree_sharded():
    """``jax.Array`` leaves sharded over 4 of the 8 CPU devices: chunk
    grids of 4 x 1 and 1 x 4."""
    mesh = Mesh(np.array(jax.devices()[:4]), ("d",))
    rows = jax.device_put(jnp.arange(64 * 3, dtype=jnp.float32).reshape(64, 3),
                          NamedSharding(mesh, P("d", None)))
    cols = jax.device_put(jnp.arange(6 * 16, dtype=jnp.int32).reshape(6, 16),
                          NamedSharding(mesh, P(None, "d")))
    return {"rows": rows, "cols": cols}


def tree_dtypes():
    """The zarr dtypes beyond f4, bf16 and i4."""
    rng = np.random.RandomState(3)
    return {"f8": rng.randn(3).astype(np.float64),
            "f2": rng.randn(5).astype(np.float16),
            "i8": np.array([-(2 ** 40), 3], np.int64),
            "u1": np.array([0, 7, 255], np.uint8),
            "b1": np.array([True, False, True])}


TREES = {"dicts_and_lists": tree_dicts_and_lists,
         "optax_state": tree_optax_state,
         "bf16_and_scalars": tree_bf16_and_scalars,
         "sharded": tree_sharded,
         "dtypes": tree_dtypes}


def port_template(tree):
    """The JAX tree with each ``jax.Array`` leaf as a CPU tensor of its
    dtype (numpy arrays, scalars, None and containers kept)."""
    def leaf(a):
        if isinstance(a, jax.Array):
            return torch.zeros(a.shape, dtype=getattr(torch, str(a.dtype)))
        return a
    return jax.tree.map(leaf, tree)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """name -> (JAX tree, its JAX save_orbax directory)."""
    root = tmp_path_factory.mktemp("jax_orbax")
    out = {}
    for name, make in TREES.items():
        tree = make()
        path = str(root / name)
        jax_save(path, tree)
        out[name] = (tree, path)
    return out


# ---------------------------------------------------------------------------
# JAX save_orbax -> port restore_orbax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TREES))
def test_port_restores_a_jax_directory_leaf_for_leaf(saved, name):
    _, path = saved[name]
    got = ckpt.restore_orbax(path, device="cpu")
    assert_same_leaves(got, jax_restore(path))
    for leaf in _flat(got).values():  # the port's types, on the CPU
        assert leaf is None or isinstance(leaf, (bool, int, float)) or (
            isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu")


@pytest.mark.parametrize("name", sorted(TREES))
def test_port_restores_a_jax_directory_with_a_template(saved, name):
    tree, path = saved[name]
    template = port_template(tree)
    got = ckpt.restore_orbax(path, template=template, device="cpu")
    assert_same_leaves(got, jax_restore(path, template=tree))
    flat_got, flat_tmpl = _flat(got), _flat(template)
    for k, t in flat_tmpl.items():  # each leaf takes the template's type
        g = flat_got[k]
        if isinstance(t, torch.Tensor):
            assert isinstance(g, torch.Tensor) and g.dtype == t.dtype, k
        elif isinstance(t, np.ndarray):
            assert isinstance(g, np.ndarray), k
        elif t is not None:
            assert isinstance(g, (bool, int, float)), k
    if name == "optax_state":  # the template's named tuples come back
        assert type(got["opt_state"][1][0]) is type(tree["opt_state"][1][0])


# ---------------------------------------------------------------------------
# Port save_orbax -> JAX restore_orbax, and port -> port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(TREES))
def test_jax_restores_a_port_directory_leaf_for_leaf(saved, name, tmp_path):
    _, path = saved[name]
    tree = ckpt.restore_orbax(path, device="cpu")
    out = str(tmp_path / "port")
    ckpt.save_orbax(out, tree)
    assert_same_leaves(tree, jax_restore(out))
    with open(os.path.join(out, "_METADATA")) as f:
        assert json.load(f)["use_ocdbt"] is False  # the plain layout


@pytest.mark.parametrize("name", sorted(TREES))
def test_port_restores_its_own_directory(saved, name, tmp_path):
    _, path = saved[name]
    tree = ckpt.restore_orbax(path, device="cpu")
    out = str(tmp_path / "port")
    ckpt.save_orbax(out, tree)
    assert_same_leaves(ckpt.restore_orbax(out, device="cpu"), tree)


def test_port_writes_the_names_orbax_writes(saved, tmp_path):
    """A dict key holding a '.' joins into the name as Orbax joins it,
    and the tree comes from _METADATA, not from the names."""
    _, path = saved["dicts_and_lists"]
    jax_names = {k.rsplit("/", 1)[0] for k in OcdbtStore(path).list()}
    out = str(tmp_path / "port")
    ckpt.save_orbax(out, ckpt.restore_orbax(path, device="cpu"))
    port_names = {d for d in os.listdir(out) if not d.startswith("_")}
    assert port_names == jax_names
    assert "params.a.b" in port_names


def test_save_takes_tensors_numpy_scalars_and_none(tmp_path):
    tree = {"t": torch.arange(6, dtype=torch.float32).reshape(2, 3)
            .t(),  # not contiguous
            "grad": torch.ones(2, requires_grad=True),
            "n": np.arange(3, dtype=np.int64), "bf": torch.ones(
                2, dtype=torch.bfloat16),
            "i": 3, "f": 0.25, "b": False, "ni": np.int32(4), "none": None,
            "tup": (np.float32(1.0), [1, 2])}
    out = str(tmp_path / "tree")
    ckpt.save_orbax(out, tree)
    got = ckpt.restore_orbax(out, device="cpu")
    assert torch.equal(got["t"], tree["t"]) and got["t"].is_contiguous()
    assert got["tup"] == [1.0, [1, 2]] and got["none"] is None
    assert (got["i"], got["f"], got["b"], got["ni"]) == (3, 0.25, False, 4)
    assert_same_leaves(got, jax_restore(out))


def test_save_refuses_what_orbax_refuses(tmp_path):
    with pytest.raises(ValueError, match="zero size"):
        ckpt.save_orbax(str(tmp_path / "a"), {"x": torch.zeros(0, 3)})
    with pytest.raises(TypeError, match="cannot save a str"):
        ckpt.save_orbax(str(tmp_path / "b"), {"x": "text"})
    with pytest.raises(ValueError, match="single leaf"):
        ckpt.save_orbax(str(tmp_path / "c"), torch.ones(2))
    assert os.listdir(tmp_path) == []  # no directory, no temporary left


def test_save_replaces_an_existing_directory(tmp_path):
    out = str(tmp_path / "ckpt")
    ckpt.save_orbax(out, {"a": torch.ones(3), "b": 1})
    ckpt.save_orbax(out, {"c": torch.zeros(2)})
    assert sorted(os.listdir(tmp_path)) == ["ckpt"]
    got = ckpt.restore_orbax(out, device="cpu")
    assert list(got) == ["c"] and torch.equal(got["c"], torch.zeros(2))
    assert_same_leaves(got, jax_restore(out))


# ---------------------------------------------------------------------------
# Templates and devices
# ---------------------------------------------------------------------------

def test_a_template_sets_dtype_device_and_types(tmp_path):
    out = str(tmp_path / "ckpt")
    ckpt.save_orbax(out, {"w": torch.arange(4, dtype=torch.float32),
                          "h": torch.ones(2, dtype=torch.bfloat16),
                          "step": np.int64(5), "opt": [None, {"m": 0.5}]})
    template = {"w": torch.zeros(4, dtype=torch.float64),
                "h": np.zeros(2, np.float32), "step": 0,
                "opt": (None, {"m": 0.0})}
    got = ckpt.restore_orbax(out, template=template, device="cpu")
    assert got["w"].dtype == torch.float64 and got["w"].device.type == "cpu"
    assert torch.equal(got["w"], torch.arange(4, dtype=torch.float64))
    assert isinstance(got["h"], np.ndarray) and got["h"].dtype == np.float32
    assert got["step"] == 5 and type(got["step"]) is int
    assert got["opt"] == (None, {"m": 0.5})


def test_a_template_that_does_not_fit_raises(tmp_path):
    out = str(tmp_path / "ckpt")
    ckpt.save_orbax(out, {"w": torch.ones(4), "b": torch.ones(2)})
    with pytest.raises(ValueError, match="keys"):
        ckpt.restore_orbax(out, template={"w": torch.ones(4)}, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_orbax(out, template={"w": torch.ones(5),
                                          "b": torch.ones(2)}, device="cpu")


def test_restore_defaults_to_the_card(tmp_path):
    out = str(tmp_path / "ckpt")
    ckpt.save_orbax(out, {"w": torch.ones(2)})
    if torch.cuda.is_available():
        assert ckpt.restore_orbax(out)["w"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ckpt.restore_orbax(out)


# ---------------------------------------------------------------------------
# OCDBT against tensorstore
# ---------------------------------------------------------------------------

def _tensorstore_items(path):
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{os.path.abspath(path)}/"}).result()
    return {k.decode(): kv.read(k).result().value for k in kv.list().result()}


def _multilevel_store(path):
    """An OCDBT tree of height 2 with inline and indirect values, written
    by tensorstore with small nodes."""
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{os.path.abspath(path)}/",
                          "config": {"max_decoded_node_bytes": 400,
                                     "max_inline_value_bytes": 20}}).result()
    rng = np.random.RandomState(0)
    txn = ts.Transaction()
    for i in range(60):
        kv.with_transaction(txn)[f"key{i:03d}/sub"] = rng.bytes(
            rng.randint(1, 50))
    txn.commit_async().result()
    kv["later"] = b"x" * 40  # a second version


@pytest.mark.parametrize("which", ["fixture", "sharded", "optax_state",
                                   "multilevel"])
def test_ocdbt_matches_tensorstore(saved, which, tmp_path):
    if which == "fixture":
        path = str(ORBAX_FIXTURE)
    elif which == "multilevel":
        path = str(tmp_path / "ml")
        _multilevel_store(path)
    else:
        path = saved[which][1]
    want = _tensorstore_items(path)
    store = OcdbtStore(path)
    assert store.list() == sorted(want)
    if which == "sharded":  # one chunk a shard: 4 x 1 and 1 x 4 grids
        assert {f"rows/{i}.0" for i in range(4)} | {
            f"cols/0.{i}" for i in range(4)} <= set(want)
    for k, v in want.items():
        assert bytes(store.read(k)) == v, k
    assert store.get("no/such/key") is None
    with pytest.raises(KeyError):
        store.read("no/such/key")


@pytest.mark.parametrize("target", ["manifest", "node"])
def test_a_flipped_byte_fails_the_crc32c_check(tmp_path, target):
    path = tmp_path / "fixture"
    shutil.copytree(ORBAX_FIXTURE, path)
    if target == "manifest":
        victim = path / "manifest.ocdbt"
    else:
        victim = next(p for p in sorted((path / "d").iterdir()))
    data = bytearray(victim.read_bytes())
    data[len(data) // 2] ^= 0x10
    victim.write_bytes(bytes(data))
    with pytest.raises(OcdbtError, match="crc32c"):
        OcdbtStore(str(path))


def test_a_wrong_magic_or_length_is_named(tmp_path):
    path = tmp_path / "fixture"
    shutil.copytree(ORBAX_FIXTURE, path)
    manifest = path / "manifest.ocdbt"
    data = manifest.read_bytes()
    manifest.write_bytes(b"\x0c\xdb\x20\xde" + data[4:])
    with pytest.raises(OcdbtError, match="magic"):
        OcdbtStore(str(path))
    manifest.write_bytes(data + b"\0")
    with pytest.raises(OcdbtError, match="header says"):
        OcdbtStore(str(path))


# ---------------------------------------------------------------------------
# zarr: chunk grids, edge and missing chunks, what is not read
# ---------------------------------------------------------------------------

def _write_zarr(root, name, meta, chunks):
    os.makedirs(os.path.join(root, name), exist_ok=True)
    with open(os.path.join(root, name, ".zarray"), "w") as f:
        json.dump({"zarr_format": 2, "order": "C", "filters": None,
                   "dimension_separator": ".", **meta}, f)
    for key, data in chunks.items():
        with open(os.path.join(root, name, key), "wb") as f:
            f.write(data)


@pytest.mark.parametrize("compressor", [None, "zstd"])
def test_zarr_edge_chunks_are_cropped_and_missing_chunks_filled(
        tmp_path, compressor):
    a = np.arange(15, dtype=np.float32).reshape(5, 3)
    chunks = {}
    for i in range(3):
        for j in range(2):
            if (i, j) in ((1, 1), (2, 0)):
                continue  # missing: fill_value
            c = np.zeros((2, 2), np.float32)
            block = a[2 * i:2 * i + 2, 2 * j:2 * j + 2]
            c[:block.shape[0], :block.shape[1]] = block
            raw = c.tobytes()
            chunks[f"{i}.{j}"] = raw if compressor is None else \
                zstandard.ZstdCompressor(level=3).compress(raw)
    _write_zarr(str(tmp_path), "x", {
        "shape": [5, 3], "chunks": [2, 2], "dtype": "<f4", "fill_value": -1,
        "compressor": None if compressor is None else {"id": "zstd",
                                                       "level": 3}}, chunks)
    want = a.copy()
    want[2:4, 2:3] = -1
    want[4:5, 0:2] = -1
    got = read_array(DirectoryStore(str(tmp_path)), "x")
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("field, value, named", [
    ("compressor", {"id": "blosc", "cname": "lz4"}, "blosc"),
    ("filters", [{"id": "delta", "dtype": "<f4"}], "delta"),
    ("order", "F", "'F'"),
    ("dtype", ">f4", "'>f4'"),
    ("dimension_separator", "/", "'/'"),
])
def test_zarr_refuses_and_names_what_it_does_not_read(tmp_path, field, value,
                                                      named):
    meta = {"shape": [2], "chunks": [2], "dtype": "<f4", "fill_value": None,
            "compressor": None}
    _write_zarr(str(tmp_path), "x", meta, {"0": np.zeros(2, np.float32)
                                           .tobytes()})
    with open(tmp_path / "x" / ".zarray") as f:
        meta = json.load(f)
    meta[field] = value
    with open(tmp_path / "x" / ".zarray", "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match=named):
        read_array(DirectoryStore(str(tmp_path)), "x")


# ---------------------------------------------------------------------------
# The committed fixture
# ---------------------------------------------------------------------------

def test_orbax_fixture_holds_against_the_jax_package():
    _, variables, _ = jax_fixture()
    want = jax_restore(str(ORBAX_FIXTURE))
    assert int(want["step"]) == ORBAX_FIXTURE_STEP
    assert_same_leaves({"params": want["params"],
                        "batch_stats": want["batch_stats"]},
                       {"params": variables["params"],
                        "batch_stats": variables["batch_stats"]})
    got = ckpt.restore_orbax(str(ORBAX_FIXTURE), device="cpu")
    assert_same_leaves(got, want)
    # real zstd frames: compressed blocks, with content sizes
    store = OcdbtStore(str(ORBAX_FIXTURE))
    chunks = [store.read(k) for k in store.list()
              if not k.endswith(".zarray")]
    assert sum(map(len, chunks)) < sum(zstd.decoded_bound(c)[0]
                                       for c in chunks)


def test_orbax_fixture_forward_matches_the_jax_output():
    tree = ckpt.restore_orbax(str(ORBAX_FIXTURE), device="cpu")
    sd = state_dict_from_jax(FIXTURE_MODEL, tree)
    model = model_from_state_dict(FIXTURE_MODEL, sd, {"logit_head": True})
    model = model.to(memory_format=torch.channels_last).eval()
    with torch.no_grad():
        got = to_nhwc(model(to_port(fixture_input())))
    want = np.load(str(JAX_FIXTURE_OUT))
    assert float(np.abs(got - want).max()) <= FIXTURE_TOL
    assert want.std() > 1e-2  # the comparison can fail


# ---------------------------------------------------------------------------
# Full width: the UNet through JAX's Orbax into the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def unet_dir(tmp_path_factory):
    """(JAX UNet, numpy variables, its JAX save_orbax directory): the
    full-width UNet (31 M parameters), weights drawn with numpy."""
    model, variables = random_variables("UNet.UNet", seed=4)
    path = str(tmp_path_factory.mktemp("unet") / "orbax")
    jax_save(path, variables)
    return model, variables, path


def test_full_width_unet_from_jax_orbax_matches_the_jax_forward(unet_dir):
    model, variables, path = unet_dir
    tree = ckpt.restore_orbax(path, device="cpu")
    assert_same_leaves(tree, variables)
    port = port_model("UNet.UNet", tree)  # strict=True
    x = np.random.RandomState(5).rand(1, 64, 64, 3).astype(np.float32)
    want = np.asarray(jax_apply(model, variables, x, train=False))
    with torch.no_grad():
        got = to_nhwc(port(to_port(x)))
    assert_close_to(got, want, EVAL_TOL)


def test_zstd_decodes_every_chunk_of_a_full_width_unet_directory(unet_dir):
    items = _tensorstore_items(unet_dir[2])
    chunks = {k: v for k, v in items.items() if not k.endswith(".zarray")}
    assert len(chunks) == len(jax.tree.leaves(unet_dir[1]))
    dec = zstandard.ZstdDecompressor()
    for k, v in chunks.items():
        assert zstd.decompress(v) == dec.decompress(
            v, max_output_size=1 << 30), k


if __name__ == "__main__":
    write_jax_orbax_fixture()
