"""The port's msgpack reader (``compat/msgpack.py``) against Flax's
``msgpack_restore`` on files the JAX package writes, and against the
``msgpack`` package on every tag and width the reader handles.

    python -m tests.test_torch_port_msgpack

times both readers on a UNet-size JAX checkpoint on the CPU.
"""

import json
import math
import struct
import time

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from jcfszxc_unet_tpu.train.checkpoint import save_model as jax_save_model
from jcfszxc_unet_tpu.train.optim import make_optimizer
from jcfszxc_unet_tpu_torch.compat.msgpack import unpackb
from jcfszxc_unet_tpu_torch.train.checkpoint import read_jax_ckpt

from .torch_port_common import assert_same_tree, random_variables


def flax_tree(path):
    with open(path, "rb") as f:
        tree = serialization.msgpack_restore(f.read())
    tree["config"] = json.loads(tree["config"])
    return tree


def write_jax_ckpt(path, name, model_kwargs, with_opt_state=False):
    _, variables = random_variables(name, **model_kwargs)
    extra = None
    if with_opt_state:
        opt_state = make_optimizer(1e-6).init(variables["params"])
        extra = {"opt_state": serialization.to_state_dict(opt_state),
                 "progress": {"epoch": 3, "best_dice": 0.25,
                              "patience_counter": 1,
                              "scheduler_best": float("-inf"),
                              "scheduler_bad": 0, "scheduler_cooldown": 2}}
    jax_save_model(str(path), name, model_kwargs, variables["params"],
                   variables["batch_stats"], extra=extra)
    return variables


@pytest.mark.parametrize("name,kwargs,opt", [
    ("UNet.UNet", {}, True),
    ("BCDUNet.BCDU_net_D1", {"N": 32}, False),
    ("FRUNet.FRUNet", {}, False),
], ids=["UNet", "BCDU_net_D1", "FRUNet"])
def test_reader_gives_flax_tree(tmp_path, name, kwargs, opt):
    path = tmp_path / "model.ckpt"
    write_jax_ckpt(path, name, kwargs, with_opt_state=opt)
    got, want = read_jax_ckpt(str(path)), flax_tree(path)
    assert got["config"] == {"model_name": name, "model_kwargs": kwargs}
    if opt:  # the optax state: counts (int32) and the injected lr
        leaves = dict(jax.tree_util.tree_leaves_with_path(
            want["extra"]["opt_state"]))
        assert any(np.asarray(v).dtype == np.int32 for v in leaves.values())
        assert math.isinf(got["extra"]["progress"]["scheduler_best"])
    assert_same_tree(got, want)
    # leaves are views of the file's buffer, not copies
    kernel = got["params"][next(iter(got["params"]))]
    while isinstance(kernel, dict):
        kernel = kernel[next(iter(kernel))]
    assert not kernel.flags.owndata and kernel.flags.writeable


# Every tag the reader handles: positive and negative fixint, every int
# and uint width, float32/64, nil, bool, fixstr/str8/16/32,
# bin8/16/32, fixarray/array16/32, fixmap/map16/32.
CASES = {
    "fixint": [0, 1, 127], "negfixint": [-1, -32],
    "uint8": [128, 255], "uint16": [256, 65535],
    "uint32": [65536, 2**32 - 1], "uint64": [2**32, 2**64 - 1],
    "int8": [-33, -128], "int16": [-129, -32768],
    "int32": [-32769, -2**31], "int64": [-2**31 - 1, -2**63],
    "float64": [1.5, -0.0, float("inf")], "nil_bool": [None, True, False],
    "fixstr": ["", "x" * 31, "été"], "str8": ["y" * 32, "z" * 255],
    "str16": ["a" * 256], "str32": ["b" * 65536],
    "bin8": [b"", b"\x00\xff" * 10], "bin16": [b"c" * 256],
    "bin32": [b"d" * 65536],
    "fixarray": [[], [1, [2, "3"]], list(range(15))],
    "array16": [list(range(16))], "array32": [[0] * 65536],
    "fixmap": [{}, {"a": {"b": None}}], "map16": [{str(i): i for i in
                                                   range(16)}],
    "map32": [{str(i): i for i in range(65536)}],
}


@pytest.mark.parametrize("kind", sorted(CASES))
def test_tags_match_msgpack(kind):
    for value in CASES[kind]:
        data = msgpack.packb(value, use_bin_type=True)
        got = unpackb(data)
        assert got == msgpack.unpackb(data, raw=False)
        assert type(got) is type(value)


def test_float32_tag():
    data = msgpack.packb(0.1, use_single_float=True)
    assert data[0] == 0xca
    assert unpackb(data) == struct.unpack(">f", data[1:])[0]


def _ext(code, payload, form):
    """``payload`` under ext type ``code`` in header ``form``."""
    n = len(payload)
    if form == "fixext":
        head = bytes([{1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}[n]])
    else:
        tag, fmt = {"ext8": (0xc7, ">B"), "ext16": (0xc8, ">H"),
                    "ext32": (0xc9, ">I")}[form]
        head = bytes([tag]) + struct.pack(fmt, n)
    return head + struct.pack(">b", code) + payload


@pytest.mark.parametrize("form", ["ext8", "ext16", "ext32"])
def test_ext_headers(form):
    assert unpackb(_ext(2, msgpack.packb([1, 2]), form)) == complex(1, 2)


@pytest.mark.parametrize("size", [1, 2, 4, 8, 16])
def test_unknown_ext_types_raise(size):
    with pytest.raises(ValueError, match="ext type 7 "):
        unpackb(_ext(7, b"\x00" * size, "fixext"))
    with pytest.raises(ValueError, match="ext type -3 "):
        unpackb(_ext(-3, b"\x00" * size, "ext8"))


def test_flax_leaves_bf16_scalar_complex_and_chunked(monkeypatch):
    tree = {
        "bf16": np.arange(6, dtype=jnp.bfloat16).reshape(2, 3),
        "bf16_scalar": np.asarray(2.5, jnp.bfloat16),
        "f32_scalar": np.float32(3.25), "i64_scalar": np.int64(-7),
        "bool": np.array([True, False]), "u8": np.arange(5, dtype=np.uint8),
        "empty": np.zeros((0, 4), np.float16),
        "complex": complex(1.5, -2.0),
        "nested": {"x": 1, "y": "s"},
    }
    data = serialization.msgpack_serialize(tree)
    got = unpackb(bytearray(data))
    assert got["complex"] == complex(1.5, -2.0)
    assert got["bf16_scalar"].shape == () and float(got["bf16_scalar"]) == 2.5
    want = serialization.msgpack_restore(data)
    del got["complex"], want["complex"]
    assert_same_tree(got, want)

    # leaves over MAX_CHUNK_SIZE bytes are split by flax and joined here
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    big = {"w": np.arange(100, dtype=np.float32).reshape(4, 25),
           "h": np.arange(70, dtype=jnp.bfloat16).reshape(7, 10)}
    data = serialization.msgpack_serialize(big)
    assert b"__msgpack_chunked_array__" in data
    got = unpackb(bytearray(data))
    assert_same_tree(got, serialization.msgpack_restore(data))


@pytest.mark.parametrize("data,match", [
    (b"\xc1", "tag 0xc1"),
    (b"\x92\x01", "ends where an object was expected"),
    (b"\xa5abc", "ends inside an object"),
    (b"\x01\x02", "1 trailing bytes"),
])
def test_malformed_data_raises(data, match):
    with pytest.raises(ValueError, match=match):
        unpackb(data)


def time_readers(reps=3):
    """CPU seconds of Flax's msgpack_restore and of the port's
    read_jax_ckpt on a UNet checkpoint written by the JAX package."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "unet.ckpt")
        write_jax_ckpt(path, "UNet.UNet", {})
        out = {"bytes": os.path.getsize(path)}
        for name, fn in (("flax", flax_tree), ("port", read_jax_ckpt)):
            fn(path)
            t0 = time.perf_counter()
            for _ in range(reps):
                fn(path)
            out[f"{name}_s"] = (time.perf_counter() - t0) / reps
    return out


if __name__ == "__main__":
    torch.set_num_threads(1)
    print(json.dumps(time_readers()))
