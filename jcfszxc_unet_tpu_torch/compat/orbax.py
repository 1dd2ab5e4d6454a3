"""Orbax PyTree checkpoint directories, read and written without Orbax:
the tree layer over ``compat/zarr.py`` and ``compat/ocdbt.py``.

A directory holds ``_METADATA`` (JSON) and the arrays.  Its
``tree_metadata`` maps each leaf's path, written as a Python tuple of
strings (``"('params', 'w')"``), to

* ``key_metadata``: one ``{"key", "key_type"}`` for each level of the
  path, ``key_type`` 2 for a dict key and 1 for a sequence index (a list,
  a tuple; a named tuple's fields are dict keys);
* ``value_metadata``: ``value_type`` ``np.ndarray``, ``jax.Array`` (with
  its ``write_shape``), ``scalar`` (a Python or numpy number, kept as a
  0-d array) or ``None`` (with ``skip_deserialize``, no data).

Each array is the zarr v2 array named by its path joined with ``.``
(``('params', 'a.b')`` is ``params.a.b``): so the tree always comes from
``_METADATA``, never from splitting names.  With ``"use_ocdbt": true``
(what JAX's ``save_orbax`` writes) the arrays live in an OCDBT store at
the directory's root; else as plain files (``params.w/.zarray``,
``params.w/0.0``), which is what :func:`write_tree` writes (raw chunks,
no ``_CHECKPOINT_METADATA``), and what Orbax reads back.

Leaves come back as CPU tensors (arrays), Python ``int``/``float``/
``bool`` (scalars) and None; dict paths as dicts and sequence paths as
lists, as Orbax restores a tree without a template.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from jcfszxc_unet_tpu_torch.compat.ocdbt import MANIFEST_NAME, OcdbtStore
from jcfszxc_unet_tpu_torch.compat.zarr import (
    DirectoryStore,
    read_array,
    write_array,
)

METADATA = "_METADATA"
KEY_SEQUENCE, KEY_DICT = 1, 2
ARRAY_TYPES = ("np.ndarray", "jax.Array")


def param_name(keys) -> str:
    """The array name of a leaf's path (Orbax joins the keys with ``.``)."""
    return ".".join(keys)


class _Container:
    def __init__(self):
        self.kind = None
        self.children: Dict[str, Any] = {}

    def build(self):
        items = {k: v.build() if isinstance(v, _Container) else v
                 for k, v in self.children.items()}
        if self.kind == KEY_DICT:
            return items
        order = sorted(items, key=int)
        if [int(k) for k in order] != list(range(len(order))):
            raise ValueError(f"sequence indices {order} are not 0..n-1")
        return [items[k] for k in order]


def _insert(root: _Container, key_md: List[dict], leaf) -> None:
    if not key_md:
        raise ValueError("a leaf with an empty path")
    node = root
    for depth, km in enumerate(key_md):
        kind = km["key_type"]
        if kind not in (KEY_DICT, KEY_SEQUENCE):
            raise ValueError(f"key {km['key']!r}: key_type {kind} is not read "
                             f"(read: 2 dict, 1 sequence)")
        if node.kind is None:
            node.kind = kind
        elif node.kind != kind:
            raise ValueError(f"key {km['key']!r}: key_type {kind} where its "
                             f"siblings have {node.kind}")
        key = str(km["key"])
        if depth == len(key_md) - 1:
            node.children[key] = leaf
        else:
            node = node.children.setdefault(key, _Container())


def _read_leaf(store, name: str, value_md: dict):
    kind = value_md["value_type"]
    if kind == "None":
        return None
    if kind in ARRAY_TYPES:
        return read_array(store, name)
    if kind == "scalar":
        return read_array(store, name).item()
    raise ValueError(f"leaf {name}: value_type {kind!r} is not read (read: "
                     f"{', '.join(ARRAY_TYPES)}, scalar, None)")


def read_tree(ckpt_dir: str):
    """The tree of the Orbax directory ``ckpt_dir`` (leaves on the CPU).
    Arrays are decoded by one thread a core, up to 8: the zstd decoder
    releases the GIL."""
    with open(os.path.join(ckpt_dir, METADATA)) as f:
        meta = json.load(f)
    if meta.get("use_zarr3"):
        raise ValueError(f"{ckpt_dir}: zarr v3 arrays are not read")
    use_ocdbt = meta.get(
        "use_ocdbt", os.path.exists(os.path.join(ckpt_dir, MANIFEST_NAME)))
    store = OcdbtStore(ckpt_dir) if use_ocdbt else DirectoryStore(ckpt_dir)
    entries = list(meta["tree_metadata"].values())
    names = [param_name(str(km["key"]) for km in e["key_metadata"])
             for e in entries]
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        leaves = list(pool.map(_read_leaf, [store] * len(entries), names,
                               [e["value_metadata"] for e in entries]))
    root = _Container()
    for entry, leaf in zip(entries, leaves):
        _insert(root, entry["key_metadata"], leaf)
    return root.build()


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

def _flatten(tree, path: Tuple[Tuple[str, int], ...] = ()):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):  # named tuple
        tree = tree._asdict()
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, path + ((str(k), KEY_DICT),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + ((str(i), KEY_SEQUENCE),))
    else:
        yield path, tree


def _leaf_value(name: str, leaf):
    """(value_type, CPU tensor or None) of a leaf to save."""
    if leaf is None:
        return "None", None
    if isinstance(leaf, torch.Tensor):
        return "np.ndarray", leaf.detach().cpu()
    if isinstance(leaf, np.ndarray):
        return "np.ndarray", torch.from_numpy(np.ascontiguousarray(leaf))
    if isinstance(leaf, (bool, int, float, np.generic)):
        # Python numbers as numpy takes them (int64, float64, bool), as
        # Orbax stores them; numpy scalars keep their dtype.
        return "scalar", torch.from_numpy(np.array(leaf))
    raise TypeError(f"leaf {name}: cannot save a {type(leaf).__name__} "
                    f"(saved: tensors, numpy arrays, numbers, None)")


def write_tree(ckpt_dir: str, tree) -> None:
    """Writes ``tree`` (nests of dict, list and tuple over tensors on any
    device, numpy arrays, Python and numpy scalars and None) into the new
    directory ``ckpt_dir``, in the plain zarr layout."""
    os.makedirs(ckpt_dir)
    tree_md = {}
    for path, leaf in _flatten(tree):
        if not path:
            raise ValueError("the tree is a single leaf; Orbax saves a "
                             "dict, list or tuple of leaves")
        keys = tuple(k for k, _ in path)
        name = param_name(keys)
        kind, value = _leaf_value(name, leaf)
        if value is not None:
            write_array(ckpt_dir, name, value)
        value_md = {"value_type": kind, "skip_deserialize": value is None}
        tree_md[str(keys)] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in path],
            "value_metadata": value_md}
    with open(os.path.join(ckpt_dir, METADATA), "w") as f:
        json.dump({"tree_metadata": tree_md, "use_ocdbt": False,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
