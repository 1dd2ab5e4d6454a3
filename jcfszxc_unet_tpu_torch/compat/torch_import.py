"""Reference PyTorch checkpoints (``.pth``) into the port, counterpart of
``jcfszxc_unet_tpu/compat/torch_import.py``.

The reference saves the whole pickled ``nn.Module`` (train.py:374:
``torch.save(model, "best_model.pth")``); its train-demo saves a
``{"model_state_dict": ...}`` bundle; a bare state dict is the usual
interchange.  :func:`read_pth` reads all three.  Bare state dicts and
bundles load with ``torch.load(weights_only=True)``; a whole module is
unpickled by a skeleton unpickler: every class outside ``_TRUSTED_ROOTS``
(the reference's model and block classes, and the port's own, so that a
``.pth`` never runs port code while it is unpickled) becomes an empty
``nn.Module`` subclass, and pickle restores its ``__dict__``, which holds
all that ``state_dict()`` needs.  Unpickling runs what the file names
inside the trusted roots: read only files you trust.

The port's modules use the reference's attribute names and torch layouts,
so a reference state dict loads into the port's model of the same name
with ``strict=True`` once the dead keys of ``EXPECTED_UNUSED`` are
dropped (:func:`model_from_state_dict`).

CLI:  python -m jcfszxc_unet_tpu_torch.compat.torch_import \\
          --pth best_model.pth --model UNet.UNet --out best_model.pt
"""

from __future__ import annotations

import argparse
import io
import pickle
import re
from typing import Any, Dict, Optional

import torch
from torch import nn

from jcfszxc_unet_tpu_torch.models import MODEL_REGISTRY, create_model

# Only torch/stdlib/numpy payload machinery resolves for real; every other
# class becomes a skeleton nn.Module.
_TRUSTED_ROOTS = ("torch", "collections", "builtins", "numpy",
                  "functools", "copyreg", "pickle", "_codecs")

# State-dict keys the reference defines but never uses in its forward,
# matched by regex per model (the JAX package's
# compat/torch_mapping.EXPECTED_UNUSED).  FRUNet.py:105's top-level
# ``fuse`` head is dead, and so is the ``fuse`` of every grid ``block``
# with in_c == out_c (unet_parts.py:563-566 against the forward at :577);
# the port's FRUNet has neither.
EXPECTED_UNUSED: Dict[str, tuple] = {
    "FRUNet.FRUNet": (r"^fuse\.", r"^block[0-9_]+\.fuse\."),
}


def _make_shim():
    """A pickle-module shim whose Unpickler makes skeleton nn.Module
    subclasses of the classes outside ``_TRUSTED_ROOTS``."""
    made = {}

    class SkeletonUnpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module == "__builtin__":  # legacy Py2 spelling in torch pickles
                module = "builtins"
            if module.split(".")[0] in _TRUSTED_ROOTS:
                return super().find_class(module, name)
            key = (module, name)
            if key not in made:
                made[key] = type(name, (nn.Module,), {"__module__": module})
            return made[key]

    # torch.load(pickle_module=...) accepts a module-like namespace.
    class _PickleShim:
        Unpickler = SkeletonUnpickler
        load = staticmethod(lambda f, **kw: SkeletonUnpickler(f, **kw).load())
        loads = staticmethod(
            lambda b, **kw: SkeletonUnpickler(io.BytesIO(b), **kw).load())
        HIGHEST_PROTOCOL = pickle.HIGHEST_PROTOCOL
        dump = staticmethod(pickle.dump)
        dumps = staticmethod(pickle.dumps)

    return _PickleShim


def read_pth(path: str) -> Any:
    """The object a ``.pth`` holds, on the CPU: a dict as
    ``torch.load(weights_only=True)`` gives it, or, for a whole pickled
    module (which that refuses), a skeleton module."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        return torch.load(path, map_location="cpu", weights_only=False,
                          pickle_module=_make_shim())


def state_dict_of(obj: Any) -> Dict[str, torch.Tensor]:
    """The state dict in what :func:`read_pth` returned: a module's, a
    bundle's ``model_state_dict``/``state_dict``, or the dict itself."""
    if isinstance(obj, nn.Module):
        return obj.state_dict()
    if isinstance(obj, dict):
        for key in ("model_state_dict", "state_dict"):
            if isinstance(obj.get(key), dict):
                obj = obj[key]
                break
        bad = [k for k, v in obj.items()
               if not (isinstance(k, str) and isinstance(v, torch.Tensor))]
        if not bad:
            return obj
        raise ValueError(f"the .pth dict is not a state dict: {bad[:5]} are "
                         f"not str -> tensor entries")
    raise ValueError(f"unsupported .pth payload type: {type(obj)!r}")


def model_name_of(obj: Any) -> Optional[str]:
    """The registry name of a whole pickled module's class ("UNet.UNet"
    for ``UNetFamily.UNet.UNet``), or None."""
    if not isinstance(obj, nn.Module):
        return None
    name = f"{type(obj).__module__.split('.')[-1]}.{type(obj).__name__}"
    return name if name in MODEL_REGISTRY else None


def load_pth_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a ``.pth`` (whole module, bundle or bare)."""
    return state_dict_of(read_pth(path))


def detect_pth_model_name(path: str) -> Optional[str]:
    """The registry name of the class pickled in a whole-module ``.pth``,
    or None when the file holds no registry model class."""
    return model_name_of(read_pth(path))


def _split(model_name: str, state_dict, own_keys):
    """(state dict without the dead keys the model lacks, missing keys,
    unexpected keys)."""
    dead = [re.compile(p) for p in EXPECTED_UNUSED.get(model_name, ())]
    kept = {k: v for k, v in state_dict.items()
            if k in own_keys or not any(p.search(k) for p in dead)}
    return (kept, sorted(set(own_keys) - set(kept)),
            sorted(set(kept) - set(own_keys)))


def infer_model_name(state_dict) -> str:
    """The registry model whose state dict has exactly these keys and
    shapes (dead keys aside): the model of a bare state dict, which
    carries no class.  Raises unless exactly one model matches."""
    want = {k: tuple(v.shape) for k, v in state_dict.items()}
    found = []
    for name in sorted(MODEL_REGISTRY):
        kwargs = {"N": 64} if name.startswith("BCDUNet.") else {}
        with torch.device("meta"):  # shapes only, no memory
            own = create_model(name, **kwargs).state_dict()
        kept, missing, unexpected = _split(name, want, own)
        if not missing and not unexpected and all(
                kept[k] == tuple(v.shape) for k, v in own.items()):
            found.append(name)
    if len(found) != 1:
        raise ValueError(
            f"the state dict's {len(want)} keys match "
            f"{found or 'no model of the registry'}; pass the model's name "
            f"(e.g. compat.torch_import --model)")
    return found[0]


def model_from_state_dict(model_name: str, state_dict,
                          model_kwargs: Optional[Dict[str, Any]] = None,
                          device="cpu") -> nn.Module:
    """The port's model ``model_name`` built on ``device`` with
    ``state_dict`` loaded ``strict=True``.  The dead keys of
    ``EXPECTED_UNUSED`` are dropped where the model has no such key; any
    other missing or unexpected key raises ``ValueError`` naming it."""
    with torch.device(device):
        model = create_model(model_name, **dict(model_kwargs or {}))
    kept, missing, unexpected = _split(model_name, state_dict,
                                       model.state_dict().keys())
    if missing or unexpected:
        raise ValueError(
            f"state dict does not fit {model_name}: missing keys {missing}, "
            f"unexpected keys {unexpected}")
    model.load_state_dict(kept, strict=True)
    return model


def import_torch_checkpoint(pth_path: str, model_name: str, out_path: str,
                            model_kwargs: Optional[Dict[str, Any]] = None
                            ) -> str:
    """``.pth`` -> the port's checkpoint (train/checkpoint.py)."""
    from jcfszxc_unet_tpu_torch.train.checkpoint import save_model

    kwargs = dict(model_kwargs or {})
    model = model_from_state_dict(model_name, load_pth_state_dict(pth_path),
                                  kwargs)
    return save_model(out_path, model_name, kwargs, model)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Convert a reference PyTorch .pth checkpoint (whole "
                    "pickled module, bundle or state dict) into a "
                    "checkpoint of the PyTorch port")
    p.add_argument("--pth", required=True, help="input .pth path")
    p.add_argument("--model", required=True,
                   help='registry name, e.g. "UNet.UNet"')
    p.add_argument("--out", required=True, help="output checkpoint path")
    p.add_argument("--patch-size", type=int, default=64,
                   help="the N kwarg of the BCDU models")
    args = p.parse_args(argv)
    kwargs = {"N": args.patch_size} if args.model.startswith("BCDUNet.") else {}
    out = import_torch_checkpoint(args.pth, args.model, args.out,
                                  model_kwargs=kwargs)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
