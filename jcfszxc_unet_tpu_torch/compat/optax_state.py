"""The optax state of a JAX training checkpoint -> the port's RMSprop state.

The JAX train CLI's ``--latest-path`` file holds, in ``extra["opt_state"]``,
Flax's state dict of the optimizer that ``train/optim.make_optimizer``
builds with ``flatten=False``:
``inject_hyperparams(chain(clip_by_global_norm, add_decayed_weights,
scale_by_rms, trace, scale_by_learning_rate))``, i.e.

    {"count": n, "hyperparams": {"learning_rate": lr},
     "hyperparams_states": {},
     "inner_state": {"0": {}, "1": {}, "2": {"nu": <params tree>},
                     "3": {"trace": <params tree>}, "4": {}}}

(the clip and the weight decay keep no state; the entries without
weight decay or momentum are missing).  That update is torch's
``RMSprop(alpha, eps, weight_decay, momentum)`` after a global-norm clip
(``train/optim.py``), so its state maps leaf for leaf:

  * ``nu``    -> ``square_avg``
  * ``trace`` -> ``momentum_buffer``
  * ``count`` -> ``step``
  * the injected ``learning_rate`` -> the param groups' ``lr``

Each of ``nu`` and ``trace`` has the parameters' tree, so it goes through
``compat/from_jax``'s key rules and leaf transforms (HWIO -> OIHW, the
transposed convs' flip, ...) like the weights.  A flattened state
(``optax.flatten``: one raveled vector per entry) or any other layout
raises ``ValueError``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from jcfszxc_unet_tpu_torch.compat.from_jax import state_dict_from_jax

_LAYOUT = ("the per-leaf inject_hyperparams(chain(clip_by_global_norm, "
           "add_decayed_weights, scale_by_rms, trace, scale_by_learning_rate))"
           " state that the JAX train CLI writes")


def _stats_like(tree):
    """A ``batch_stats`` tree for a parameters-shaped ``tree``: zeros for
    each BatchNorm's mean and var, so the key rules can walk it (the
    statistics are dropped again)."""
    out = {}
    for k, v in tree.items():
        if k == "bn":
            c = np.asarray(v["scale"]).shape
            out[k] = {"mean": np.zeros(c, np.float32),
                      "var": np.zeros(c, np.float32)}
        elif isinstance(v, dict):
            out[k] = _stats_like(v)
    return out


def _entry(inner: Dict[str, Any], field: str):
    """The one chain entry's ``field`` tree, or None when no entry has it."""
    found = [e[field] for e in inner.values()
             if isinstance(e, dict) and field in e]
    if len(found) > 1:
        raise ValueError(f"opt_state has {len(found)} entries with {field!r};"
                         f" expected {_LAYOUT}")
    if not found:
        return None
    if not isinstance(found[0], dict):
        raise ValueError(
            f"opt_state's {field!r} is a {type(found[0]).__name__}, not a "
            f"tree of the parameters: a flattened optax state "
            f"(optax.flatten) is not mapped; expected {_LAYOUT}")
    return found[0]


def _by_name(model_name: str, tree, names) -> Dict[str, torch.Tensor]:
    sd = state_dict_from_jax(model_name, {"params": tree,
                                          "batch_stats": _stats_like(tree)})
    got = {k: v for k, v in sd.items() if k in names}
    missing = sorted(set(names) - set(got))
    if missing:
        raise ValueError(f"opt_state does not cover the parameters "
                         f"{missing[:8]}{' ...' if len(missing) > 8 else ''}")
    return got


def rmsprop_state_dict(model_name: str, opt_state: Dict[str, Any],
                       model: nn.Module,
                       optimizer: torch.optim.Optimizer) -> Dict[str, Any]:
    """``optimizer.state_dict()`` holding the state of a JAX ``opt_state``
    (numpy leaves) for ``model`` (registry ``model_name``), whose
    parameters ``optimizer`` (the port's RMSprop) steps: load it with
    ``optimizer.load_state_dict``.  Raises ``ValueError`` for another
    layout or a momentum that does not match."""
    if not (isinstance(opt_state, dict)
            and {"count", "hyperparams", "inner_state"} <= set(opt_state)
            and isinstance(opt_state["inner_state"], dict)
            and "learning_rate" in opt_state["hyperparams"]):
        keys = sorted(opt_state) if isinstance(opt_state, dict) else opt_state
        raise ValueError(f"opt_state with keys {keys} is not {_LAYOUT}")
    inner = opt_state["inner_state"]
    nu, trace = _entry(inner, "nu"), _entry(inner, "trace")
    if nu is None:
        raise ValueError(f"opt_state has no scale_by_rms entry ('nu'); "
                         f"expected {_LAYOUT}")
    template = optimizer.state_dict()
    momentum = template["param_groups"][0]["momentum"]
    if (trace is None) != (momentum == 0):
        raise ValueError(
            f"opt_state {'has no' if trace is None else 'has a'} trace "
            f"entry, the optimizer's momentum is {momentum}")

    index = {id(p): i for i, p in enumerate(
        p for g in optimizer.param_groups for p in g["params"])}
    names = {n: index[id(p)] for n, p in model.named_parameters()
             if id(p) in index}
    square_avg = _by_name(model_name, nu, names)
    buffers = {} if trace is None else _by_name(model_name, trace, names)
    for name, p in model.named_parameters():
        for tree in (square_avg, buffers):
            if name in tree and tree[name].shape != p.shape:
                raise ValueError(f"opt_state's {name} has shape "
                                 f"{tuple(tree[name].shape)}, the parameter "
                                 f"{tuple(p.shape)}")
    step = torch.tensor(float(np.asarray(opt_state["count"])))
    state = {}
    for name, i in names.items():
        state[i] = {"step": step.clone(), "square_avg": square_avg[name]}
        if trace is not None:
            state[i]["momentum_buffer"] = buffers[name]
    lr = float(np.asarray(opt_state["hyperparams"]["learning_rate"]))
    groups = [dict(g, lr=lr) for g in template["param_groups"]]
    return {"state": state, "param_groups": groups}
