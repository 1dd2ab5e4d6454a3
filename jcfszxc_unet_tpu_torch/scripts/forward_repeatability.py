"""Which modules of a model's eager forward do not reproduce bit for bit.

Builds a registry model from a seed (``layers.reset_parameters``; a
logit head where the model takes one) in eval mode on the card, f32 with
TF32 off, and records every module call's inputs and output on one seeded
input (forward hooks).  Then it calls each module again on its own
recorded inputs ``repeats`` times and reports, per call, the largest
difference from the recorded output.  A module whose output moves on
identical inputs holds an op that is not deterministic; the innermost
such modules name it.  The re-calls run twice: with cuDNN free to choose
its algorithms, as the port runs, and with
``torch.backends.cudnn.deterministic`` on.

    python -m jcfszxc_unet_tpu_torch.scripts.forward_repeatability \\
        [--model RetinaLiteNet.TransFuseNet] [--batch 2] [--size 128] \\
        [--repeats 20] [--out repeatability.json]

Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json


def _tensors(obj):
    import torch

    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for o in obj for t in _tensors(o)]
    if isinstance(obj, dict):
        return [t for o in obj.values() for t in _tensors(o)]
    return []


def _clone(obj):
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, (tuple, list)):
        return type(obj)(_clone(o) for o in obj)
    if isinstance(obj, dict):
        return {k: _clone(v) for k, v in obj.items()}
    return obj


def _max_abs_diff(a, b) -> float:
    return max((float((x.float() - y.float()).abs().max())
                for x, y in zip(_tensors(a), _tensors(b)) if x.numel()),
               default=0.0)


def record_calls(model, x):
    """[(name, module, args, kwargs, output)] of every module call of
    ``model(x)``, inputs cloned before the call (an in-place op must not
    change the record) and outputs after it."""
    import torch

    calls, pending, hooks = [], {}, []
    for name, module in model.named_modules():
        def pre(m, args, kwargs, name=name):
            pending.setdefault(name, []).append((_clone(args), _clone(kwargs)))

        def post(m, args, kwargs, out, name=name):
            a, k = pending[name].pop()
            calls.append((name, m, a, k, _clone(out)))

        hooks.append(module.register_forward_pre_hook(pre, with_kwargs=True))
        hooks.append(module.register_forward_hook(post, with_kwargs=True))
    try:
        with torch.inference_mode():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    return calls


def recall(calls, repeats: int):
    """Per recorded call, the largest difference between its recorded
    output and ``repeats`` outputs of the module on the same inputs."""
    import torch

    rows = []
    with torch.inference_mode():
        for name, module, args, kwargs, out in calls:
            diff = 0.0
            for _ in range(repeats):
                diff = max(diff, _max_abs_diff(
                    module(*_clone(args), **_clone(kwargs)), out))
            rows.append({"module": name or "<model>",
                         "type": type(module).__name__, "max_abs_diff": diff,
                         "out_abs_max": max((float(t.float().abs().max())
                                             for t in _tensors(out)
                                             if t.numel()), default=0.0)})
    return rows


def innermost(rows):
    """The differing modules with no differing module inside them."""
    moved = [r["module"] for r in rows if r["max_abs_diff"] > 0]
    return sorted({m for m in moved
                   if not any(o.startswith(m + ".") for o in moved)
                   and not (m == "<model>" and len(moved) > 1)})


def measure(model_name: str = "RetinaLiteNet.TransFuseNet", batch: int = 2,
            size: int = 128, repeats: int = 20, seed: int = 0) -> dict:
    import torch

    from jcfszxc_unet_tpu_torch.models import create_model, model_takes
    from jcfszxc_unet_tpu_torch.ops.layers import reset_parameters

    if not torch.cuda.is_available():
        raise RuntimeError("forward_repeatability needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator().manual_seed(seed)
    model = create_model(model_name, **(
        {"logit_head": True} if model_takes(model_name, "logit_head") else {}))
    reset_parameters(model, g)
    model = model.to("cuda", memory_format=torch.channels_last).eval()
    x = torch.rand((batch, 3, size, size), generator=g).to(
        "cuda", memory_format=torch.channels_last)
    calls = record_calls(model, x)
    out = {"model": model_name, "input": [batch, 3, size, size],
           "repeats": repeats, "n_calls": len(calls),
           "device": torch.cuda.get_device_name(0)}
    for key, deterministic in (("free", False), ("cudnn_deterministic", True)):
        torch.backends.cudnn.deterministic = deterministic
        try:
            rows = recall(calls, repeats)
        finally:
            torch.backends.cudnn.deterministic = False
        out[key] = {"innermost": innermost(rows),
                    "moved": [r for r in rows if r["max_abs_diff"] > 0]}
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--model", default="RetinaLiteNet.TransFuseNet")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--size", type=int, default=128)
    p.add_argument("--repeats", type=int, default=20)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    res = measure(a.model, a.batch, a.size, a.repeats)
    text = json.dumps(res, indent=1)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text)
    print(text)


if __name__ == "__main__":
    main()
