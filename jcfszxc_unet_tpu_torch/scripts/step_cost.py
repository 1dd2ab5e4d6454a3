"""Host-clock cost of the train path's step and validation pass, on the card.

Times, on full-width UNet with seeded weights at the train CLI's defaults
(bf16, batch 32 of 128^2 patches), ``train.trainer.make_batch_step_fn``'s
step and ``make_val_fn``'s pass over 144 patches in chunks of 64, each
ended by a device sync, in ``rounds`` rounds of ``steps`` steps then one
validation pass, and reports the median and quartiles of each.  It uses
only the train API that every checkout of the package since the trainer
was ported has, so it also times another checkout put first on
``PYTHONPATH``; run it in turns from two checkouts to compare them in one
call:

    python -m jcfszxc_unet_tpu_torch.scripts.step_cost [--rounds 40] \\
        [--out step_cost.json]
    PYTHONPATH=<other checkout> python <this file> --out other.json

Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time


def _summary(samples_ms):
    q = statistics.quantiles(samples_ms, n=4)
    return {"median": statistics.median(samples_ms), "q1": q[0], "q3": q[2],
            "n": len(samples_ms)}


def measure(rounds: int = 40, steps: int = 5, seed: int = 0) -> dict:
    import torch

    import jcfszxc_unet_tpu_torch
    from jcfszxc_unet_tpu_torch.models import create_model
    from jcfszxc_unet_tpu_torch.ops.layers import reset_parameters
    from jcfszxc_unet_tpu_torch.train.optim import make_optimizer
    from jcfszxc_unet_tpu_torch.train.state import TrainState
    from jcfszxc_unet_tpu_torch.train.trainer import (
        make_batch_step_fn,
        make_val_fn,
    )

    if not torch.cuda.is_available():
        raise RuntimeError("step_cost needs a CUDA GPU")
    g = torch.Generator().manual_seed(seed)
    model = create_model("UNet.UNet")
    reset_parameters(model, g)
    model = model.to("cuda", memory_format=torch.channels_last).train()
    state = TrainState(model=model,
                       optimizer=make_optimizer(model.parameters(), 1e-6))
    step = make_batch_step_fn(n_classes=model.n_classes,
                              compute_dtype=torch.bfloat16)
    val = make_val_fn(model, chunk_size=64, compute_dtype=torch.bfloat16)
    gd = torch.Generator(device="cuda").manual_seed(seed)

    def patches(n):
        return (torch.rand((n, 128, 128, 3), generator=gd, device="cuda"),
                (torch.rand((n, 128, 128, 1), generator=gd, device="cuda")
                 > 0.85).float())

    imgs, labs = patches(32)
    val_imgs, val_labs = patches(144)
    for _ in range(3):  # warm-up: cuDNN's choices, the allocator, the plans
        step(state, imgs, labs)
        val(val_imgs, val_labs)
    torch.cuda.synchronize()
    step_ms, val_ms = [], []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(steps):
            step(state, imgs, labs)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3 / steps)
        t0 = time.perf_counter()
        val(val_imgs, val_labs)
        torch.cuda.synchronize()
        val_ms.append((time.perf_counter() - t0) * 1e3)
    return {"package": jcfszxc_unet_tpu_torch.__file__,
            "device": torch.cuda.get_device_name(0),
            "rounds": rounds, "steps_per_round": steps,
            "step_ms": _summary(step_ms), "val_ms": _summary(val_ms)}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rounds", type=int, default=40)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    text = json.dumps(measure(a.rounds, a.steps))
    if a.out:
        with open(a.out, "w") as f:
            f.write(text)
    print(text)


if __name__ == "__main__":
    main()
