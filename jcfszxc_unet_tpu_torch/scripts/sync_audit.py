"""Where the port's host waits for the card, on the card.

Runs the benchmark's three paths once each after a warm-up call, with
``torch.cuda.set_sync_debug_mode("warn")`` on and the port's spans
recorded (a CPU-only ``torch.profiler`` capture, so that
``utils.profiling.annotate`` opens them):

  * ``evaluate_arrays`` on one split of 20 DRIVE-sized (584 x 565) random
    images, patch 512, batch 32, bf16, AUC on, for UNet and NestedUNet;
  * one ``make_epoch_fn`` epoch of UNet (100 steps of 32 patches of 128^2,
    bf16) and one ``make_val_fn`` pass over 144 patches.

Every sync warning is listed with the program spans open when it was
raised; a sync outside a ``unet.sync`` span is a sync the spans miss.  It
also times ``annotate`` with no profiler running and with one, against a
bare ``record_function``.

    python -m jcfszxc_unet_tpu_torch.scripts.sync_audit [--out audit.json]

Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import time
import traceback
import warnings

import numpy as np

SYNC = "unet.sync"


class _Spans:
    """Stands in for ``torch.profiler.record_function`` while a path
    runs: opens the real span and keeps the names of those open."""

    real = None
    open: list = []
    syncs = 0

    def __init__(self, name):
        self.name, self.inner = name, _Spans.real(name)

    def __enter__(self):
        _Spans.open.append(self.name)
        _Spans.syncs += self.name == SYNC
        return self.inner.__enter__()

    def __exit__(self, *exc):
        _Spans.open.pop()
        return self.inner.__exit__(*exc)


def audit(fn) -> dict:
    """Run ``fn`` under sync warnings and the spans; the warnings, each
    with the spans open when it was raised, and the ``unet.sync`` spans
    opened."""
    import torch

    seen = []

    def show(message, category, filename, lineno, file=None, line=None):
        # the sync warnings, not the mode's own notice that it is a
        # prototype ("Synchronization debug mode is a prototype feature")
        text = str(message)
        if "synchroniz" in text and "prototype" not in text:
            seen.append({"where": f"{filename}:{lineno}",
                         "message": text[:160],
                         "spans": list(_Spans.open),
                         "stack": traceback.format_stack(limit=8)[:-1]})

    _Spans.real, _Spans.open, _Spans.syncs = (
        torch.profiler.record_function, [], 0)
    torch.profiler.record_function = _Spans
    torch.cuda.synchronize()
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = show
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
    finally:
        prof.stop()
        torch.profiler.record_function = _Spans.real
    outside = [w for w in seen if not w["spans"] or w["spans"][-1] != SYNC]
    return {"sync_warnings": len(seen), "sync_spans": _Spans.syncs,
            "outside": outside}


def _images(rng, n, h=584, w=565):
    images = rng.random((n, h, w, 3), dtype=np.float32)
    masks = np.zeros((n, h, w), np.float32)
    yy, xx = np.mgrid[:h, :w]
    masks[:, (yy - h / 2) ** 2 + (xx - w / 2) ** 2 < (0.45 * h) ** 2] = 1.0
    labels = (rng.random((n, h, w)) > 0.88).astype(np.float32)
    return images, masks, labels


def _model(name, seed, train):
    import torch

    from jcfszxc_unet_tpu_torch.models import create_model
    from jcfszxc_unet_tpu_torch.ops.layers import reset_parameters

    model = create_model(name)
    reset_parameters(model, torch.Generator().manual_seed(seed))
    model = model.to("cuda", memory_format=torch.channels_last)
    return model.train(train)


def eval_paths(seed: int) -> dict:
    import torch

    from jcfszxc_unet_tpu_torch.cli.evaluate import evaluate_arrays

    split = _images(np.random.default_rng(seed), 20)
    out = {}
    for name in ("UNet.UNet", "UNetPP.NestedUNet"):
        model = _model(name, seed, train=False)

        def call():
            return evaluate_arrays(
                model, *split, patch_size=512, inference_batch_size=32,
                compute_dtype=torch.bfloat16, compute_auc=True,
                threshold=0.5, device="cuda")

        call()  # warm-up: the kernels' build and plans, cuDNN, the allocator
        out[name] = audit(call)
        del model
    return out


def train_path(seed: int) -> dict:
    import torch

    from jcfszxc_unet_tpu_torch.cli.train import validation_patches
    from jcfszxc_unet_tpu_torch.data.sampler import build_train_sample_map
    from jcfszxc_unet_tpu_torch.train.optim import make_optimizer
    from jcfszxc_unet_tpu_torch.train.state import TrainState
    from jcfszxc_unet_tpu_torch.train.trainer import (
        make_epoch_fn,
        make_val_fn,
    )

    images, masks, labels = _images(np.random.default_rng(seed), 20)
    labels = labels[..., None]
    train, val = np.arange(2, 20), np.arange(2)
    model = _model("UNet.UNet", seed, train=True)
    state = TrainState(model=model, optimizer=make_optimizer(
        model.parameters(), 1e-6, 1e-8, 0.999))
    epoch_fn = make_epoch_fn(n_classes=1, batch_size=32, patch_size=128,
                             steps=100, compute_dtype=torch.bfloat16)
    val_fn = make_val_fn(model, compute_dtype=torch.bfloat16)
    pool = (torch.as_tensor(images[train], device="cuda"),
            torch.as_tensor(labels[train], device="cuda"),
            torch.as_tensor(build_train_sample_map(masks[train], 64),
                            device="cuda").long())
    val_imgs, val_labs = validation_patches(images, labels, val, 128,
                                            "cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)

    def call():
        epoch_fn(state, *pool, g)
        val_fn(val_imgs, val_labs)

    call()
    return {"UNet.UNet": audit(call)}


def annotate_cost(n: int = 100_000) -> dict:
    """Host us a span with no profiler running (the port's ``annotate``
    and a bare ``record_function``) and with a CPU profiler running."""
    import torch

    from jcfszxc_unet_tpu_torch.utils.profiling import annotate

    def per_call(make, k):
        t0 = time.perf_counter()
        for _ in range(k):
            with make("unet.x"):
                pass
        return (time.perf_counter() - t0) / k * 1e6

    out = {"annotate_off_us": per_call(annotate, n),
           "record_function_off_us": per_call(
               torch.profiler.record_function, n // 10)}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out["annotate_on_us"] = per_call(annotate, n // 10)
    return out


def main(argv=None) -> None:
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("sync_audit needs a CUDA GPU")
    res = {"device": torch.cuda.get_device_name(0),
           "torch": torch.__version__, "cost": annotate_cost(),
           "eval": eval_paths(a.seed), "train": train_path(a.seed)}
    text = json.dumps(res, indent=1)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text)
    print(text)


if __name__ == "__main__":
    main()
