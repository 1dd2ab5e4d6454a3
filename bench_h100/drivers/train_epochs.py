"""Driver of training traffic: the epoch loop of the port's
``cli/train.py`` ``train_arrays``, composed from the same calls: each epoch
is ``make_epoch_fn``'s ``steps`` steps on patches sampled on the device,
a device sync, then ``make_val_fn``'s pass over the validation patches
and its Dice read on the host.  No checkpoint is written: a run's disk
budget is a few GiB and a save of an improving epoch is 124 MB a time.

Set-up builds the one train state the window uses and drives it from the
seed through a validation pass, its first epoch (one call of the window's
own epoch function on the window's state and feed) and a second
validation pass.  What they give is kept and, once the window has closed,
held against the plain reference run from the same weights over the same
batches: the epoch's summed loss, each leaf's first gradient as RMSprop
got it (from its state after the first step: magnitude
sqrt(v / (1 - alpha)), sign that of the momentum buffer; read by a hook on
the optimizer's step that is removed before the window), each leaf's
change over the epoch, the first validation pass's probabilities, and the
second pass's Dice against the Dice of its own probabilities.  The
probabilities are compared before the epoch: after 100 steps in bf16 and
in f32 the two models' eval-mode maps part by up to a sixth, seed by seed,
so only the start has a reference to read."""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from harness import faults
from harness.common import check, quantile, subseed
from harness.synth import synthetic_drive
from reference import protocol as ref

ALPHA = 0.99  # RMSprop's smoothing constant in the program and reference
# Leaves whose reference gradient norm is under this share of the median
# leaf's move by round-off alone under RMSprop (a conv bias before a
# BatchNorm); their change is not compared.
GRAD_FLOOR = 1e-3


class TrainEpochs:
    def __init__(self, run):
        self.run = run
        self.tr = run.traffic

    # ------------------------------------------------------------- set-up
    def setup(self):
        from jcfszxc_unet_tpu_torch.cli.train import validation_patches
        from jcfszxc_unet_tpu_torch.data.sampler import (
            build_train_sample_map,
        )
        from jcfszxc_unet_tpu_torch.train.optim import make_optimizer
        from jcfszxc_unet_tpu_torch.train.state import TrainState
        from jcfszxc_unet_tpu_torch.train.trainer import (
            make_epoch_fn,
            make_val_fn,
        )

        run, tr, dev = self.run, self.tr, self.run.device
        g = torch.Generator(device=dev).manual_seed(subseed(run.seed, "data"))
        images, masks, labels = (t.cpu().numpy() for t in synthetic_drive(
            tr["images"], tr["height"], tr["width"], g, dev))
        perm = np.random.default_rng(
            subseed(run.seed, "split")).permutation(tr["images"])
        n_val = int(tr["images"] * tr["val_percent"])
        self.val_idx, self.train_idx = perm[:n_val], perm[n_val:]
        self.images, self.masks = images, masks
        self.labels = labels[..., None]
        patch, half = tr["patch"], tr["patch"] // 2

        model = run.program_model().train()
        self.train_images = torch.as_tensor(images[self.train_idx],
                                            device=dev)
        self.train_labels = torch.as_tensor(self.labels[self.train_idx],
                                            device=dev)
        self.train_map = torch.as_tensor(build_train_sample_map(
            masks[self.train_idx], half), device=dev).long()
        self.val_imgs, self.val_labs = validation_patches(
            images, self.labels, self.val_idx, patch, dev)
        opt = make_optimizer(model.parameters(), tr["lr"],
                             tr["weight_decay"], tr["momentum"])
        self.state = TrainState(model=model, optimizer=opt)
        self.epoch_fn = make_epoch_fn(
            steps=tr["steps"], n_classes=model.n_classes,
            batch_size=tr["batch"], patch_size=patch,
            compute_dtype=run.compute_dtype)
        self.val_fn = make_val_fn(model, compute_dtype=run.compute_dtype)
        self.generator = torch.Generator(device=dev).manual_seed(
            subseed(run.seed, "sampling"))

        # The check: the window's own calls, state and feed.
        named = list(model.named_parameters())
        _, probs = self.val_fn(self.val_imgs, self.val_labs)
        val_probs = probs[..., 0].float().cpu()
        watch = FirstGradient(opt, named)
        out = self.epoch_fn(self.state, self.train_images, self.train_labels,
                            self.train_map, self.generator)
        watch.close()
        metrics, probs = self.val_fn(self.val_imgs, self.val_labs)
        self.got = dict(changes(named, run.state_dict), grads=watch.grads,
                        loss_sum=float(out["epoch_loss"]),
                        skipped=int(out["skipped"]), val_probs=val_probs,
                        val_dice=float(metrics["dice"]),
                        val_probs_epoch=probs[..., 0].float().cpu())
        self.step_times = []
        opt.register_step_post_hook(
            lambda *_: self.step_times.append(time.perf_counter()))

    # ------------------------------------------------------------- window
    def window(self, seconds: float, tracer):
        tr, dev = self.tr, self.run.device
        val_s, traced_val = [], []
        skipped = epochs = 0
        self.step_times.clear()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or tracer.pending():
            tracer.before(epochs)
            with torch.profiler.record_function("bench.epoch"):
                out = self.epoch_fn(self.state, self.train_images,
                                    self.train_labels, self.train_map,
                                    self.generator)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            tv = time.perf_counter()
            with torch.profiler.record_function("bench.val_pass"):
                metrics, _ = self.val_fn(self.val_imgs, self.val_labs)
                dice = float(metrics["dice"])
            (traced_val if tracer.enabled and epochs == tracer.start
             else val_s).append(time.perf_counter() - tv)
            loss = float(out["epoch_loss"])
            skipped += int(out["skipped"])
            skipped += not (math.isfinite(loss) and math.isfinite(dice))
            tracer.after(epochs)
            epochs += 1
        elapsed = time.perf_counter() - t0
        steps = epochs * tr["steps"]
        gaps = np.diff(np.asarray(self.step_times))
        self.e2e = {"train_patches_per_s": steps * tr["batch"] / elapsed,
                    "train_step_p95_ms": quantile(gaps.tolist(), 0.95) * 1e3}
        self.attempted, self.failed = steps, skipped
        n_val = self.val_imgs.shape[0]
        self.counts = {"steps": tracer.count * tr["steps"],
                       "train_patches": tracer.count * tr["steps"]
                       * tr["batch"],
                       "val_passes": tracer.count,
                       "val_patches": tracer.count * n_val}
        self.host = {"val_pass_s": val_s}

    # ------------------------------------------------------------- checks
    def release(self):
        del self.state, self.epoch_fn, self.val_fn

    def reference(self, model: torch.nn.Module) -> dict:
        """The validation pass, the check epoch and the validation pass
        again on the plain reference (``model``, holding the run's initial
        weights), under the keys of ``self.got``, with the validation
        labels."""
        tr, dev = self.tr, self.run.device
        half = tr["patch"] // 2
        named = list(model.named_parameters())
        opt = ref.RMSprop([p for _, p in named], tr["lr"], alpha=ALPHA,
                          weight_decay=tr["weight_decay"],
                          momentum=tr["momentum"])
        smap = torch.as_tensor(ref.train_sample_map(
            self.masks[self.train_idx], half), device=dev)
        pool_i = torch.as_tensor(self.images[self.train_idx], device=dev)
        pool_l = torch.as_tensor(self.labels[self.train_idx], device=dev)
        g = torch.Generator(device=dev).manual_seed(
            subseed(self.run.seed, "sampling"))
        vi = torch.as_tensor(self.images[self.val_idx], device=dev)
        vl = torch.as_tensor(self.labels[self.val_idx], device=dev)
        centers = ref.grid_centers(len(self.val_idx), vi.shape[1],
                                   vi.shape[2], half)
        val_imgs = ref.cut_patches(vi, centers, tr["patch"])
        val_labs = ref.cut_patches(vl, centers, tr["patch"])
        loss_sum = 0.0
        with ref.plain_precision():
            val_probs, _ = ref.val_pass(model, val_imgs, val_labs)
            for step in range(tr["steps"]):
                idx = torch.randint(0, smap.shape[0], (tr["batch"],),
                                    generator=g, device=dev)
                centers = smap[idx].cpu().numpy()
                loss_sum += ref.train_step(
                    model, opt, ref.cut_patches(pool_i, centers, tr["patch"]),
                    ref.cut_patches(pool_l, centers, tr["patch"]))
                if step == 0:
                    grads = {n: first_gradient(
                        {"square_avg": v, "momentum_buffer": b}, p)
                        for (n, p), v, b in zip(named, opt.v, opt.buf)}
            probs, dice = ref.val_pass(model, val_imgs, val_labs)
        return dict(changes(named, self.run.state_dict), grads=grads,
                    loss_sum=loss_sum, skipped=0, val_probs=val_probs.cpu(),
                    val_dice=dice, val_probs_epoch=probs.cpu(),
                    val_labels=val_labs[..., 0].float().cpu())

    def verify(self, ref_model, limits: dict) -> list:
        want = self.reference(ref_model)
        checks = [check(name, NUMBERS[name](self.got, want), limits[name])
                  for name in limits]
        checks.append(check("skipped_steps", float(self.got["skipped"]), 0.0))
        return checks


class FirstGradient:
    """Each leaf's gradient as RMSprop got it at the program's first
    step (``grads``; zeros while the optimizer has not stepped), read by
    a hook on the optimizer's step that :meth:`close` removes."""

    def __init__(self, opt, named):
        self.grads = {n: torch.zeros(p.shape) for n, p in named}

        def hook(*_):
            self.grads = {n: first_gradient(opt.state.get(p), p)
                          for n, p in named}
            self.handle.remove()

        self.handle = opt.register_step_post_hook(hook)

    def close(self):
        self.handle.remove()


def changes(named, start: dict) -> dict:
    """Each leaf's change from the initial weights ``start``: the change
    (``delta``, on the host) and its norm (``change``)."""
    delta = {n: (p.detach().double() - start[n].to(p.device).double())
             .float().cpu() for n, p in named}
    return {"delta": delta,
            "change": {n: float(d.double().norm()) for n, d in delta.items()}}


def first_gradient(state, param) -> torch.Tensor:
    """The gradient RMSprop got at its first step, on the host in f32,
    from its state after that step: magnitude sqrt(v / (1 - alpha)), sign
    that of the momentum buffer g / (sqrt(v) + eps); zeros where the
    optimizer holds no state for the parameter."""
    if not state:
        return torch.zeros(param.shape)
    mag = (state["square_avg"].double() / (1 - ALPHA)).sqrt()
    return (mag * torch.sign(state["momentum_buffer"].double())).float().cpu()


def moved(want: dict) -> tuple[list, list]:
    """(leaf names, whether the reference moves each leaf): its first
    gradient's norm at least GRAD_FLOOR of the median leaf's."""
    names = list(want["grads"])
    norms = [float(want["grads"][n].double().norm()) for n in names]
    med = float(np.median(norms))
    return names, [g >= GRAD_FLOOR * med for g in norms]


def grad_vec_median_gap(got: dict, want: dict) -> float:
    """The median moved leaf's norm of the first gradient's difference,
    over the larger of the leaf's reference norm and the median leaf's."""
    names, keep = moved(want)
    diff = [float((got["grads"][n].double()
                   - want["grads"][n].double()).norm()) for n in names]
    scale = [float(want["grads"][n].double().norm()) for n in names]
    return ref.median_leaf_gap(diff, [0.0] * len(names), keep=keep,
                               scale=scale)


def change_gap(got: dict, want: dict) -> float:
    """The worst moved leaf's gap of change norms over the epoch."""
    names, keep = moved(want)
    return ref.worst_leaf_gap([got["change"][n] for n in names],
                              [want["change"][n] for n in names], keep=keep)


def val_dice_of_probs_gap(got: dict, want: dict) -> float:
    """The gap between the Dice the second validation pass returned and
    the reference's Dice of that pass's own probabilities (kernel 2's
    sums)."""
    return abs(got["val_dice"] - float(ref.hard_dice(
        (got["val_probs_epoch"] > 0.5).float(), want["val_labels"]).mean()))


# The numbers the check can compare; the cell's limits name those
# compared.  ``loss_gap``: the relative gap of the epoch's summed loss;
# ``val_mean_gap``: the mean gap of a probability of the first validation
# pass.
NUMBERS = {
    "loss_gap": lambda got, want: abs(got["loss_sum"] - want["loss_sum"])
    / abs(want["loss_sum"]),
    "grad_vec_median_gap": grad_vec_median_gap,
    "change_gap": change_gap,
    "val_mean_gap": lambda got, want: float(
        (got["val_probs"] - want["val_probs"]).abs().double().mean()),
    "val_dice_of_probs_gap": val_dice_of_probs_gap,
}

FAULTS = faults.TRAIN
Driver = TrainEpochs
