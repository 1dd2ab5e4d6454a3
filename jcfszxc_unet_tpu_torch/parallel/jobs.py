"""Work that :func:`parallel.spawn` runs in every rank of a job and that
also runs in one process (``world`` None), so that a caller can hold the
ranks' results against the single process's on the same inputs.

Each job takes plain inputs (numpy arrays, a state dict of numpy arrays
or a seed) and returns plain outputs (floats, numpy arrays), plus the
kernels' launches during the job (``"launches"``, read from the
wrappers' counters, which :func:`run` zeroes first).  :func:`run` is the
child entry point: it runs a list of ``(job name, keyword arguments)``
in order in one process group, so a caller pays one spawn for several
checks.  In a job each rank runs on its ``world.device``; in one process
a job runs on ``device``, the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import hashlib
import inspect
import os
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from jcfszxc_unet_tpu_torch.parallel.mesh import (
    World,
    average_gradients,
    global_batch_norm,
    make_2d_mesh,
    make_mesh,
    mean_over_ranks,
    shard_rows,
)
from jcfszxc_unet_tpu_torch.utils.device import resolve_device


def _device(world: Optional[World], device) -> torch.device:
    return world.device if world is not None else resolve_device(device)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def launch_counts() -> dict:
    """The three kernels' launches since the counters were last reset."""
    from jcfszxc_unet_tpu_torch.ops.kernels import (
        conv_fused,
        conv_imcol,
        dice_fused,
    )

    return {"conv3x3_affine_relu": conv_fused.counter.launches,
            "dice_sums": dice_fused.counter.launches,
            "conv3x3_relu_imcol": conv_imcol.counter.launches}


def reset_counts() -> None:
    from jcfszxc_unet_tpu_torch.ops.kernels import (
        conv_fused,
        conv_imcol,
        dice_fused,
    )

    for kernel in (conv_fused, dice_fused, conv_imcol):
        kernel.counter.reset()


def state_digest(model: nn.Module) -> str:
    """sha256 of the state dict's bytes in key order: equal digests are
    bit-identical parameters and buffers."""
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def numpy_state(model: nn.Module) -> dict:
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def build_model(name: str, dev: torch.device, *, state_dict=None,
                seed: int = 0, model_kwargs=None,
                silence_dropout: bool = True) -> nn.Module:
    """Model ``name`` on ``dev``, channels_last, in train mode: with
    ``state_dict`` (numpy arrays, or the path of an ``.npz`` of them, which
    keeps a large model's weights out of the ranks' pickled arguments;
    loaded strict), else torch's default initialisation drawn from
    ``seed``.  ``silence_dropout`` puts the dropout modules in eval mode
    (the identity), so that ranks and the single process see the same
    forward."""
    from jcfszxc_unet_tpu_torch.models import create_model
    from jcfszxc_unet_tpu_torch.ops.layers import reset_parameters

    model = create_model(name, **(model_kwargs or {}))
    if isinstance(state_dict, (str, os.PathLike)):
        with np.load(state_dict) as f:
            state_dict = dict(f)
    if state_dict is None:
        reset_parameters(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict({k: torch.tensor(np.asarray(v))
                               for k, v in state_dict.items()}, strict=True)
    model = model.to(device=dev, memory_format=torch.channels_last).train()
    if silence_dropout:
        for m in model.modules():
            if isinstance(m, (nn.Dropout, nn.Dropout2d)):
                m.eval()
    return model


def train_steps(world: Optional[World], model_name: str, batches, *,
                lr: float, state_dict=None, seed: int = 0,
                model_kwargs=None, compute_dtype=torch.float32,
                remat: bool = False, return_state: bool = True,
                device="cuda") -> dict:
    """``make_batch_step_fn`` on the explicit global batches ``batches``
    (a list of (images (B, P, P, C), labels (B, P, P, 1)) numpy pairs),
    clipped RMSprop at ``lr``.  Returns the per-step losses and ok flags,
    the host ms of each step (to a device sync), the BN running statistics
    after the first step (taken from the starting parameters, so they
    differ between runs by the forward's summation order alone), the
    digest of the final state and, with ``return_state``, the state
    itself."""
    from jcfszxc_unet_tpu_torch.train.optim import make_optimizer
    from jcfszxc_unet_tpu_torch.train.state import TrainState
    from jcfszxc_unet_tpu_torch.train.trainer import make_batch_step_fn

    dev = _device(world, device)
    model = build_model(model_name, dev, state_dict=state_dict, seed=seed,
                        model_kwargs=model_kwargs)
    state = TrainState(model, make_optimizer(model.parameters(), lr))
    step = make_batch_step_fn(n_classes=model.n_classes,
                              compute_dtype=compute_dtype, remat=remat,
                              world=world)
    losses, oks, ms = [], [], []
    for imgs, labs in batches:
        x = torch.tensor(np.asarray(imgs, np.float32), device=dev)
        y = torch.tensor(np.asarray(labs, np.float32), device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        loss, ok = step(state, x, y)
        loss = float(loss)  # syncs
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        oks.append(bool(ok))
        if len(losses) == 1:
            first_stats = {k: v for k, v in numpy_state(model).items()
                           if "running" in k}
    out = {"losses": losses, "oks": oks, "step_ms": ms,
           "first_stats": first_stats, "digest": state_digest(model),
           "step": state.step}
    if return_state:
        out["state"] = numpy_state(model)
    return out


def batch_norm_grads(world: Optional[World], x2d, x1d, gy2d, gy1d, gys2d,
                     *, seed: int = 0, device="cuda") -> dict:
    """One train-mode forward and backward of ``ops.layers.BatchNorm2d``
    (plain and ``.s2d``) on ``x2d`` (B, C, H, W; its s2d form is the same
    tensor read as (B, C/4 channels x 4 phases)) and of ``BatchNorm1d`` on
    ``x1d`` (B, C), with the upstream gradients ``gy*``, all global arrays
    of which this rank takes its rows.  Returns this rank's outputs and
    input gradients, the running statistics, and the parameters'
    gradients of this rank's rows."""
    from jcfszxc_unet_tpu_torch.ops.layers import BatchNorm1d, BatchNorm2d

    dev = _device(world, device)
    g = torch.Generator().manual_seed(seed)
    c2, c1 = x2d.shape[1], x1d.shape[1]
    bns = {"2d": BatchNorm2d(c2), "s2d": BatchNorm2d(c2 // 4),
           "1d": BatchNorm1d(c1)}
    for bn in bns.values():
        with torch.no_grad():
            bn.weight.copy_(0.5 + torch.rand(bn.num_features, generator=g))
            bn.bias.copy_(0.2 * torch.randn(bn.num_features, generator=g))
        bn.to(dev).train()
    out = {}
    for name, x, gy in (("2d", x2d, gy2d), ("s2d", x2d, gys2d),
                        ("1d", x1d, gy1d)):
        bn = bns[name]
        xt = shard_rows(torch.tensor(np.asarray(x), device=dev), world)
        if xt.dim() == 4:
            xt = xt.contiguous(memory_format=torch.channels_last)
        xt.requires_grad_(True)
        with global_batch_norm(bn, world):
            y = bn.s2d(xt) if name == "s2d" else bn(xt)
            gyt = shard_rows(torch.tensor(np.asarray(gy), device=dev),
                             world)
            (y * gyt).sum().backward()
        out[name] = {
            "y": y.detach().cpu().numpy(), "gx": xt.grad.cpu().numpy(),
            "running_mean": bn.running_mean.cpu().numpy(),
            "running_var": bn.running_var.cpu().numpy(),
            "gweight": bn.weight.grad.cpu().numpy(),
            "gbias": bn.bias.grad.cpu().numpy()}
    return out


def dice_grads(world: Optional[World], logits, target, *,
               device="cuda") -> dict:
    """``combined_loss`` of ``logits * w`` against ``target`` (global NHWC
    arrays, this rank's rows), w a one-element parameter at 1: the
    reported loss (the mean over ranks), w's gradient averaged over the
    ranks, and this rank's gradient of its logits before any averaging."""
    from jcfszxc_unet_tpu_torch.train.losses import combined_loss

    dev = _device(world, device)
    z = shard_rows(torch.tensor(np.asarray(logits), device=dev), world)
    t = shard_rows(torch.tensor(np.asarray(target), device=dev), world)
    z.requires_grad_(True)
    w = nn.Parameter(torch.ones(1, device=dev))
    loss, _, _ = combined_loss(z * w, t, world=world)
    loss.backward()
    average_gradients([w], world)
    return {"loss": float(mean_over_ranks(loss.detach(), world)),
            "grad_w": w.grad.cpu().numpy(), "grad_z": z.grad.cpu().numpy()}


def validation(world: Optional[World], model_name: str, val_imgs, val_labs,
               *, state_dict=None, seed: int = 0, chunk_size: int = 64,
               compute_dtype=torch.float32, device="cuda") -> dict:
    """``make_val_fn`` on (V, P, P, C) patches: the four Dice scores and
    the (V, P, P, 1) probabilities (every rank holds them all)."""
    from jcfszxc_unet_tpu_torch.train.trainer import make_val_fn

    dev = _device(world, device)
    model = build_model(model_name, dev, state_dict=state_dict, seed=seed)
    metrics, probs = make_val_fn(model, chunk_size=chunk_size,
                                 compute_dtype=compute_dtype, world=world)(
        torch.tensor(np.asarray(val_imgs, np.float32), device=dev),
        torch.tensor(np.asarray(val_labs, np.float32), device=dev))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "probs": probs.cpu().numpy()}


def precise_batch_norm(world: Optional[World], model_name: str, batches, *,
                       state_dict=None, seed: int = 0,
                       compute_dtype=torch.float32, device="cuda") -> dict:
    """``trainer.precise_bn`` over the global image batches ``batches``:
    the recalibrated running statistics."""
    from jcfszxc_unet_tpu_torch.train.trainer import precise_bn

    dev = _device(world, device)
    model = build_model(model_name, dev, state_dict=state_dict, seed=seed)
    precise_bn(model, (torch.tensor(np.asarray(b, np.float32), device=dev)
                       for b in batches), compute_dtype, world)
    return {"state": {k: v for k, v in numpy_state(model).items()
                      if "running" in k}}


def tiled_maps(world: Optional[World], model_name: str, images, *,
               patch_size: int, batch_size: int, state_dict=None,
               seed: int = 0, model_kwargs=None, compute_dtype=torch.float32,
               tta: bool = False, device="cuda") -> dict:
    """``Predictor.predict_images`` (tiled, stitched) of (N, H, W, C)
    images: the (N, H, W) maps, on every rank, and the host ms of the
    call (to a device sync)."""
    from jcfszxc_unet_tpu_torch.eval.predictor import Predictor

    dev = _device(world, device)
    model = build_model(model_name, dev, state_dict=state_dict, seed=seed,
                        model_kwargs=model_kwargs)
    predictor = Predictor(model, compute_dtype=compute_dtype,
                          patch_size=patch_size,
                          inference_batch_size=batch_size, device=dev,
                          tta=tta, world=world)
    x = torch.tensor(np.asarray(images, np.float32), device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    maps = predictor.predict_images(x)
    _sync(dev)
    return {"maps": maps.cpu().numpy(),
            "ms": (time.perf_counter() - t0) * 1e3}


def _timed_spatial(fn, dev: torch.device, repeats: int):
    """``fn()`` ``repeats`` times: (the last result, the host ms of each
    call to a device sync, the collectives of the last call
    (``parallel.spatial.counter``: calls, bytes, host ms), and on a card
    the bytes allocated before the last call and its peak)."""
    from jcfszxc_unet_tpu_torch.parallel import spatial

    ms, start = [], None
    for _ in range(repeats):
        _sync(dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
            start = torch.cuda.memory_allocated(dev)
        spatial.counter.reset()
        t0 = time.perf_counter()
        out = fn()
        _sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return out, {"ms": ms, "collectives": spatial.counter.snapshot(),
                 "start_bytes": start,
                 "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                                if dev.type == "cuda" else None)}


def spatial_maps(world: Optional[World], model_name: str, images, *,
                 divisor: int = 32, batch_size: int = 32, state_dict=None,
                 seed: int = 0, model_kwargs=None,
                 compute_dtype=torch.float32, repeats: int = 1,
                 device="cuda") -> dict:
    """``Predictor.predict_spatial`` (the whole-image forward, the rows
    sharded over the world's ranks) of (N, H, W, C) images, ``repeats``
    times: the (N, H, W) maps of the last call, on every rank, with
    :func:`_timed_spatial`'s ms, collectives and peak bytes."""
    from jcfszxc_unet_tpu_torch.eval.predictor import Predictor

    dev = _device(world, device)
    model = build_model(model_name, dev, state_dict=state_dict, seed=seed,
                        model_kwargs=model_kwargs)
    predictor = Predictor(model, compute_dtype=compute_dtype,
                          inference_batch_size=batch_size, device=dev,
                          world=world)
    x = torch.tensor(np.asarray(images, np.float32), device=dev)
    maps, out = _timed_spatial(lambda: predictor.predict_spatial(x, divisor),
                               dev, repeats)
    return {"maps": maps.cpu().numpy(), **out}


def spatial_eval(world: Optional[World], model_name: str, images, masks,
                 labels, *, batch_size: int = 32, state_dict=None,
                 seed: int = 0, model_kwargs=None,
                 compute_dtype=torch.float32, repeats: int = 1,
                 device="cuda") -> dict:
    """``cli.evaluate.evaluate_arrays(spatial=True)`` (the eval CLI's
    ``--spatial``, over the world's ranks with ``--devices N``) of
    (N, H, W, C) images, ``repeats`` times: rank 0's result of the last
    call ("result": Dice, AUC, the FOV-masked maps; {} on the other
    ranks), with :func:`_timed_spatial`'s ms, collectives and peak
    bytes."""
    from jcfszxc_unet_tpu_torch.cli.evaluate import evaluate_arrays

    dev = _device(world, device)
    model = build_model(model_name, dev, state_dict=state_dict, seed=seed,
                        model_kwargs=model_kwargs)
    res, out = _timed_spatial(lambda: evaluate_arrays(
        model, images, masks, labels, inference_batch_size=batch_size,
        compute_dtype=compute_dtype, spatial=True, device=dev, world=world),
        dev, repeats)
    return {"result": res, **out}


def _spatial_op(name: str, c: int, dev: torch.device, g: torch.Generator):
    """Op ``name`` of :func:`spatial_ops` on NCHW maps of ``c`` channels
    on ``dev``, its parameters drawn from ``g``: (fn, the axis of its
    output that holds the map's rows, or None when the output is
    global)."""
    from jcfszxc_unet_tpu_torch.ops import blocks, layers, s2d
    from jcfszxc_unet_tpu_torch.parallel import spatial

    def module(m):
        layers.reset_parameters(m, g)
        return m.to(dev).eval()

    if name == "conv3x3_fused":
        w = torch.randn((c, 3, 3, c), generator=g) / (3 * c ** 0.5)
        scale = 0.5 + torch.rand(c, generator=g)
        w, scale, shift = (t.to(dev) for t in (w, scale,
                                               torch.randn(c, generator=g)))
        return (lambda x: blocks.conv3x3_folded(x, w, scale, shift, True)), 2
    convs = {
        "conv7x7": lambda: layers.Conv2d(c, 2, 7, padding=3),
        "conv_dilated": lambda: layers.Conv2d(c, c, 3, padding=2,
                                              dilation=2),
        "conv_stride2": lambda: layers.Conv2d(c, c, 3, stride=2, padding=1),
        "conv_k2s2": lambda: layers.Conv2d(c, c, 2, stride=2),
        "convT_k3s2": lambda: layers.ConvTranspose2d(
            c, c, 3, stride=2, padding=1, output_padding=1),
        "convT_k4s2": lambda: layers.ConvTranspose2d(c, c, 4, stride=2,
                                                     padding=1),
        "convT_k2s2": lambda: layers.ConvTranspose2d(c, c, 2, stride=2),
    }
    if name in convs:
        return module(convs[name]()), 2
    if name == "conv_s2d":
        conv = module(layers.Conv2d(c, c, 3, padding=1))
        return (lambda x: s2d.depth_to_space(
            conv.s2d(s2d.space_to_depth(x)))), 2
    if name == "se_block":
        return module(blocks.SEBlock(c)), 2
    if name == "attention":
        mha = module(blocks.MultiHeadSelfAttention(c, 4))

        def attend(x):
            b, _, h, w = x.shape
            return mha(x.permute(0, 2, 3, 1).reshape(b, h * w, c))
        return attend, 1
    ops = {
        "avg_pool": (lambda x: layers.avg_pool2d(x, 3, 1, 1), 2),
        "bilinear": (layers.upsample_bilinear, 2),
        "bilinear_s2d": (lambda x: s2d.depth_to_space(
            s2d.upsample_bilinear_s2d(x)), 2),
        "avg_pool_1x1": (layers.adaptive_avg_pool_1x1, None),
        "max_pool_1x1": (layers.adaptive_max_pool_1x1, None),
        "crop": (lambda x: layers.pad_or_crop_to(
            layers.upsample_nearest(x), x.shape[2], x.shape[3]), 2),
        "pad": (lambda x: layers.pad_or_crop_to(
            x, 2 * x.shape[2], 2 * x.shape[3]), 2),
        "halo3": (lambda x: spatial.halo_slab(x, 3, 3), None),
    }
    return ops[name]


def spatial_ops(world: Optional[World], cases, *, seed: int = 0,
                device="cuda") -> dict:
    """Each of ``cases``, (op name, NCHW numpy map), on this rank's rows
    (``row_bounds`` of the map's H) under ``parallel.spatial.row_sharded``,
    or on the whole map without a world: the op's output with its rows
    gathered on every rank ("outs", in order; a global output as it is,
    ``halo3``'s slab as this rank's).  Each op draws its parameters from
    ``seed``, the same on every rank and in one process."""
    from jcfszxc_unet_tpu_torch.parallel import spatial
    from jcfszxc_unet_tpu_torch.parallel.mesh import row_bounds

    dev = _device(world, device)
    outs = []
    with torch.inference_mode():
        for name, x in cases:
            x = torch.tensor(np.asarray(x, np.float32), device=dev)
            fn, rows = _spatial_op(name, x.shape[1], dev,
                                   torch.Generator().manual_seed(seed))
            h = x.shape[2]
            start, stop = row_bounds(h, world)
            x = x[:, :, start:stop].contiguous(
                memory_format=torch.channels_last)
            with spatial.row_sharded(world, h):
                y = fn(x)
                if rows is not None:
                    y = spatial.gather_h(y, rows)
            outs.append(y.cpu().numpy())
    return {"outs": outs}


def train_run(world: Optional[World], model_name: str, images, masks,
              labels, *, save_path: str, val_percent: float,
              patch_size: int, compute_dtype, state_dict=None,
              seed: int = 0, data_seed: int = 42, model_kwargs=None,
              device="cuda", **kwargs) -> dict:
    """``cli.train.train_arrays`` (the epoch loop: steps, validation,
    scheduler, checkpoints) on arrays, seeded with ``data_seed``;
    ``kwargs`` are its own.  Returns its history, the paths this process
    wrote, the digest of the trained state, and of its last validation
    pass: the gathered probabilities' digest (equal digests are
    bit-identical probabilities), their range, and their max |difference|
    from ``make_val_fn`` in one process (no world) with the trained
    weights on the same validation patches, in chunks of the ranks'
    size, so that every forward sees the shapes the ranks' did.  Its
    ``"launches"`` are those of ``train_arrays`` alone, not of that
    check."""
    from jcfszxc_unet_tpu_torch.cli.train import (
        train_arrays,
        validation_patches,
    )
    from jcfszxc_unet_tpu_torch.train.trainer import (
        make_val_fn,
        split_indices,
    )

    dev = _device(world, device)
    model = build_model(model_name, dev, state_dict=state_dict, seed=seed,
                        model_kwargs=model_kwargs, silence_dropout=False)
    res = train_arrays(model, images, masks, labels, model_name=model_name,
                       model_kwargs=model_kwargs, save_path=save_path,
                       val_percent=val_percent, patch_size=patch_size,
                       compute_dtype=compute_dtype, seed=data_seed,
                       device=dev, world=world, **kwargs)
    _sync(dev)
    launches = launch_counts()
    np.random.seed(data_seed)  # train_arrays's split, drawn after its seed
    val_idx, _ = split_indices(len(images), val_percent)
    val_imgs, val_labs = validation_patches(
        np.asarray(images, np.float32),
        np.asarray(labels, np.float32)[..., None], val_idx, patch_size, dev)
    chunk = inspect.signature(make_val_fn).parameters["chunk_size"].default
    _, want = make_val_fn(
        model, chunk_size=max(chunk // (world.size if world else 1), 1),
        compute_dtype=compute_dtype)(val_imgs, val_labs)
    got = res["val_probs"]
    return {"history": res["history"], "saved": res["saved"],
            "best_dice": res["best_dice"], "digest": state_digest(model),
            "val_digest": hashlib.sha256(
                got.cpu().numpy().tobytes()).hexdigest(),
            "val_range": (float(got.min()), float(got.max())),
            "val_max_abs_dprob": float((got - want).abs().max()),
            "launches": launches}


def meshes(world: World) -> dict:
    """The sizes and axis names of ``make_mesh`` and ``make_2d_mesh``
    over the job."""
    kind = world.device.type
    mesh = make_mesh(device_type=kind)
    mesh2 = make_2d_mesh(world.size, 1, device_type=kind)
    return {"size": mesh.size(), "names": mesh.mesh_dim_names,
            "shape_2d": tuple(mesh2.shape), "names_2d": mesh2.mesh_dim_names}


def configure(world: Optional[World], tf32: bool) -> dict:
    """Set this process's TF32 switches (matmul and cuDNN), which a
    spawned rank does not inherit from its parent."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    return {}


def stall(world: World, rank: int, seconds: float) -> dict:
    """A check of the launcher: rank ``rank`` sleeps ``seconds`` while the
    others wait in an all-reduce it never joins, so the group's timeout
    must end the job."""
    import torch.distributed as dist

    if world.rank == rank:
        time.sleep(seconds)
    else:
        dist.all_reduce(torch.zeros(1, device=world.device))
    return {}


JOBS = {f.__name__: f for f in (train_steps, batch_norm_grads, dice_grads,
                                validation, precise_batch_norm, tiled_maps,
                                spatial_maps, spatial_eval, spatial_ops,
                                train_run, meshes, configure, stall)}


def run(world: Optional[World], tasks, device="cuda") -> list:
    """Run ``tasks``, a list of (job name, keyword arguments), in order;
    returns their results, each with ``"launches"``, the kernels'
    launches during that job on this rank (unless the job reports its
    own).  Without a world the jobs run on ``device`` (a task's own
    ``device`` wins)."""
    dev = _device(world, device)
    results = []
    for name, kwargs in tasks:
        fn = JOBS[name]
        if world is None and "device" in inspect.signature(fn).parameters:
            kwargs = {"device": dev, **kwargs}
        reset_counts()
        out = fn(world, **kwargs)
        _sync(dev)
        out.setdefault("launches", launch_counts())
        results.append(out)
    return results
