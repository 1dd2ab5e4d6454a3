#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (sm_90a, i.e. an H100).

    python3 chip_smoke.py

Phases, each of which must pass:

1. build the CUDA kernels from ``jcfszxc_unet_tpu_torch/csrc`` (nvcc, ctypes);
2. main path: full-width UNet (64 -> 1024 channels, random weights from a
   seed, BatchNorm statistics calibrated on a batch and then perturbed)
   evaluates 4 synthetic DRIVE-geometry images (584 x 565, 16 patches of
   512^2) through the tiled protocol in bf16, inference batch 32, to
   per-image Dice and AUC; the kernels' launch counts are read around it;
3. f32 end to end (TF32 off): the port's forward on one image's patches
   against a forward built only from the kernels' plain versions;
4. each kernel against its plain version at the main path's shapes, and
   its time beside the plain version's, a library call's and its bound.

Prints the kernels line, the GPU's name and power limit, and as the last
line ``{"ok": true, "device": {...}}``; exits non-zero, printing no result,
when a phase fails or no GPU is available.  Details go to
``chiprun_out/chip_smoke/report.json``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")

# NVIDIA H100 SXM data sheet, dense rates (at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12      # tensor cores
F32_FLOPS = 67e12        # CUDA cores, no tensor cores

N_IMAGES, IMG_H, IMG_W = 4, 584, 565
PATCH = 512
INFER_BATCH = 32

# (spatial size, Cin, Cout) of UNet's 18 3x3 convs in forward order.
UNET_CONVS = [
    (512, 3, 64), (512, 64, 64),           # inc
    (256, 64, 128), (256, 128, 128),       # down1
    (128, 128, 256), (128, 256, 256),      # down2
    (64, 256, 512), (64, 512, 512),        # down3
    (32, 512, 1024), (32, 1024, 1024),     # down4
    (64, 1024, 512), (64, 512, 512),       # up1
    (128, 512, 256), (128, 256, 256),      # up2
    (256, 256, 128), (256, 128, 128),      # up3
    (512, 128, 64), (512, 64, 64),         # up4
]


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def synthetic_drive(n, h, w, seed):
    """DRIVE-geometry images in [0, 1] with a circular FOV mask and
    random-walk vessel labels that darken the green channel."""
    import numpy as np

    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    fov = ((yy - h / 2) ** 2 + (xx - w / 2) ** 2
           <= (0.47 * min(h, w)) ** 2).astype(np.float32)
    images = np.empty((n, h, w, 3), np.float32)
    labels = np.zeros((n, h, w), np.float32)
    for i in range(n):
        for _ in range(12):  # vessel branches
            steps = rng.randint(-2, 3, size=(4000, 2)).cumsum(axis=0)
            pts = steps + [rng.randint(h), rng.randint(w)]
            ys = np.clip(pts[:, 0], 0, h - 2)
            xs = np.clip(pts[:, 1], 0, w - 2)
            for dy in (0, 1):
                for dx in (0, 1):
                    labels[i, ys + dy, xs + dx] = 1.0
        labels[i] *= fov
        base = 0.35 + 0.25 * rng.rand(h, w, 3).astype(np.float32)
        base[..., 1] -= 0.25 * labels[i]
        images[i] = np.clip(base * fov[..., None], 0.0, 1.0)
    masks = np.repeat(fov[None], n, axis=0)
    return images, masks, labels


def build_model(device, seed):
    """Full-width UNet from a seeded generator; each BatchNorm's running
    statistics are measured on one batch (so activations keep their
    scale through 18 layers) and then perturbed, with gamma and beta
    drawn at random, so the eval-mode fold has work to do."""
    import torch

    from jcfszxc_unet_tpu_torch.models import create_model
    from jcfszxc_unet_tpu_torch.ops.layers import BatchNorm2d, reset_parameters

    g = torch.Generator().manual_seed(seed)
    model = create_model("UNet.UNet")
    reset_parameters(model, g)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    with torch.no_grad():
        for bn in bns:
            bn.weight.copy_(0.5 + torch.rand(bn.num_features, generator=g))
            bn.bias.copy_(0.2 * torch.randn(bn.num_features, generator=g))
    model = model.to(device=device, memory_format=torch.channels_last)
    calib = torch.rand((2, 3, PATCH, PATCH), generator=g).to(
        device=device, memory_format=torch.channels_last)
    for bn in bns:
        bn.momentum = 1.0  # running stats := this batch's statistics
    model.train()
    with torch.no_grad():
        model(calib)
    with torch.no_grad():
        for bn in bns:
            bn.momentum = 0.1
            c = bn.num_features
            bn.running_mean.add_(
                (0.1 * torch.randn(c, generator=g)).to(device)
                * bn.running_var.sqrt())
            bn.running_var.mul_((0.8 + 0.4 * torch.rand(c, generator=g))
                                .to(device))
    return model.eval()


def plain_unet_forward(model, x):
    """UNet eval forward built only from the kernels' plain versions and
    stock torch ops.  x: NCHW; returns logits."""
    import torch
    import torch.nn.functional as F

    from jcfszxc_unet_tpu_torch.ops.kernels.conv_fused import (
        conv3x3_affine_relu_torch,
    )
    from jcfszxc_unet_tpu_torch.ops.layers import pad_or_crop_to

    def double_conv(block, x):
        seq = block.double_conv
        for conv, bn in ((seq[0], seq[1]), (seq[3], seq[4])):
            scale, shift = bn.folded()
            w = conv.weight.to(x.dtype).permute(2, 3, 1, 0)
            x = conv3x3_affine_relu_torch(
                x.permute(0, 2, 3, 1), w, scale, shift).permute(0, 3, 1, 2)
        return x

    def up(block, x1, x2):
        t = block.up
        x1 = F.conv_transpose2d(x1, t.weight.to(x1.dtype),
                                t.bias.to(x1.dtype), stride=2)
        x1 = pad_or_crop_to(x1, x2.shape[2], x2.shape[3])
        return double_conv(block.conv, torch.cat([x2, x1], dim=1))

    x1 = double_conv(model.inc, x)
    x2 = double_conv(model.down1.maxpool_conv[1], F.max_pool2d(x1, 2))
    x3 = double_conv(model.down2.maxpool_conv[1], F.max_pool2d(x2, 2))
    x4 = double_conv(model.down3.maxpool_conv[1], F.max_pool2d(x3, 2))
    x5 = double_conv(model.down4.maxpool_conv[1], F.max_pool2d(x4, 2))
    y = up(model.up4, up(model.up3, up(model.up2, up(model.up1, x5, x4),
                                         x3), x2), x1)
    oc = model.outc.conv
    return F.conv2d(y, oc.weight.to(y.dtype), oc.bias.to(y.dtype))


def time_ms(fn, target_ms: float = 40.0, max_reps: int = 50):
    """Mean device time of ``fn`` by CUDA events over back-to-back calls,
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    first = (time.perf_counter() - t0) * 1e3
    reps = int(min(max_reps, max(3, math.ceil(target_ms / max(first, 1e-3)))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def conv_cost(b, hw, cin, cout, itemsize):
    """(flops, bytes) of one fused conv: 2*M*N*K multiply-adds plus the
    3-op epilogue; x, w, scale, shift read once, out written once."""
    m = b * hw * hw
    flops = 2 * m * cout * 9 * cin + 3 * m * cout
    nbytes = (m * cin + 9 * cin * cout + m * cout) * itemsize + 2 * cout * 4
    return flops, nbytes


def bound_ms(flops, nbytes, peak_flops):
    return max(nbytes / HBM_BYTES_PER_S, flops / peak_flops) * 1e3


def phase_build(report):
    from jcfszxc_unet_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    build.load_library()
    dt = time.perf_counter() - t0
    report["build"] = {"seconds": dt, "cached": build.build_info["cached"],
                       "path": build.build_info["path"]}
    if "ptxas" in build.build_info:
        with open(os.path.join(OUT_DIR, "ptxas.log"), "w") as f:
            f.write(build.build_info["ptxas"])
    print(f"[build] kernels ready in {dt:.1f} s "
          f"(cached={build.build_info['cached']})", flush=True)


def phase_main_path(report, state):
    import numpy as np
    import torch

    from jcfszxc_unet_tpu_torch.cli.evaluate import evaluate_arrays
    from jcfszxc_unet_tpu_torch.ops.kernels import conv_fused, dice_fused

    dev = torch.device("cuda")
    model = build_model(dev, seed=0)
    images, masks, labels = synthetic_drive(N_IMAGES, IMG_H, IMG_W, seed=0)
    state.update(model=model, images=images)
    n_patches = len(range(PATCH // 2, IMG_H, PATCH // 2)) * len(
        range(PATCH // 2, IMG_W, PATCH // 2)) * N_IMAGES
    n_chunks = math.ceil(n_patches / min(INFER_BATCH, n_patches))

    def run():
        return evaluate_arrays(
            model, images, masks, labels, patch_size=PATCH,
            inference_batch_size=INFER_BATCH, compute_dtype=torch.bfloat16,
            device=dev)

    torch.cuda.synchronize()
    conv_fused.counter.reset()
    dice_fused.counter.reset()
    res = run()
    torch.cuda.synchronize()
    launches = {"conv3x3_affine_relu": conv_fused.counter.launches,
                "dice_sums": dice_fused.counter.launches}
    state["launches"] = launches
    pm = res["pred_maps"]
    checks = {
        "pred_shape": pm.shape == (N_IMAGES, IMG_H, IMG_W),
        "pred_finite_in_0_1": bool(np.isfinite(pm).all()
                                   and pm.min() >= 0 and pm.max() <= 1),
        "dice_finite": all(np.isfinite(d) and 0 <= d <= 1
                           for d in res["dice"]),
        "auc_finite": all(np.isfinite(a) and 0 <= a <= 1 for a in res["auc"]),
        "conv_launches_18_per_chunk":
            launches["conv3x3_affine_relu"] == 18 * n_chunks,
        "dice_launched": launches["dice_sums"] >= 1,
    }
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    report["main_path"] = {
        "n_images": N_IMAGES, "image_hw": [IMG_H, IMG_W], "patch": PATCH,
        "n_patches": n_patches, "n_chunks": n_chunks, "dtype": "bfloat16",
        "launches": launches, "dice": res["dice"], "auc": res["auc"],
        "prob_mean": float(pm.mean()), "prob_std": float(pm.std()),
        "eval_seconds": dt, "images_per_s": N_IMAGES / dt, "checks": checks,
    }
    print(f"[main] {n_patches} patches in {n_chunks} chunk(s); launches "
          f"{launches}; dice {[round(d, 4) for d in res['dice']]}; "
          f"auc {[round(a, 4) for a in res['auc']]}", flush=True)
    print(f"[main] eval of {N_IMAGES} images: {dt:.3f} s = "
          f"{N_IMAGES / dt:.2f} images/s", flush=True)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"main-path checks failed: {bad}")
    profile_eval(report, run)


def device_rows(fn, reps: int = 1):
    """Device-side events (kernels and copies) of ``reps`` calls of ``fn``
    under torch.profiler: [{"name", "count", "device_ms"}] per call,
    largest first.  Host-side operator rows are left out, since their
    device time repeats that of the kernels they launched."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [{"name": ev.key[:120], "count": ev.count / reps,
             "device_ms": ev.self_device_time_total / 1e3 / reps}
            for ev in prof.key_averages()
            if ev.device_type == DeviceType.CUDA
            and ev.self_device_time_total > 0]
    return sorted(rows, key=lambda r: -r["device_ms"])


def profile_eval(report, run):
    """Device time by kernel over one evaluation, and the device's idle
    share against the untraced evaluation's wall time."""
    rows = device_rows(run)
    total = sum(r["device_ms"] for r in rows)
    wall_ms = report["main_path"]["eval_seconds"] * 1e3
    idle = max(0.0, 1.0 - total / wall_ms)
    report["profile"] = {"device_ms_total": total, "untraced_wall_ms": wall_ms,
                         "device_idle_share": idle, "top": rows[:25]}
    print(f"[profile] device busy {total:.2f} ms in one evaluation "
          f"(untraced wall {wall_ms:.1f} ms, idle share {idle:.3f}); top:",
          flush=True)
    for r in rows[:8]:
        print(f"    {r['device_ms']:9.3f} ms  x{r['count']:<4g} {r['name']}",
              flush=True)


def phase_f32_end_to_end(report, state):
    import numpy as np
    import torch

    from jcfszxc_unet_tpu_torch.data.sampler import (
        build_grid_sample_map,
        extract_patches,
    )
    from jcfszxc_unet_tpu_torch.eval.predictor import Predictor

    model = state["model"]
    img = torch.as_tensor(state["images"][:1], device="cuda")
    centers = build_grid_sample_map(1, IMG_H, IMG_W, PATCH // 2)
    patches = extract_patches(img, centers, PATCH)
    pred = Predictor(model, compute_dtype=torch.float32, patch_size=PATCH,
                     device="cuda")
    got = pred.predict_patches(patches)[..., 0]
    with torch.inference_mode():
        logits = plain_unet_forward(model, patches.permute(0, 3, 1, 2))
        want = torch.sigmoid(logits.float())[:, 0]
    diff = float((got - want).abs().max())
    report["f32_end_to_end"] = {"n_patches": int(patches.shape[0]),
                                "max_abs_dprob": diff, "tolerance": 1e-3,
                                "prob_std": float(want.std())}
    print(f"[f32] port vs plain forward on {patches.shape[0]} patches: "
          f"max |dprob| = {diff:.3e} (tolerance 1e-3)", flush=True)
    if not np.isfinite(diff) or diff > 1e-3:
        raise AssertionError(f"f32 end-to-end max |dprob| {diff} > 1e-3")


def phase_kernels(report, state):
    import torch
    import torch.nn.functional as F

    from jcfszxc_unet_tpu_torch.ops.kernels.conv_fused import (
        conv3x3_affine_relu,
        conv3x3_affine_relu_torch,
    )
    from jcfszxc_unet_tpu_torch.ops.kernels.dice_fused import (
        dice_sums,
        dice_sums_torch,
    )

    g = torch.Generator(device="cuda").manual_seed(1)
    dev = "cuda"

    def conv_inputs(b, h, w, cin, cout, dtype):
        x = torch.randn((b, h, w, cin), generator=g, device=dev).to(dtype)
        w = (torch.randn((3, 3, cin, cout), generator=g, device=dev)
             / math.sqrt(9 * cin)).to(dtype)
        scale = 0.5 + torch.rand((cout,), generator=g, device=dev)
        shift = 0.1 * torch.randn((cout,), generator=g, device=dev)
        return x, w, scale, shift

    # Correctness at batch 2 at UNet's shapes, plus ReLU off and a ragged
    # whole DRIVE image.  Both sides accumulate in f32 and differ only in
    # summation order and (bf16) one output rounding.
    tol = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
    cases = [(2, hw, hw, cin, cout, True) for hw, cin, cout
             in sorted(set(UNET_CONVS))]
    cases += [(2, 64, 64, 64, 128, False), (1, IMG_H, IMG_W, 3, 64, True)]
    checks = []
    failures = []
    for b, h, wd, cin, cout, relu in cases:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, scale, shift = conv_inputs(b, h, wd, cin, cout, dtype)
            k = conv3x3_affine_relu(x, w, scale, shift, relu=relu).float()
            p = conv3x3_affine_relu_torch(x, w, scale, shift,
                                          relu=relu).float()
            torch.cuda.synchronize()
            err = float((k - p).abs().max())
            ref = float(p.abs().max())
            checks.append({"shape": [b, h, wd, cin, cout], "relu": relu,
                           "dtype": str(dtype).split(".")[-1],
                           "max_abs_err": err, "max_abs_plain": ref,
                           "ok": err <= tol[dtype] * ref})
            if not checks[-1]["ok"]:
                failures.append(checks[-1])
    n_ok = sum(c["ok"] for c in checks)
    print(f"[conv] kernel vs plain: {n_ok}/{len(checks)} shape/dtype cases "
          f"within 1e-4 (f32) / 1e-2 (bf16) of max|plain|", flush=True)

    # Times at the main path's shapes (batch = one chunk of patches), in
    # bf16 (the main path) and f32.  The library yardstick is cuDNN's
    # F.conv2d alone on the same channels_last input, TF32 off.
    b = min(INFER_BATCH, report["main_path"]["n_patches"])
    conv_times = {}
    for dtype, peak in ((torch.bfloat16, BF16_FLOPS), (torch.float32,
                                                        F32_FLOPS)):
        per_shape = {}
        for hw, cin, cout in sorted(set(UNET_CONVS)):
            x, w, scale, shift = conv_inputs(b, hw, hw, cin, cout, dtype)
            x_cl = x.permute(0, 3, 1, 2)  # NCHW view in channels_last
            w_oihw = w.permute(3, 2, 0, 1).contiguous()
            flops, nbytes = conv_cost(b, hw, cin, cout, x.element_size())
            ms = time_ms(lambda: conv3x3_affine_relu(x, w, scale, shift))
            per_shape[(hw, cin, cout)] = {
                "ms": ms, "tflops": flops / ms / 1e9,
                "plain_ms": time_ms(
                    lambda: conv3x3_affine_relu_torch(x, w, scale, shift)),
                "library_ms": time_ms(
                    lambda: F.conv2d(x_cl, w_oihw, padding=1)),
                "bound_ms": bound_ms(flops, nbytes, peak),
                "flops": flops, "bytes": nbytes,
            }
            del x, w, x_cl, w_oihw
        rows = [{"hw": hw, "cin": cin, "cout": cout,
                 **per_shape[(hw, cin, cout)]} for hw, cin, cout in UNET_CONVS]
        total = {key: sum(r[key] for r in rows)
                 for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                             "flops", "bytes")}
        total["bound_by"] = ("operations" if total["flops"] / peak
                             > total["bytes"] / HBM_BYTES_PER_S else "bytes")
        name = str(dtype).split(".")[-1]
        conv_times[name] = {"batch": b, "rows": rows, "total": total}
        print(f"[conv] one {name} forward at batch {b} (18 convs): kernel "
              f"{total['ms']:.2f} ms ({total['flops'] / total['ms'] / 1e9:.1f}"
              f" TFLOP/s), plain {total['plain_ms']:.2f} ms, cuDNN conv "
              f"{total['library_ms']:.2f} ms, bound {total['bound_ms']:.3f} ms "
              f"({total['bound_by']})", flush=True)
    total = conv_times["bfloat16"]["total"]

    # Dice: correctness on 20 x 584 x 565, times at the main path's shape.
    dice_rows = {}
    for n in (20, N_IMAGES):
        p = (torch.rand((n, IMG_H, IMG_W), generator=g, device=dev) * 1.2
             - 0.1)
        t = (torch.rand((n, IMG_H, IMG_W), generator=g, device=dev)
             > 0.9).float()
        got = dice_sums(p, t)
        want = dice_sums_torch(p, t)
        rel = max(float(((a - b_).abs() / b_.abs().clamp(min=1e-30)).max())
                  for a, b_ in zip(got, want))
        abs_err = max(float((a - b_).abs().max()) for a, b_ in zip(got, want))
        nbytes = 2 * p.numel() * 4 + 3 * n * 4
        flops = 5 * p.numel()
        dice_rows[n] = {
            "shape": [n, IMG_H, IMG_W], "max_rel_err": rel,
            "max_abs_err": abs_err,
            # device time (profiler): back-to-back calls are host-bound
            "ms": sum(r["device_ms"] for r in device_rows(
                lambda: dice_sums(p, t), reps=20)),
            "plain_ms": sum(r["device_ms"] for r in device_rows(
                lambda: dice_sums_torch(p, t), reps=20)),
            "call_ms": time_ms(lambda: dice_sums(p, t)),
            "bound_ms": bound_ms(flops, nbytes, F32_FLOPS),
            "bytes": nbytes, "flops": flops,
        }
        ok = rel <= 1e-5
        dice_rows[n]["ok"] = ok
        if not ok:
            failures.append({"dice": n, "max_rel_err": rel})
        print(f"[dice] {n}x{IMG_H}x{IMG_W}: rel err {rel:.2e} (tolerance "
              f"1e-5); kernel {dice_rows[n]['ms'] * 1e3:.1f} us, plain "
              f"{dice_rows[n]['plain_ms'] * 1e3:.1f} us, bound "
              f"{dice_rows[n]['bound_ms'] * 1e3:.1f} us", flush=True)

    report["conv_checks"] = checks
    report["conv_times"] = conv_times
    report["dice"] = {str(k): v for k, v in dice_rows.items()}
    if failures:
        raise AssertionError(f"kernel/plain mismatches: {failures}")

    main = dice_rows[N_IMAGES]
    launches = state["launches"]
    state["kernels"] = [
        {"name": "conv3x3_affine_relu", "route": "cuda",
         "source": "jcfszxc_unet_tpu_torch/csrc/conv3x3_affine_relu.cu",
         "replaces": "jcfszxc_unet_tpu/ops/pallas/conv_fused.py:81",
         "launches": launches["conv3x3_affine_relu"],
         "max_abs_err": max(c["max_abs_err"] for c in checks
                            if c["dtype"] == "bfloat16"),
         "ms": total["ms"], "plain_ms": total["plain_ms"],
         "bound_ms": total["bound_ms"], "bound_by": total["bound_by"],
         "library_ms": total["library_ms"]},
        {"name": "dice_sums", "route": "cuda",
         "source": "jcfszxc_unet_tpu_torch/csrc/dice_sums.cu",
         "replaces": "jcfszxc_unet_tpu/ops/pallas/dice_fused.py:37",
         "launches": launches["dice_sums"],
         "max_abs_err": main["max_abs_err"],
         "ms": main["ms"], "plain_ms": main["plain_ms"],
         "bound_ms": main["bound_ms"], "bound_by": "bytes",
         "library_ms": None},
    ]


def main() -> None:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    try:
        import jcfszxc_unet_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the port's package is not importable from {ROOT}: {e}")
    os.makedirs(OUT_DIR, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "tf32": False}
    state = {}
    t_start = time.perf_counter()
    failed = []
    for name, phase in (("build", phase_build),
                        ("main_path", phase_main_path),
                        ("f32_end_to_end", phase_f32_end_to_end),
                        ("kernels", phase_kernels)):
        try:
            if name == "build":
                phase(report)
            else:
                phase(report, state)
        except Exception:  # report every phase, then fail as a whole
            traceback.print_exc()
            failed.append(name)
            if name in ("build", "main_path"):
                break
    report["failed_phases"] = failed
    report["seconds"] = time.perf_counter() - t_start
    try:
        report["gpu"] = gpu_name_and_power()
    except (OSError, RuntimeError, subprocess.TimeoutExpired) as e:
        failed.append("nvidia-smi")
        print(f"nvidia-smi: {e}", file=sys.stderr)
    with open(os.path.join(OUT_DIR, "report.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    if failed:
        fail(f"phases failed: {failed}")
    print(json.dumps({"kernels": state["kernels"]}))
    print(report["gpu"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
