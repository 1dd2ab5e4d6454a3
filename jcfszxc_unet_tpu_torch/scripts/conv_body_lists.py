"""Kernel 1's bodies on their conv lists, on the card.

bf16 (the default): the ``mma_sync`` body takes every bf16 3x3 conv whose
Cin is not a multiple of 8: the Cin-3 stem of every model (UNet's at the
eval chunk of 16 x 512^2 and at a whole 608 x 576 image, the fractal
extractor's stacked 3 -> 32 on two whole DRIVE images), MultiResUNet's 25
odd-width convs at 16 x 512^2 and the same model's 25 in space-to-depth
mode.  ``--dtype float32``: the ``f32_box`` body takes every f32 conv;
its lists are UNet's 18 at 16 x 512^2, the same stems, MultiResUNet's 25
and the row-sharded forward's 18 slab convs (2 images padded to 640 x 576,
320 rows a rank and a halo row on each side).  ``--body wgmma``: the bf16
``wgmma`` body's lists, UNet's 17 convs with Cin % 8 == 0 at 16 x 512^2,
the zoo's wgmma shapes with Cout <= 128 (``chip_smoke.py``'s
``ZOO_CONV_CASES``) and UNet's 17 on the train path's validation batch
(64 x 128^2 down to 8^2), each row with the schedule that ran
(``pingpong`` or ``cooperative``, where the package counts it), and the
zoo's narrow convs (Cin <= 32 or Cout <= 32, the ``narrow`` body's
list: eight models' 55 calls at 16 x 512^2 down to 64^2, with each
model's totals); ``--lists`` picks some of them by name.  For each list this times
kernel 1 (through the K-major entry that ``ops/blocks`` calls), checks
every shape against the plain version (1e-2 of max |plain| in bf16, 1e-4
in f32) and prints a digest of its output (the first 16 hex digits of
the SHA-256 of its bytes: two checkouts' digests of one shape agree
exactly when their outputs do bit for bit, the inputs being made from
the same seed), times each call's device and host time apart too (the
zoo's small calls time the host otherwise), and with ``--library`` also
times cuDNN's ``F.conv2d`` alone
(channels_last, TF32 off) and, in bf16, the route of padding Cin to a
multiple of 8 with a copy of x (``F.pad``) and running the ``wgmma`` body
on the padded operands; bounds are bytes over 3.35 TB/s or operations
over 989 TFLOP/s (bf16 tensor cores) or 67 TFLOP/s (f32 CUDA cores).

It uses only the entry every checkout of the package since kernel 1 was
ported has, so it also times another checkout put first on
``PYTHONPATH``; run it in turns from two checkouts to compare their
bodies in one call (``git archive`` the other into a git-ignored
directory first):

    python -m jcfszxc_unet_tpu_torch.scripts.conv_body_lists --library \\
        --out new.json
    PYTHONPATH=<other checkout> python <this file> --out other.json
    python -m jcfszxc_unet_tpu_torch.scripts.conv_body_lists \\
        --dtype float32 --library --out new_f32.json
    python -m jcfszxc_unet_tpu_torch.scripts.conv_body_lists \\
        --body wgmma --library --out new_wgmma.json
    python -m jcfszxc_unet_tpu_torch.scripts.conv_body_lists \\
        --body wgmma --lists zoo,val --out new_zoo_val.json
    python -m jcfszxc_unet_tpu_torch.scripts.conv_body_lists \\
        --body wgmma --lists narrow --library --out new_narrow.json

Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import subprocess
import time

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 1e-2, "float32": 1e-4}  # against the plain version,
                                            # of max |plain|

# (B, H, W, Cin, Cout, relu) -> launches per forward.
STEMS = {
    (16, 512, 512, 3, 64, True): 1,   # UNet's stem, eval chunk
    (1, 608, 576, 3, 64, True): 1,    # whole image (608 x 576 padded)
    (2, 584, 565, 3, 32, True): 1,    # fractal extractor, 2 whole images
}
# MultiResUNet's convs with Cin % 8 != 0 at an eval chunk of 16 x 512^2,
# as ops/blocks records them on one patch (chip_smoke.py's zoo_eval and
# s2d phases hold the model's recorded lists to these).
MULTIRES = {
    (16, 512, 512, 3, 8, True): 1, (16, 512, 512, 17, 26, True): 2,
    (16, 512, 512, 51, 32, True): 1, (16, 256, 256, 17, 35, True): 2,
    (16, 256, 256, 35, 53, True): 2, (16, 256, 256, 51, 17, True): 1,
    (16, 256, 256, 105, 64, True): 1, (16, 128, 128, 35, 71, True): 2,
    (16, 128, 128, 71, 106, True): 2, (16, 128, 128, 105, 35, True): 1,
    (16, 128, 128, 212, 128, True): 1, (16, 64, 64, 71, 142, True): 2,
    (16, 64, 64, 142, 213, True): 2, (16, 64, 64, 212, 71, True): 1,
    (16, 64, 64, 426, 256, True): 1, (16, 32, 32, 142, 284, True): 1,
    (16, 32, 32, 284, 427, True): 1, (16, 32, 32, 426, 142, True): 1,
}
MULTIRES_S2D = {
    (16, 256, 256, 12, 32, True): 1, (16, 256, 256, 68, 104, True): 2,
    (16, 256, 256, 204, 128, True): 1, (16, 128, 128, 35, 71, True): 2,
    (16, 128, 128, 68, 140, True): 2, (16, 128, 128, 71, 106, True): 2,
    (16, 128, 128, 105, 35, True): 1, (16, 128, 128, 140, 212, True): 2,
    (16, 128, 128, 204, 68, True): 1, (16, 128, 128, 212, 128, True): 1,
    (16, 128, 128, 420, 256, True): 1, (16, 64, 64, 71, 142, True): 2,
    (16, 64, 64, 142, 213, True): 2, (16, 64, 64, 212, 71, True): 1,
    (16, 64, 64, 426, 256, True): 1, (16, 32, 32, 142, 284, True): 1,
    (16, 32, 32, 284, 427, True): 1, (16, 32, 32, 426, 142, True): 1,
}
LISTS = {"stems": STEMS, "multires": MULTIRES, "multires_s2d": MULTIRES_S2D}

# UNet's 18 convs as (level, Cin, Cout), level k at 1 / 2^k of the input.
UNET = [(0, 3, 64), (0, 64, 64), (1, 64, 128), (1, 128, 128),
        (2, 128, 256), (2, 256, 256), (3, 256, 512), (3, 512, 512),
        (4, 512, 1024), (4, 1024, 1024), (3, 1024, 512), (3, 512, 512),
        (2, 512, 256), (2, 256, 256), (1, 256, 128), (1, 128, 128),
        (0, 128, 64), (0, 64, 64)]


def _counted(keys):
    out = {}
    for key in keys:
        out[key] = out.get(key, 0) + 1
    return out


# f32: UNet's eval chunk (16 x 512^2) and the row-sharded forward's slabs
# (chip_smoke.py's spatial_sharded shapes: 2 images of 640 x 576, 2 ranks).
UNET_F32 = _counted((16, 512 >> k, 512 >> k, cin, cout, True)
                    for k, cin, cout in UNET)
SLAB_F32 = _counted((2, (640 >> k) // 2 + 2, 576 >> k, cin, cout, True)
                    for k, cin, cout in UNET)
F32_LISTS = {"unet": UNET_F32, "stems": STEMS, "multires": MULTIRES,
             "slab": SLAB_F32}

# The wgmma body (bf16, Cin % 8 == 0): UNet's 17 at the eval chunk, and
# the zoo's shapes with Cout <= 128 at batch 2 (chip_smoke.py's
# ZOO_CONV_CASES with Cin % 8 == 0 and Cout <= 128: Cout 1, 2, 8, 16, 17,
# 32, 64 and 128, ReLU off after a bias or before a gate).
UNET_WGMMA = _counted((16, 512 >> k, 512 >> k, cin, cout, True)
                      for k, cin, cout in UNET if cin % 8 == 0)
ZOO_WGMMA = {
    (2, 64, 64, 32, 32, True): 1, (2, 64, 64, 96, 32, True): 1,
    (2, 64, 64, 160, 32, True): 1, (2, 32, 32, 192, 64, True): 1,
    (2, 32, 32, 320, 64, True): 1, (2, 16, 16, 384, 128, True): 1,
    (2, 64, 64, 64, 1, False): 1, (2, 64, 64, 64, 64, False): 1,
    (2, 64, 64, 8, 17, True): 1, (2, 32, 32, 128, 17, True): 1,
    (2, 64, 64, 64, 8, True): 1, (2, 64, 64, 64, 2, True): 1,
    (4, 64, 64, 64, 128, False): 1, (2, 64, 64, 24, 16, True): 1,
    (2, 64, 64, 48, 32, True): 1, (2, 64, 64, 8, 8, True): 1,
    (2, 64, 64, 8, 16, True): 1, (2, 64, 64, 16, 32, True): 1,
    (2, 64, 64, 32, 64, True): 1, (2, 32, 32, 128, 128, False): 1,
}
# UNet's 17 at the validation batch of the train path (64 x 128^2).
VAL_WGMMA = _counted((64, 128 >> k, 128 >> k, cin, cout, True)
                     for k, cin, cout in UNET if cin % 8 == 0)
# The zoo's narrow bf16 convs (Cin % 8 == 0, and Cin <= 32 or Cout <=
# 32) per model, as ops/blocks records them on one 512^2 patch (level k at
# 512 / 2^k), scaled to the eval chunk of 16 patches: model -> {(level,
# Cin, Cout, relu): launches per forward}.  UNet has none.
NARROW_MODELS = {
    "FRUNet.FRUNet": {(0, 32, 32, False): 14, (0, 64, 32, False): 5},
    "UNetPP.NestedUNet": {(0, 32, 32, True): 5, (0, 96, 32, True): 1,
                          (0, 128, 32, True): 1, (0, 160, 32, True): 1,
                          (0, 192, 32, True): 1, (1, 32, 64, True): 1},
    "MultiResUNet.MultiResUNet": {(0, 8, 17, True): 2, (0, 32, 32, True): 3,
                                  (0, 64, 8, True): 1,
                                  (1, 128, 17, True): 1},
    "BCDUNet.BCDU_net_D3": {(0, 32, 64, True): 1, (0, 32, 128, False): 1,
                            (0, 64, 2, True): 1},
    "BCDUNet.BCDU_net_D1": {(0, 32, 64, True): 1, (0, 32, 128, False): 1,
                            (0, 64, 2, True): 1},
    "MCUNet.MCUNet": {(0, 32, 32, True): 2, (0, 64, 32, True): 1,
                      (1, 32, 64, True): 1, (1, 64, 32, True): 1,
                      (3, 32, 64, True): 2},
    "SegNet.SegNet": {(0, 64, 1, False): 1},
    "RetinaLiteNet.TransFuseNet": {(0, 8, 8, True): 1, (1, 8, 16, True): 1,
                                   (1, 24, 16, True): 1,
                                   (2, 16, 32, True): 1,
                                   (2, 48, 32, True): 1},
}


def narrow_model_calls(model, batch=16):
    """One model's narrow convs at an eval chunk of ``batch`` 512^2
    patches, ``{(B, H, W, Cin, Cout, relu): count}``."""
    return {(batch, 512 >> k, 512 >> k, cin, cout, relu): n
            for (k, cin, cout, relu), n in NARROW_MODELS[model].items()}


NARROW = {}
for _model in NARROW_MODELS:
    for _key, _n in narrow_model_calls(_model).items():
        NARROW[_key] = NARROW.get(_key, 0) + _n
WGMMA_LISTS = {"unet": UNET_WGMMA, "zoo": ZOO_WGMMA, "val": VAL_WGMMA,
               "narrow": NARROW}


def conv_cost(b, h, w, cin, cout, itemsize=2):
    """(flops, bytes) of one fused conv: x, w, scale, shift read once, out
    written once."""
    m = b * h * w
    flops = 2 * m * cout * 9 * cin + 3 * m * cout
    nbytes = (m * cin + 9 * cin * cout + m * cout) * itemsize + 2 * cout * 4
    return flops, nbytes


def bound_ms(flops, nbytes, dtype="bfloat16"):
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]) * 1e3


def time_ms(fn, target_ms=20.0, max_reps=50):
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


def device_host_ms(fn, reps=50):
    """(device ms, host ms) of one call of ``fn``, over ``reps`` calls:
    the host's is the wall time of queueing them; the device's is read by
    CUDA events around the same calls queued behind a spin of the card
    (``torch.cuda._sleep``) that outlasts their queueing, so that it
    counts the card's time alone, not the host's.  The spin doubles until
    it outlasts the queueing."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    cycles = int(4e6 * (host_ms * reps + 1.0))  # ~2 GHz, twice the queueing
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(8):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        hidden = not start.query()  # the spin still ran: all calls queued
        end.synchronize()
        if hidden:
            return start.elapsed_time(end) / reps, host_ms
        cycles *= 2
    raise RuntimeError("the card's spin never outlasted the queueing")


def pad8_inputs(x, w_km):
    """x and the K-major weights with Cin zero-padded to a multiple of 8
    (fresh, 16-byte-aligned tensors: the wgmma body's operands)."""
    import torch.nn.functional as F

    pad = -x.shape[3] % 8
    return (F.pad(x, (0, pad)).contiguous(),
            F.pad(w_km, (0, pad)).contiguous())


def pad8_route(x, w_km, scale, shift, relu, target_ms=20.0):
    """The route of padding Cin to a multiple of 8 with a copy of x and
    running kernel 1 on the padded operands (the wgmma body): ms of the
    copy, ms of kernel 1 on the copies, the body that ran, and its output
    (f32) for a check."""
    from jcfszxc_unet_tpu_torch.ops.kernels import conv_fused
    from jcfszxc_unet_tpu_torch.ops.kernels.conv_fused import (
        conv3x3_affine_relu_kmajor,
    )

    xp, wp = pad8_inputs(x, w_km)
    out = {"pad_ms": time_ms(lambda: pad8_inputs(x, w_km)[0], target_ms),
           "pad8_wgmma_ms": time_ms(lambda: conv3x3_affine_relu_kmajor(
               xp, wp, scale, shift, relu), target_ms),
           "pad8_body": conv_fused.plan_for(xp, wp).body}
    return out, conv3x3_affine_relu_kmajor(xp, wp, scale, shift,
                                           relu).float()


def digest(t) -> str:
    """The first 16 hex digits of the SHA-256 of a tensor's bytes."""
    import torch

    raw = t.contiguous().view(-1).view(torch.uint8)
    return hashlib.sha256(raw.cpu().numpy().tobytes()).hexdigest()[:16]


def run_list(calls, library, seed=7, target_ms=20.0, dtype="bfloat16",
             pad8=True):
    """Rows per shape and weighted totals of one list, with kernel 1's
    device and host ms a call apart (:func:`device_host_ms`); ``pad8``:
    with ``library``, also the pad-to-8 route of the bf16 shapes."""
    import torch
    import torch.nn.functional as F

    from jcfszxc_unet_tpu_torch.ops.kernels import conv_fused
    from jcfszxc_unet_tpu_torch.ops.kernels.conv_fused import (
        conv3x3_affine_relu_kmajor,
        conv3x3_affine_relu_torch,
    )

    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    tdtype = getattr(torch, dtype)
    for (b, h, wd, cin, cout, relu), n in calls.items():
        x = torch.randn((b, h, wd, cin), generator=g,
                        device="cuda").to(tdtype)
        w = (torch.randn((3, 3, cin, cout), generator=g, device="cuda")
             / math.sqrt(9 * cin)).to(tdtype)
        scale = 0.5 + torch.rand((cout,), generator=g, device="cuda")
        shift = 0.1 * torch.randn((cout,), generator=g, device="cuda")
        w_km = w.permute(3, 0, 1, 2).contiguous()
        before = dict(conv_fused.counter.bodies)
        # schedules are counted since the wgmma body has two
        sched_before = dict(getattr(conv_fused.counter, "schedules", {}))
        out = conv3x3_affine_relu_kmajor(x, w_km, scale, shift, relu)
        out_digest = digest(out)
        got = out.float()
        del out
        body = [k for k, v in conv_fused.counter.bodies.items()
                if v != before.get(k, 0)]
        sched = [k for k, v in getattr(conv_fused.counter, "schedules",
                                       {}).items()
                 if v != sched_before.get(k, 0)]
        want = conv3x3_affine_relu_torch(x, w, scale, shift, relu).float()
        err = float((got - want).abs().max())
        ref = float(want.abs().max())
        del got, want
        flops, nbytes = conv_cost(b, h, wd, cin, cout, x.element_size())
        row = {"shape": [b, h, wd, cin, cout], "relu": relu, "count": n,
               "body": body[0] if body else None,
               "schedule": sched[0] if sched else None,
               "digest": out_digest, "max_abs_err": err, "max_abs_plain": ref,
               "ok": err <= TOL[dtype] * ref, "flops": flops,
               "bytes": nbytes, "bound_ms": bound_ms(flops, nbytes, dtype),
               "ms": time_ms(lambda: conv3x3_affine_relu_kmajor(
                   x, w_km, scale, shift, relu), target_ms)}
        row["tflops"] = flops / row["ms"] / 1e9
        row["device_ms"], row["host_ms"] = device_host_ms(
            lambda: conv3x3_affine_relu_kmajor(x, w_km, scale, shift, relu))
        if library:
            x_cl = x.permute(0, 3, 1, 2)
            w_oihw = w.permute(3, 2, 0, 1).contiguous()
            row["library_ms"] = time_ms(
                lambda: F.conv2d(x_cl, w_oihw, padding=1), target_ms)
            if dtype == "float32" or not pad8:
                pass
            elif cin % 8:
                pad, got = pad8_route(x, w_km, scale, shift, relu, target_ms)
                want = conv3x3_affine_relu_torch(x, w, scale, shift,
                                                 relu).float()
                row.update(pad, pad8_max_abs_err=float(
                    (got - want).abs().max()))
                row["pad8_ok"] = row["pad8_max_abs_err"] <= TOL[dtype] * ref
                del got, want
            else:
                row["pad_ms"] = 0.0
                row["pad8_wgmma_ms"] = row["ms"]
        rows.append(row)
        del x, w, w_km
    keys = ["ms", "bound_ms", "flops", "bytes", "device_ms", "host_ms"]
    if library:
        keys += ["library_ms"]
        if dtype == "bfloat16" and pad8:
            keys += ["pad_ms", "pad8_wgmma_ms"]
    total = {k: sum(r["count"] * r[k] for r in rows) for k in keys}
    total["n_convs"] = sum(calls.values())
    total["tflops"] = total["flops"] / total["ms"] / 1e9
    total["checks_ok"] = sum(r["ok"] for r in rows)
    total["checks"] = len(rows)
    total["bound_by"] = ("operations" if total["flops"] / PEAK_FLOPS[dtype]
                         > total["bytes"] / HBM_BYTES_PER_S else "bytes")
    total["bodies"] = sorted({r["body"] for r in rows})
    total["schedules"] = {}
    for r in rows:
        if r["schedule"]:
            total["schedules"][r["schedule"]] = (
                total["schedules"].get(r["schedule"], 0) + r["count"])
    total["max_err_rel"] = max(r["max_abs_err"] / r["max_abs_plain"]
                               for r in rows)
    return {"rows": rows, "total": total}


def by_model(rows, keys):
    """The narrow list's weighted totals of ``keys`` per model of
    :data:`NARROW_MODELS` from its rows (one per shape)."""
    by_shape = {(*r["shape"], r["relu"]): r for r in rows}
    out = {}
    for model in NARROW_MODELS:
        calls = narrow_model_calls(model)
        out[model] = {k: sum(n * by_shape[key][k]
                             for key, n in calls.items()) for k in keys}
        out[model]["n_convs"] = sum(calls.values())
    return out


def gpu_name_and_power():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as err:
        return f"nvidia-smi failed: {err}"


def main():
    import torch

    import jcfszxc_unet_tpu_torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--library", action="store_true",
                    help="also time cuDNN and (bf16) the pad-to-8 + wgmma "
                         "route")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16",
                    help="bfloat16: the mma_sync lists (or, with --body "
                         "wgmma, the wgmma lists); float32: the f32_box "
                         "lists")
    ap.add_argument("--body", choices=("mma_sync", "wgmma"),
                    default="mma_sync",
                    help="bf16: the mma_sync lists or the wgmma lists")
    ap.add_argument("--lists", default=None,
                    help="comma-separated names of the lists to run "
                         "(default: all of the dtype's and body's)")
    ap.add_argument("--out", default=None, help="write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("conv_body_lists needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    wgmma = args.dtype == "bfloat16" and args.body == "wgmma"
    lists = (F32_LISTS if args.dtype == "float32" else
             WGMMA_LISTS if wgmma else LISTS)
    if args.lists:
        names = args.lists.split(",")
        unknown = sorted(set(names) - set(lists))
        if unknown:
            ap.error(f"no list {unknown}; the lists: {sorted(lists)}")
        lists = {name: lists[name] for name in names}
    res = {"package": jcfszxc_unet_tpu_torch.__file__,
           "gpu": gpu_name_and_power(), "dtype": args.dtype,
           "body": None if args.dtype == "float32" else args.body,
           "lists": {name: run_list(calls, args.library, dtype=args.dtype,
                                    pad8=not wgmma)
                     for name, calls in lists.items()}}
    if "narrow" in res["lists"]:
        res["lists"]["narrow"]["models"] = by_model(
            res["lists"]["narrow"]["rows"],
            ["ms", "device_ms", "bound_ms"]
            + (["library_ms"] if args.library else []))
    for name, lst in res["lists"].items():
        for r in lst["rows"]:
            print(f"digest {name} {r['shape']} {r['schedule'] or r['body']} "
                  f"{r['digest']}", flush=True)
        t = lst["total"]
        extra = ""
        if args.library:
            extra = f", cuDNN {t['library_ms']:.3f} ms"
        if args.library and args.dtype == "bfloat16" and not wgmma:
            extra += (f", pad {t['pad_ms']:.3f} + wgmma "
                      f"{t['pad8_wgmma_ms']:.3f} ms")
        extra += (f"; device {t['device_ms']:.3f} ms, host "
                  f"{t['host_ms']:.3f} ms")
        if t["schedules"]:
            extra += f"; schedules {t['schedules']}"
        print(f"{name}: {t['n_convs']} convs ({'/'.join(t['bodies'])}), "
              f"kernel {t['ms']:.3f} ms ({t['tflops']:.1f} TFLOP/s), bound "
              f"{t['bound_ms']:.3f} ms ({t['bound_by']}){extra}; "
              f"{t['checks_ok']}/{t['checks']} within {TOL[args.dtype]} "
              f"(max {t['max_err_rel']:.2e})", flush=True)
    for model, t in res["lists"].get("narrow", {}).get("models",
                                                        {}).items():
        extra = (f", cuDNN {t['library_ms']:.3f} ms" if args.library
                 else "")
        print(f"narrow {model}: {t['n_convs']} convs, kernel "
              f"{t['ms']:.3f} ms (device {t['device_ms']:.3f} ms){extra}, "
              f"bound {t['bound_ms']:.3f} ms", flush=True)
    print(res["gpu"], flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    if any(r["total"]["checks_ok"] != r["total"]["checks"]
           or not all(row.get("pad8_ok", True) for row in r["rows"])
           for r in res["lists"].values()):
        raise SystemExit("a shape disagrees with the plain version")


if __name__ == "__main__":
    main()
