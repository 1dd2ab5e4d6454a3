"""Tile sweep of the ``wgmma`` conv body on the card.

Times every (BM, BN, stages, strip, schedule) configuration that the
launchers instantiate (``conv_plan.WGMMA_CONFIGS``: the cooperative tiles
and the ping-pong ones, whose warpgroups own alternate tiles, with the
operands swapped or not; each stores through TMA where Cout % 8 == 0 and
it has a staging tile), without a cluster and, where the configuration
has a clustered instance (``conv_plan.CLUSTERED``), in pairs of CTAs
along the pixel tiles that multicast the weights' box, at the shapes the
main paths give the 3x3 conv kernels, bf16:

* ``eval``: UNet's 3x3 convs with Cin >= 64 at batch 16 (one 16-patch
  chunk of 512^2 patches);
* ``val``: the same convs at batch 64 at the train path's 128^2 patches
  (128^2 down to 8^2);
* ``patch``: the Cout = 64 convs (inc, up4) at batch 32 on training
  patches narrower than 128 (64^2, 96^2), where a row strip of 128 pixels
  is partly past the edge;
* ``probe``: the im2col kernel at B 64, 128^2, 128 -> 64;

and, for the eval shapes at 512^2 and 256^2, a few boxes beside the one
``choose_box`` picks (without a cluster).  It ends with the fastest
configuration and cluster of each shape beside the planned one.  Each
configuration is checked against the plain
version (within 1e-2 of max|plain|) before it is timed; cuDNN's conv on
the same input is timed beside it, and ``planned`` marks the plan that
``plan_conv`` picks.

With ``--f32`` it sweeps the ``f32_box`` body instead: every tile of
``conv_plan.F32_TILES`` at UNet's 3x3 convs in f32 at batch 16 (one
16-patch chunk of 512^2 patches, the stem too), with the box that
``f32_plan`` picks for the tile and, at 512^2 and 256^2, the other
one-image boxes whose channel plane fits (8-wide boxes run 8-pixel thread
rows, wider ones 16); checked within 1e-4 of max|plain|, beside cuDNN with
TF32 off; ``planned`` marks the plan ``f32_plan`` picks.

With ``--narrow`` it times, at every shape of ``conv_body_lists``'s
``narrow`` list (the zoo's narrow bf16 convs at 16 x 512^2 down to
64^2), or at the shapes given as ``--shape=B,H,W,CIN,COUT`` (repeated;
ReLU on), every route forced on it: the plan ``plan_conv`` picks, the
``mma_sync`` body's box plan (``conv_plan.box_plan``), each ``wgmma``
configuration without a cluster, and, where the package has the
``narrow`` body (``conv_plan.narrow_plan``), each tile of
``NARROW_SWEEP_TILES`` that fits; cuDNN beside them.  It uses no other
name of the package, so it forces the same routes on another checkout
put first on ``PYTHONPATH`` (the parent's, in turns with this one).

    python -m jcfszxc_unet_tpu_torch.scripts.conv_tile_sweep [out.json]
    python -m jcfszxc_unet_tpu_torch.scripts.conv_tile_sweep --f32 [out.json]
    python -m jcfszxc_unet_tpu_torch.scripts.conv_tile_sweep --narrow \\
        [--shape=16,512,512,32,32 ...] [out.json]

Needs a CUDA GPU.
"""

from __future__ import annotations

import json
import math
import sys

from jcfszxc_unet_tpu_torch.scripts.conv_body_lists import gpu_name_and_power

# (spatial size, Cin, Cout) of UNet's 3x3 convs with Cin >= 64.
SHAPES = [(512, 64, 64), (256, 64, 128), (256, 128, 128), (128, 128, 256),
          (128, 256, 256), (64, 256, 512), (64, 512, 512), (32, 512, 1024),
          (32, 1024, 1024), (64, 1024, 512), (128, 512, 256),
          (256, 256, 128), (512, 128, 64)]
# (spatial size, Cin, Cout) of the ``patch`` path.
NARROW = [(64, 64, 64), (64, 128, 64), (96, 64, 64), (96, 128, 64)]
BOXES = {128: [(128, 1, 1), (64, 2, 1), (32, 4, 1), (16, 8, 1)],
         256: [(256, 1, 1), (128, 2, 1), (64, 4, 1), (32, 8, 1)]}


def _event_ms(fn, target_ms=30.0):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    reps = max(3, min(200, math.ceil(target_ms / max(start.elapsed_time(end),
                                                     1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def sweep():
    import torch
    import torch.nn.functional as F

    from jcfszxc_unet_tpu_torch.ops.kernels import conv_fused, conv_imcol
    from jcfszxc_unet_tpu_torch.ops.kernels.conv_plan import (
        CLUSTERED,
        CLUSTERS,
        WGMMA_CONFIGS,
        plan_conv,
        schedule,
        sm_count,
        wgmma_plan,
    )

    if not torch.cuda.is_available():
        raise RuntimeError("the sweep times CUDA kernels: it needs a GPU")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    sms = sm_count(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def run(path, b, hw, cin, cout, kernel, plain, library, plans):
        want = plain().float()
        ref = float(want.abs().max())
        lib_ms = _event_ms(library)
        flops = 2 * b * hw * hw * cout * 9 * cin
        planned = plan_conv(b, hw, hw, cin + (-cin % 8), cout,
                            torch.bfloat16, True, sms,
                            imcol=path == "probe")
        for label, plan in plans:
            try:
                err = float((kernel(plan).float() - want).abs().max())
            except RuntimeError as e:  # a launch the card refuses
                rows.append({"path": path, "b": b, "hw": hw, "cin": cin,
                             "cout": cout, "label": label, "ok": False,
                             "error": str(e)})
                print(f"{path:5s} B{b:<3d} {hw:4d}^2 {cin:5d}->{cout:<5d} "
                      f"{label:22s} refused: {e}", flush=True)
                continue
            ms = _event_ms(lambda: kernel(plan))
            rows.append({"path": path, "b": b, "hw": hw, "cin": cin,
                         "cout": cout, "config": [plan.bm, plan.bn,
                                                  plan.stages, plan.strip,
                                                  plan.schedule],
                         "cluster": plan.cluster,
                         "tma_store": plan.tma_store,
                         "schedule": schedule(plan),
                         "box": list(plan.box), "label": label, "ms": ms,
                         "tflops": flops / ms / 1e9, "cudnn_ms": lib_ms,
                         "planned": plan == planned,
                         "ok": err <= 1e-2 * ref})
            print(f"{path:5s} B{b:<3d} {hw:4d}^2 {cin:5d}->{cout:<5d} "
                  f"{label:38s} {ms:8.3f} ms {flops / ms / 1e9:7.1f} TFLOP/s "
                  f"(cuDNN {lib_ms:.3f} ms)"
                  f"{' planned' if rows[-1]['planned'] else ''} "
                  f"{'ok' if rows[-1]['ok'] else 'BAD'}", flush=True)
        del want

    def configs(path, b, hw, cout, boxes=False):
        out = []
        for cfg in WGMMA_CONFIGS:
            if cfg[1] > max(64, cout) or (cfg[3] and hw < 128
                                          and path != "patch"):
                continue
            label = {0: "coop", 1: "ping", 2: "swap"}[cfg[4]]
            for cluster in CLUSTERS if cfg in CLUSTERED else (1,):
                plan = wgmma_plan(b, hw, hw, cout, cfg, sms,
                                  cluster=cluster)
                out.append((f"{label} {cfg[:4]} c{cluster} box {plan.box}",
                            plan))
            for box in (BOXES[cfg[0]] if boxes and not cfg[3] else ()):
                if box == out[-1][1].box:
                    continue
                plan = wgmma_plan(b, hw, hw, cout, cfg, sms, box)
                out.append((f"{label} {cfg[:4]} c1 box {plan.box}", plan))
        return out

    for path, b, shapes in (
            ("eval", 16, SHAPES),
            ("val", 64, [(hw // 4, cin, cout) for hw, cin, cout in SHAPES]),
            ("patch", 32, NARROW)):
        for hw, cin, cout in shapes:
            x = torch.randn((b, hw, hw, cin), generator=g, device=dev
                            ).bfloat16()
            w = (torch.randn((cout, 3, 3, cin), generator=g, device=dev)
                 / math.sqrt(9 * cin)).bfloat16()
            scale = 0.5 + torch.rand((cout,), generator=g, device=dev)
            shift = 0.1 * torch.randn((cout,), generator=g, device=dev)
            x_cl = x.permute(0, 3, 1, 2)
            w_oihw = w.permute(0, 3, 1, 2).contiguous()
            boxes = path == "eval" and hw >= 256
            run(path, b, hw, cin, cout,
                lambda plan: conv_fused.launch(x, w, scale, shift, True,
                                               plan),
                lambda: conv_fused.conv3x3_affine_relu_torch(
                    x, w.permute(1, 2, 3, 0), scale, shift),
                lambda: F.conv2d(x_cl, w_oihw, padding=1),
                configs(path, b, hw, cout, boxes))
            del x, w, x_cl, w_oihw

    from jcfszxc_unet_tpu_torch.scripts.imcol_conv_probe import probe_inputs

    x, w = probe_inputs()
    b, hw, _, cin = x.shape
    cout = w.shape[3]
    xp, wt = conv_imcol.pad_inputs(x, w)
    x_cl = x.permute(0, 3, 1, 2)
    w_oihw = w.permute(3, 2, 0, 1).contiguous()
    run("probe", b, hw, cin, cout,
        lambda plan: conv_imcol.launch(xp, wt, plan),
        lambda: conv_imcol.conv3x3_relu_imcol_torch(x, w),
        lambda: F.conv2d(x_cl, w_oihw, padding=1),
        configs("probe", b, hw, cout))
    return {"device": torch.cuda.get_device_name(0), "sm_count": sms,
            "gpu": gpu_name_and_power(), "rows": rows}


def best_rows(rows):
    """Per shape, the fastest row that agrees with the plain version and
    the planned row: {(path, b, hw, cin, cout): (best, planned)}."""
    out = {}
    for r in rows:
        if not r["ok"] or "ms" not in r:
            continue
        key = (r["path"], r["b"], r["hw"], r["cin"], r["cout"])
        best, planned = out.get(key, (None, None))
        if best is None or r["ms"] < best["ms"]:
            best = r
        if r.get("planned"):
            planned = r
        out[key] = (best, planned)
    return out


def f32_boxes(b, hw, tile):
    """The box ``f32_plan`` picks for ``tile`` and, at 256^2 and above,
    every other one-image box whose channel plane fits."""
    from jcfszxc_unet_tpu_torch.ops.kernels import conv_plan

    best = conv_plan.f32_plan(b, hw, hw, 64, tile=tile).box
    if hw < 256:
        return [best]
    return [best] + [box for box in conv_plan.f32_boxes(tile[0])
                     if box != best and box[2] == 1]


def sweep_f32():
    import torch
    import torch.nn.functional as F

    from jcfszxc_unet_tpu_torch.ops.kernels import conv_fused
    from jcfszxc_unet_tpu_torch.ops.kernels.conv_plan import (
        F32_TILES,
        f32_plan,
        f32_tm,
    )

    if not torch.cuda.is_available():
        raise RuntimeError("the sweep times CUDA kernels: it needs a GPU")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    b = 16
    for hw, cin, cout in [(512, 3, 64)] + SHAPES:
        x = torch.randn((b, hw, hw, cin), generator=g, device=dev)
        w = (torch.randn((cout, 3, 3, cin), generator=g, device=dev)
             / math.sqrt(9 * cin))
        scale = 0.5 + torch.rand((cout,), generator=g, device=dev)
        shift = 0.1 * torch.randn((cout,), generator=g, device=dev)
        want = conv_fused.conv3x3_affine_relu_torch(
            x, w.permute(1, 2, 3, 0), scale, shift)
        ref = float(want.abs().max())
        x_cl = x.permute(0, 3, 1, 2)
        w_oihw = w.permute(0, 3, 1, 2).contiguous()
        lib_ms = _event_ms(lambda: F.conv2d(x_cl, w_oihw, padding=1))
        flops = 2 * b * hw * hw * cout * 9 * cin
        planned = f32_plan(b, hw, hw, cout)
        for tile in F32_TILES:
            for box in f32_boxes(b, hw, tile):
                plan = f32_plan(b, hw, hw, cout, tile=tile, box=box)
                got = conv_fused.launch(x, w, scale, shift, True, plan)
                err = float((got - want).abs().max())
                del got
                ms = _event_ms(lambda: conv_fused.launch(
                    x, w, scale, shift, True, plan))
                rows.append({"path": "f32", "b": b, "hw": hw, "cin": cin,
                             "cout": cout, "tile": list(tile),
                             "tm": f32_tm(tile, box[0]), "box": list(box),
                             "ms": ms, "tflops": flops / ms / 1e9,
                             "cudnn_ms": lib_ms, "planned": plan == planned,
                             "ok": err <= 1e-4 * ref})
                print(f"f32   B{b:<3d} {hw:4d}^2 {cin:5d}->{cout:<5d} "
                      f"{str(tile):11s} TM {rows[-1]['tm']:2d} box "
                      f"{str(box):13s} {ms:8.3f} ms "
                      f"{flops / ms / 1e9:6.1f} TFLOP/s (cuDNN "
                      f"{lib_ms:.3f} ms)"
                      f"{' planned' if rows[-1]['planned'] else ''}"
                      f" {'ok' if rows[-1]['ok'] else 'BAD'}", flush=True)
        del x, w, want, x_cl, w_oihw
    return {"device": torch.cuda.get_device_name(0),
            "gpu": gpu_name_and_power(), "rows": rows}


# The narrow body's tiles the sweep forces: those of 256 pixels (Cout <= 32)
# and of 128 (Cout 64, 128) with TW and TH multiples of 8;
# conv_plan.narrow_plan refuses the ones of the other size or that do not
# fit.
NARROW_SWEEP_TILES = ((32, 8), (16, 16), (8, 32), (16, 8), (8, 16))


def sweep_narrow(shapes=None):
    """Every route forced on each shape of the narrow list (or of
    ``shapes``, (B, H, W, Cin, Cout, relu) each), bf16."""
    import torch
    import torch.nn.functional as F

    from jcfszxc_unet_tpu_torch.ops.kernels import conv_fused, conv_plan
    from jcfszxc_unet_tpu_torch.scripts.conv_body_lists import NARROW

    if not torch.cuda.is_available():
        raise RuntimeError("the sweep times CUDA kernels: it needs a GPU")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    sms = conv_plan.sm_count(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    narrow = getattr(conv_plan, "narrow_plan", None)
    rows = []
    for b, h, w_, cin, cout, relu in sorted(set(shapes or NARROW)):
        x = torch.randn((b, h, w_, cin), generator=g, device=dev).bfloat16()
        w = (torch.randn((cout, 3, 3, cin), generator=g, device=dev)
             / math.sqrt(9 * cin)).bfloat16()
        scale = 0.5 + torch.rand((cout,), generator=g, device=dev)
        shift = 0.1 * torch.randn((cout,), generator=g, device=dev)
        want = conv_fused.conv3x3_affine_relu_torch(
            x, w.permute(1, 2, 3, 0), scale, shift, relu).float()
        ref = float(want.abs().max())
        x_cl = x.permute(0, 3, 1, 2)
        w_oihw = w.permute(0, 3, 1, 2).contiguous()
        lib_ms = _event_ms(lambda: F.conv2d(x_cl, w_oihw, padding=1))
        planned = conv_plan.plan_conv(b, h, w_, cin, cout, torch.bfloat16,
                                      True, sms)
        plans = [("planned", planned),
                 ("box", conv_plan.box_plan(b, h, w_, cin, cout, sms))]
        for cfg in conv_plan.WGMMA_CONFIGS:
            if (cfg[1] > max(64, cout) or (cfg[3] and w_ < 128)
                    or (cfg[4] == 2 and cout % 8)):  # swap: TMA stores
                continue
            label = {0: "coop", 1: "ping", 2: "swap"}[cfg[4]]
            plans.append((f"wgmma {label} {cfg[:4]}",
                          conv_plan.wgmma_plan(b, h, w_, cout, cfg, sms)))
        for box in NARROW_SWEEP_TILES if narrow else ():
            try:
                plan = narrow(b, h, w_, cin, cout, sms, box)
            except ValueError:  # another tile size, or no instance
                continue
            plans.append((f"narrow {plan.box[:2]} ck{plan.chunk} "
                          f"st{plan.stages}", plan))
        flops = 2 * b * h * w_ * cout * 9 * cin
        for label, plan in plans:
            got = conv_fused.launch(x, w, scale, shift, relu, plan)
            err = float((got.float() - want).abs().max())
            del got
            ms = _event_ms(lambda: conv_fused.launch(x, w, scale, shift,
                                                     relu, plan))
            rows.append({"path": "narrow", "b": b, "hw": [h, w_],
                         "cin": cin, "cout": cout, "relu": relu,
                         "label": label, "body": plan.body,
                         "box": list(plan.box), "bn": plan.bn,
                         "chunk": plan.chunk, "stages": plan.stages,
                         "ms": ms, "tflops": flops / ms / 1e9,
                         "cudnn_ms": lib_ms,
                         "planned": plan == planned and label != "planned",
                         "ok": err <= 1e-2 * ref})
            print(f"narrow B{b:<3d} {h:4d}x{w_:<4d} {cin:4d}->{cout:<4d} "
                  f"{label:38s} {ms:8.4f} ms (cuDNN {lib_ms:.4f} ms)"
                  f"{' planned' if rows[-1]['planned'] else ''} "
                  f"{'ok' if rows[-1]['ok'] else 'BAD'}", flush=True)
        del x, w, want, x_cl, w_oihw
    return {"device": torch.cuda.get_device_name(0), "sm_count": sms,
            "gpu": gpu_name_and_power(), "rows": rows}


def main():
    flags = {"--f32", "--narrow"}
    shapes = [(*map(int, a.split("=", 1)[1].split(",")), True)
              for a in sys.argv[1:] if a.startswith("--shape=")]
    args = [a for a in sys.argv[1:]
            if a not in flags and not a.startswith("--shape=")]
    f32 = "--f32" in sys.argv[1:]
    narrow = "--narrow" in sys.argv[1:]
    res = (sweep_f32() if f32 else sweep_narrow(shapes) if narrow
           else sweep())
    if args:
        with open(args[0], "w") as f:
            json.dump(res, f, indent=1)
    if narrow:
        best = {}
        for r in res["rows"]:
            key = (r["b"], *r["hw"], r["cin"], r["cout"])
            if r["ok"] and r["label"] != "planned" and (
                    key not in best or r["ms"] < best[key]["ms"]):
                best[key] = r
        for key, r in best.items():
            print(f"best {key}: {r['label']} {r['ms']:.4f} ms (cuDNN "
                  f"{r['cudnn_ms']:.4f} ms)", flush=True)
    elif not f32:
        for key, (best, planned) in best_rows(res["rows"]).items():
            print(f"best {key}: {best['label']} {best['ms']:.3f} ms; planned "
                  + (f"{planned['label']} {planned['ms']:.3f} ms" if planned
                     else "-"), flush=True)
    print(res["gpu"])
    bad = [r for r in res["rows"] if not r["ok"]]
    print(f"{len(res['rows'])} timings, {len(bad)} outside "
          f"{'1e-4' if f32 else '1e-2'} of max|plain|")
    if bad:
        sys.exit(1)


if __name__ == "__main__":
    main()
