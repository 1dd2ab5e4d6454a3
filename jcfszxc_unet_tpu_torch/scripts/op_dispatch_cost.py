"""Host cost of calling the conv kernel through its operator, on the card.

The eval and validation paths are host-bound (idle shares 0.36-0.62), so
each microsecond a call spends on the host before its launch counts.
This script times, per call, the host side of UNet's 18 fused convs (the
eval path's (Cin, Cout) at 512^2 down to 32^2, batch 1, bf16) through:

* ``direct``: the wrapper's checks, then ``conv_fused.launch`` with
  ``plan_for``'s plan, as the wrapper called it before the operators;
* ``library``: ``conv_fused.conv3x3_affine_relu_kmajor``, the wrapper
  that calls the ``torch.library.Library`` operator (``library.py``);

under ``torch.inference_mode`` (the Predictor's evaluation, the trainers'
validations and an exported program) and ``torch.no_grad`` (what a caller
pays outside inference mode, where the operator's autograd kernel runs).
Each pass times the 18 calls on the host clock, then synchronizes
outside the timed region; the variants run in turns (direct, library,
library, direct) and each reports its median pass over 18, and the median
of each of its two blocks (their distance shows the drift of the host).

    python -m jcfszxc_unet_tpu_torch.scripts.op_dispatch_cost [out.json]

Needs a CUDA GPU.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

# (spatial size, Cin, Cout) of UNet's 18 3x3 convs in forward order.
UNET_CONVS = [
    (512, 3, 64), (512, 64, 64), (256, 64, 128), (256, 128, 128),
    (128, 128, 256), (128, 256, 256), (64, 256, 512), (64, 512, 512),
    (32, 512, 1024), (32, 1024, 1024), (64, 1024, 512), (64, 512, 512),
    (128, 512, 256), (128, 256, 256), (256, 256, 128), (256, 128, 128),
    (512, 128, 64), (512, 64, 64),
]


def _variants():
    from jcfszxc_unet_tpu_torch.ops.kernels import conv_fused, library

    def checks(x, w_km, scale, shift):
        conv_fused._check_dims(x, w_km, w_km.shape[1:3], "(Cout,3,3,Cin)")
        conv_fused._validate(x, w_km, scale, shift)
        if not w_km.is_contiguous():
            raise ValueError("w must be contiguous (Cout, 3, 3, Cin)")

    def direct(x, w_km, scale, shift, relu):
        checks(x, w_km, scale, shift)
        return library._conv_cuda(x, w_km, scale, shift, relu)

    return {"direct": direct,
            "library": conv_fused.conv3x3_affine_relu_kmajor}


def measure(passes: int = 100, batch: int = 1) -> dict:
    """{mode: {variant: host us per call}} over UNet's 18 convs, and the
    count of each variant's launches (18 per pass)."""
    import torch

    from jcfszxc_unet_tpu_torch.ops.kernels import conv_fused

    if not torch.cuda.is_available():
        raise RuntimeError("op_dispatch_cost needs a CUDA GPU")
    g = torch.Generator(device="cuda").manual_seed(0)
    calls = []
    for hw, cin, cout in UNET_CONVS:
        x = torch.randn((batch, hw, hw, cin), generator=g,
                        device="cuda").bfloat16()
        w_km = (0.05 * torch.randn((cout, 3, 3, cin), generator=g,
                                   device="cuda")).bfloat16()
        calls.append((x, w_km, torch.ones(cout, device="cuda"),
                      torch.zeros(cout, device="cuda"), True))
    variants = _variants()
    order = list(variants) + list(reversed(list(variants)))
    out = {}
    for mode, ctx in (("inference_mode", torch.inference_mode),
                      ("no_grad", torch.no_grad)):
        samples = {name: [] for name in variants}
        blocks = {name: [] for name in variants}
        launches = {}
        with ctx():
            for name in variants:  # warm-up: plans, builds, caches
                for args in calls:
                    variants[name](*args)
            torch.cuda.synchronize()
            for name in order:
                fn = variants[name]
                before = conv_fused.counter.launches
                block = []
                for _ in range(passes // 2):
                    t0 = time.perf_counter()
                    for args in calls:
                        fn(*args)
                    block.append(time.perf_counter() - t0)
                    torch.cuda.synchronize()
                samples[name] += block
                blocks[name].append(statistics.median(block) / len(calls)
                                    * 1e6)
                launches[name] = (launches.get(name, 0)
                                  + conv_fused.counter.launches - before)
        out[mode] = {name: statistics.median(s) / len(calls) * 1e6
                     for name, s in samples.items()}
        out[mode]["blocks"] = blocks
        out[mode]["launches"] = launches
    out["n_calls"] = len(calls)
    out["passes"] = passes
    return out


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    res = measure()
    text = json.dumps(res, indent=1)
    if argv:
        with open(argv[0], "w") as f:
            f.write(text)
    print(text)


if __name__ == "__main__":
    main()
