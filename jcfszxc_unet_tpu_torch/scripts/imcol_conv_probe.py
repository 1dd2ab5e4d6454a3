"""Probe: the 3x3 conv as ONE deep im2col product on the H100, against the
9-tap implicit-GEMM kernel and cuDNN, at the decoder's up4 first-conv
geometry (B x 128 x 128, 128 -> 64), bf16.  Counterpart of
``scripts/tpu_imcol_conv_probe.py``, with its environment knobs and
defaults, except ``PROBE_TH``: that is the TPU kernel's row block, and
the CUDA kernel has no counterpart (it tiles 128 pixels across rows).

    python -m jcfszxc_unet_tpu_torch.scripts.imcol_conv_probe

Checks ``conv3x3_relu_imcol`` against its plain version first, then prints
ms and TFLOP/s for three lines:

  * ``cudnn``: ``F.conv2d`` + ReLU on the channels_last input (the bar);
  * ``9tap``: ``conv3x3_affine_relu`` with scale 1 and shift 0;
  * ``imcol``: ``conv3x3_relu_imcol`` (its padded copy and the kernel
    alone are printed too).

Times are CUDA-event means over ``PROBE_N_LONG`` back-to-back calls after
a warm-up call.  Needs a CUDA GPU.
"""

from __future__ import annotations

import os

B = int(os.environ.get("PROBE_BATCH", "64"))
H = W = int(os.environ.get("PROBE_HW", "128"))
CIN = int(os.environ.get("PROBE_CIN", "128"))
COUT = int(os.environ.get("PROBE_COUT", "64"))
N_LONG = int(os.environ.get("PROBE_N_LONG", "51"))


def event_ms(fn, n: int = N_LONG) -> float:
    """Mean device time of ``fn`` over ``n`` back-to-back calls (CUDA
    events), after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def probe_inputs(b=B, h=H, w=W, cin=CIN, cout=COUT, dtype=None,
                 device="cuda", seed=0):
    """x (b, h, w, cin) uniform in [-0.5, 0.5) and w (3, 3, cin, cout)
    uniform in [-0.05, 0.05), as the TPU probe draws them, on ``device``."""
    import torch

    dtype = dtype or torch.bfloat16
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.rand((b, h, w, cin), generator=g, device=device) - 0.5)
    wt = (torch.rand((3, 3, cin, cout), generator=g, device=device)
          - 0.5) * 0.1
    return x.to(dtype), wt.to(dtype)


def run_probe(b=B, h=H, w=W, cin=CIN, cout=COUT, n_long=N_LONG,
              device="cuda", dtype=None, verbose=True):
    """Parity of the imcol kernel, then the timed lines.  Returns a dict:
    ``parity_max_abs``, ``max_abs_plain`` and, per line, ``ms`` and
    ``tflops`` (``pad`` and ``kernel`` split the imcol line)."""
    import torch
    import torch.nn.functional as F

    from jcfszxc_unet_tpu_torch.ops.kernels.conv_fused import (
        conv3x3_affine_relu,
    )
    from jcfszxc_unet_tpu_torch.ops.kernels.conv_imcol import (
        conv3x3_relu_imcol,
        conv3x3_relu_imcol_padded,
        conv3x3_relu_imcol_torch,
        pad_inputs,
    )

    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the probe times CUDA kernels: it needs a GPU")
    x, wt = probe_inputs(b, h, w, cin, cout, dtype, device)
    one = torch.ones((cout,), device=device)
    zero = torch.zeros((cout,), device=device)
    gflop = 2 * b * h * w * cout * 9 * cin / 1e9

    want = conv3x3_relu_imcol_torch(x, wt).float()
    got = conv3x3_relu_imcol(x, wt).float()
    err = float((got - want).abs().max())
    res = {"shape": [b, h, w, cin, cout], "dtype": str(x.dtype).split(".")[-1],
           "gflop": gflop, "parity_max_abs": err,
           "max_abs_plain": float(want.abs().max())}
    del want, got
    if verbose:
        print(f"imcol parity maxdiff {err:.3e} (max |plain| "
              f"{res['max_abs_plain']:.3e})", flush=True)

    x_cl = x.permute(0, 3, 1, 2)  # NCHW view in channels_last
    w_oihw = wt.permute(3, 2, 0, 1).contiguous()
    xp, w2 = pad_inputs(x, wt)
    lines = [
        ("cudnn", lambda: torch.relu(F.conv2d(x_cl, w_oihw, padding=1))),
        ("9tap", lambda: conv3x3_affine_relu(x, wt, one, zero)),
        ("imcol", lambda: conv3x3_relu_imcol(x, wt)),
        ("pad", lambda: pad_inputs(x, wt)),
        ("kernel", lambda: conv3x3_relu_imcol_padded(xp, w2)),
    ]
    for name, fn in lines:
        ms = event_ms(fn, n_long)
        res[name] = {"ms": ms, "tflops": gflop / ms}
        if verbose:
            rate = ("" if name == "pad" else
                    f"  {gflop / ms:6.1f} TFLOP/s")
            print(f"{name:6s}: {ms:7.3f} ms{rate}", flush=True)
    return res


def main():
    run_probe()
    print("DONE")


if __name__ == "__main__":
    main()
